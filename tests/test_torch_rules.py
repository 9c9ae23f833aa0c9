"""The port's acquisition rules and the state protocol of its closed loop on the CPU: the
batching routes of ``EfficientGlobalOptimization``, random and Thompson sampling, the
asynchronous rules and their pending-point state against the JAX package (float64, the
same numpy inputs in both), and ``BayesianOptimizer.optimize`` with a stateful rule, with
saving and continuation.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trieste_tpu.acquisition import rule as jrule
from trieste_tpu.acquisition.function import function as jfun
from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models.gp import posterior as jpost
from trieste_tpu.models.gp.gpr import GaussianProcessRegression as JGPR
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu.space import Box as JBox
from trieste_tpu_torch import BayesianOptimizer, Box, Dataset, OptimizationResult, convert, logging
from trieste_tpu_torch.acquisition import function as tfunctions
from trieste_tpu_torch.acquisition import optimizer as topt
from trieste_tpu_torch.acquisition import rule as trule
from trieste_tpu_torch.acquisition import sampler as tts
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.models.gp import sampler as tsam
from trieste_tpu_torch.models.gp.gpr import GaussianProcessRegression
from trieste_tpu_torch.objectives import mk_observer
from trieste_tpu_torch.observer import OBJECTIVE

torch.set_num_threads(1)

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-10)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _quadratic(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x**2, -1, keepdim=True)


def _space() -> Box:
    return Box([-1.0, -1.0], [1.0, 1.0], dtype=F64, device="cpu")


def _models(n=9, seed=0):
    """The same 2-D GPR over a quadratic in both packages, float64."""
    X = np.random.default_rng(seed).uniform(-1.0, 1.0, size=(n, 2))
    Y = np.sum(X**2, -1, keepdims=True)
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y))
    jmodel = JGPR(jpost.GPRParams(jstationary("matern52", 1.1, [0.6, 0.8], dtype=jnp.float64),
                                  jnp.asarray(1e-2), jnp.asarray(0.3)), jds)
    tds = Dataset.from_arrays(_t(X), _t(Y))
    tmodel = GaussianProcessRegression(
        convert.gpr_params_from_numpy("matern52", 1.1, [0.6, 0.8], 1e-2, 0.3, device="cpu", dtype=F64),
        tds, num_kernel_samples=2, max_optimize_iters=20, num_rff_features=64,
    )
    return (jmodel, jds), (tmodel, tds)


def _small_optimizer():
    return topt.generate_continuous_optimizer(num_initial_samples=128, num_optimization_runs=3)


# -- EfficientGlobalOptimization ------------------------------------------------------


@pytest.mark.parametrize("route, make_builder", [
    ("joint", lambda: tfunctions.BatchMonteCarloExpectedImprovement(16)),
    ("vectorized", lambda: tfunctions.ParallelContinuousThompsonSampling()),
    ("greedy", lambda: tfunctions.GreedyContinuousThompsonSampling()),
])
def test_ego_acquires_a_batch_by_each_route(route, make_builder):
    (_, _), (tm, tds) = _models()
    rule = trule.EfficientGlobalOptimization(make_builder(), _small_optimizer(), num_query_points=3)
    assert rule.num_query_points == 3 and rule.acquisition_function is None
    gen = torch.Generator().manual_seed(0)
    points = rule.acquire_single(_space(), tm, tds, generator=gen)
    assert points.shape == (3, 2) and points.dtype == F64 and bool(_space().contains(points).all())
    assert len(torch.unique(points, dim=0)) == 3
    first = rule.acquisition_function
    again = rule.acquire(_space(), {OBJECTIVE: tm}, {OBJECTIVE: tds}, generator=gen)
    assert again.shape == (3, 2) and rule.acquisition_function is not first  # updated


def test_ego_validates_its_arguments():
    with pytest.raises(ValueError, match="greater than 0"):
        trule.EfficientGlobalOptimization(num_query_points=0)
    with pytest.raises(ValueError, match="builder must be specified"):
        trule.EfficientGlobalOptimization(num_query_points=2)
    (_, _), (tm, tds) = _models()
    rule = trule.EfficientGlobalOptimization()
    with pytest.raises(ValueError, match="multiple datasets"):
        rule.acquire_single(_space(), {OBJECTIVE: tm}, tds)
    assert rule.filter_datasets({OBJECTIVE: tm}, {OBJECTIVE: tds}) == {OBJECTIVE: tds}

    class ElsewhereGenerator:  # stands in for a generator on a card that is not here
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="generator is on cuda"):
        rule.acquire_single(_space(), tm, tds, generator=ElsewhereGenerator())


def test_ego_joint_batch_matches_jax_given_its_draws_and_seeds(monkeypatch):
    """qEI over two points: the JAX rule's base draws and its seed pool, rebuilt from its
    keys, go into the port's rule; both choose the same batch."""
    (jm, jds), (tm, tds) = _models()
    S, N, R, B = 16, 96, 3, 2
    k_eps, k_acquire = jax.random.split(jax.random.PRNGKey(5))
    jspace = JBox([-1.0, -1.0], [1.0, 1.0])
    from trieste_tpu.acquisition.optimizer import generate_continuous_optimizer as jgen

    jr = jrule.EfficientGlobalOptimization(
        jfun.BatchMonteCarloExpectedImprovement(S, key=k_eps), jgen(N, R), num_query_points=B
    )
    want = jr.acquire_single(jspace, jm, jds, key=k_acquire)
    eps = _t(jax.random.normal(k_eps, (1, B, S), dtype=jnp.float64))
    seeds = _t((jspace**B).sample(k_acquire, N))
    monkeypatch.setattr(tsam, "standard_normal", lambda generator, shape, like: eps)
    monkeypatch.setattr(Box, "sample", lambda self, generator, n: seeds)
    tr = trule.EfficientGlobalOptimization(
        tfunctions.BatchMonteCarloExpectedImprovement(S),
        topt.generate_continuous_optimizer(N, R), num_query_points=B,
    )
    got = tr.acquire_single(_space(), tm, tds)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_ego_logs_its_query_points():
    (_, _), (tm, tds) = _models()

    class Writer:
        def __init__(self):
            self.histograms, self.scalars = [], []

        def add_histogram(self, name, values, step):
            self.histograms.append((name, np.asarray(values).shape, step))

        def add_scalar(self, name, value, step):
            self.scalars.append(name)

    writer = Writer()
    logging.set_tensorboard_writer(writer)
    try:
        logging.set_step_number(3)
        rule = trule.EfficientGlobalOptimization(optimizer=_small_optimizer())
        rule.acquire_single(_space(), tm, tds, generator=torch.Generator().manual_seed(0))
        tm.log()
        assert writer.histograms == []  # deferred until the flush
        logging.flush_deferred_summaries()
    finally:
        logging.set_tensorboard_writer(None)
    assert writer.histograms == [("EGO.query_points", (1, 2), 3)]
    assert {"kernel.variance", "kernel.lengthscale[1]", "likelihood.variance"} <= set(writer.scalars)
    logging.deferred_histogram("unused", lambda: 1 / 0)  # no writer: nothing queued or evaluated
    logging.flush_deferred_summaries()


# -- random and Thompson sampling -------------------------------------------------------


def test_random_sampling():
    rule = trule.RandomSampling(4)
    points = rule.acquire(_space(), {}, generator=torch.Generator().manual_seed(0))
    assert points.shape == (4, 2) and bool(_space().contains(points).all())
    assert repr(rule) == "RandomSampling(4)"
    with pytest.raises(ValueError, match="greater than 0"):
        trule.RandomSampling(0)


@pytest.mark.parametrize("sampler", [None, tts.ThompsonSamplerFromTrajectory()])
def test_discrete_thompson_sampling(sampler):
    (_, _), (tm, tds) = _models()
    rule = trule.DiscreteThompsonSampling(200, 5, sampler)
    gen = torch.Generator().manual_seed(0)
    points = rule.acquire_single(_space(), tm, tds, generator=gen)
    assert points.shape == (5, 2) and bool(_space().contains(points).all())
    # the samples concentrate where the posterior mean is low: nearer the quadratic's
    # minimum than uniform points are on average
    assert float(points.norm(dim=-1).mean()) < 0.75
    same = rule.acquire_single(_space(), tm, tds, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(points, same, rtol=0, atol=0)


def test_discrete_thompson_sampling_validates_its_arguments():
    (_, _), (tm, tds) = _models()
    with pytest.raises(ValueError, match="Search space"):
        trule.DiscreteThompsonSampling(0, 1)
    with pytest.raises(ValueError, match="greater than 0"):
        trule.DiscreteThompsonSampling(10, 0)
    with pytest.raises(ValueError, match="minimizer"):
        trule.DiscreteThompsonSampling(10, 1, tts.GumbelSampler())
    rule = trule.DiscreteThompsonSampling(10, 1)
    with pytest.raises(ValueError, match="single key"):
        rule.acquire(_space(), {"A": tm}, {"A": tds})
    with pytest.raises(ValueError, match="single key"):
        rule.acquire(_space(), {OBJECTIVE: tm}, None)
    assert repr(rule).startswith("DiscreteThompsonSampling(10, 1, ExactThompsonSampler(")


# -- the asynchronous rules ---------------------------------------------------------------


def test_asynchronous_rule_state_matches_jax():
    """The same sequence of additions and removals (with a repeated point and a point that
    is close but not equal) leaves the same pending points in both packages."""
    rng = np.random.default_rng(1)
    a, b = rng.uniform(size=(3, 2)), rng.uniform(size=(2, 2))
    steps = [("add", a), ("add", b), ("add", a[:1]), ("remove", np.stack([a[0], b[1] + 1e-12])),
             ("remove", rng.uniform(size=(2, 2))), ("remove", a[:1]), ("add", b[0])]
    js, ts = jrule.AsynchronousRuleState(None), trule.AsynchronousRuleState(None)
    assert not ts.has_pending_points and ts.remove_points(_t(a)) is ts
    for op, pts in steps:
        if op == "add":
            js, ts = js.add_pending_points(jnp.asarray(pts)), ts.add_pending_points(_t(pts))
        else:
            js, ts = js.remove_points(jnp.asarray(pts)), ts.remove_points(_t(pts))
        assert ts.has_pending_points == js.has_pending_points
        np.testing.assert_allclose(ts.pending_points.numpy(), js.pending_points, **TOL)
    carried = convert.asynchronous_rule_state_from_numpy(js.pending_points, device="cpu")
    torch.testing.assert_close(carried.pending_points, ts.pending_points)
    assert not convert.asynchronous_rule_state_from_numpy(None).has_pending_points


def test_asynchronous_optimization_matches_jax_with_pending_points(monkeypatch):
    """Both rules get the same draws and an optimizer that scores the same fixed joint
    candidates: they choose the same candidate, with and without pending points, and
    leave the same state."""
    (jm, jds), (tm, tds) = _models()
    S, B = 16, 2
    key = jax.random.PRNGKey(6)
    candidates = np.random.default_rng(6).uniform(-1, 1, size=(40, 1, B * 2))
    scored = []

    def j_optimizer(space, f, key=None):
        return jnp.asarray(candidates)[jnp.argmax(f(jnp.asarray(candidates))[:, 0])]

    def t_optimizer(space, f, generator=None):
        values = f(_t(candidates))[:, 0]
        scored.append(values.numpy())
        return _t(candidates)[torch.argmax(values)]

    jr = jrule.AsynchronousOptimization(
        jfun.BatchMonteCarloExpectedImprovement(S, key=key), j_optimizer, num_query_points=B
    )
    tr = trule.AsynchronousOptimization(
        tfunctions.BatchMonteCarloExpectedImprovement(S), t_optimizer, num_query_points=B
    )
    jspace = JBox([-1.0, -1.0], [1.0, 1.0])
    jstate, tstate = None, None
    for pending_size in (0, 1, 2):
        # the sampler freezes eps for a batch of the pending points and the new ones
        eps = _t(jax.random.normal(key, (1, pending_size + B, S), dtype=jnp.float64))
        monkeypatch.setattr(tsam, "standard_normal", lambda generator, shape, like, eps=eps: eps)
        jstate, want = jr.acquire_single(jspace, jm, jds)(jstate)
        tstate, got = tr.acquire_single(_space(), tm, tds)(tstate)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(tstate.pending_points.numpy(), jstate.pending_points, **TOL)
        # the next round: one of the pending points has been observed
        seen = np.asarray(jstate.pending_points)[:1]
        ys = np.sum(seen**2, -1, keepdims=True)
        jds = jds + JDataset.from_arrays(jnp.asarray(seen), jnp.asarray(ys))
        tds = tds + Dataset.from_arrays(_t(seen), _t(ys))
        jm.update(jds)
        tm.update(tds)
    assert len(scored) == 3 and all(np.isfinite(v).all() for v in scored)


def test_asynchronous_greedy():
    (_, _), (tm, tds) = _models()
    rule = trule.AsynchronousGreedy(
        tfunctions.GreedyContinuousThompsonSampling(), _small_optimizer(), num_query_points=2
    )
    gen = torch.Generator().manual_seed(0)
    state, points = rule.acquire_single(_space(), tm, tds, generator=gen)(None)
    assert points.shape == (2, 2) and state.pending_points.shape == (2, 2)
    told = tds + Dataset.from_arrays(points[:1], _quadratic(points[:1]))
    state, more = rule.acquire_single(_space(), tm, told, generator=gen)(state)
    assert more.shape == (2, 2) and state.pending_points.shape == (3, 2)
    torch.testing.assert_close(state.pending_points[0], points[1])
    with pytest.raises(NotImplementedError, match="greedy acquisition builder"):
        trule.AsynchronousGreedy(tfunctions.ExpectedImprovement())
    with pytest.raises(ValueError, match="cannot be None"):
        trule.AsynchronousGreedy(None)
    for cls in (trule.AsynchronousGreedy, trule.AsynchronousOptimization):
        with pytest.raises(ValueError, match="greater than 0"):
            cls(tfunctions.GreedyContinuousThompsonSampling(), num_query_points=0)


def test_local_datasets_rule_is_an_abstract_marker():
    with pytest.raises(TypeError, match="abstract"):
        trule.LocalDatasetsAcquisitionRule()
    assert issubclass(trule.LocalDatasetsAcquisitionRule, trule.AcquisitionRule)


# -- the closed loop with a stateful rule --------------------------------------------------


def _loop_setup():
    space = _space()
    observer = mk_observer(_quadratic)
    gen = torch.Generator().manual_seed(0)
    initial = observer(space.sample(gen, 5))
    model = build_gpr(initial, space, num_kernel_samples=2)
    rule = trule.AsynchronousOptimization(
        tfunctions.BatchMonteCarloExpectedImprovement(16), _small_optimizer(), num_query_points=2
    )
    return space, observer, gen, initial, model, rule


def test_bayesian_optimizer_threads_the_acquisition_state():
    space, observer, gen, initial, model, rule = _loop_setup()
    seen = []

    def callback(datasets, models, state):
        seen.append(None if state is None else state.pending_points.shape[0])
        return False

    bo = BayesianOptimizer(observer, space)
    result = bo.optimize(2, initial, model, rule, generator=gen, early_stop_callback=callback)
    assert result.is_ok, result.final_result
    record = result.final_result.unwrap()
    # every asked point is observed before the next step, so none stays pending beyond
    # the two of the last step
    assert seen == [None, 2] and record.acquisition_state.pending_points.shape == (2, 2)
    assert len(record.dataset) == 9 and [len(r.dataset) for r in result.history] == [5, 7]
    assert result.history[1].acquisition_state.pending_points.shape == (2, 2)
    assert result.try_get_final_datasets().keys() == {OBJECTIVE}
    assert result.try_get_final_models()[OBJECTIVE] is model and result.astuple()[1] is result.history

    resumed = bo.continue_optimization(3, result, acquisition_rule=rule, generator=gen)
    assert resumed.is_ok and len(resumed.try_get_final_dataset()) == 11
    assert [len(r.dataset) for r in resumed.history] == [5, 7, 9]


def test_results_and_records_save_and_load(tmp_path):
    space, observer, gen, initial, model, rule = _loop_setup()
    bo = BayesianOptimizer(observer, space)
    result = bo.optimize(2, initial, model, rule, generator=gen, track_path=tmp_path / "track")
    assert result.is_ok and sorted(p.name for p in (tmp_path / "track").iterdir()) == [
        "step.1.pickle", "step.2.pickle"]
    frozen = result.history[1]
    assert len(frozen.dataset) == 7 and frozen.acquisition_state.pending_points.shape == (2, 2)
    assert frozen.models.keys() == frozen.datasets.keys() == {OBJECTIVE}
    x = space.sample(gen, 3)
    torch.testing.assert_close(frozen.model.predict(x)[0], frozen.load().model.predict(x)[0])

    in_memory = bo.optimize(1, initial, model, rule, generator=gen, fit_initial_model=False)
    in_memory.save(tmp_path / "saved")
    loaded = OptimizationResult.from_path(tmp_path / "saved")
    assert loaded.is_ok and len(loaded.history) == 1
    torch.testing.assert_close(loaded.try_get_final_dataset().observations,
                               in_memory.try_get_final_dataset().observations)
    torch.testing.assert_close(loaded.try_get_final_model().predict(x)[1], model.predict(x)[1])
    assert OptimizationResult.from_path(tmp_path / "nothing").is_err

    # a failed run continues from the last entry of its history
    calls = []

    def flaky(qp):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("observer down")
        return observer(qp)

    failed = BayesianOptimizer(flaky, space).optimize(3, initial, model, rule, generator=gen)
    assert failed.is_err and len(failed.history) == 2
    recovered = BayesianOptimizer(flaky, space).continue_optimization(
        3, failed, acquisition_rule=rule, generator=gen
    )
    assert recovered.is_ok and len(recovered.try_get_final_dataset()) == 11
    with pytest.raises(ValueError, match="neither"):
        bo.continue_optimization(1, OptimizationResult(failed.final_result, []))


def test_fit_model_false_leaves_the_models_alone():
    space, observer, gen, initial, model, _ = _loop_setup()
    before = model.params
    rule = trule.RandomSampling(1)
    result = BayesianOptimizer(observer, space).optimize(
        2, initial, model, rule, generator=gen, fit_model=False
    )
    assert result.is_ok and model.params is before and len(model.dataset) == 5
    assert len(result.try_get_final_dataset()) == 7

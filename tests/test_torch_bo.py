"""The port's acquisition path and BO loop on the CPU: expected improvement and the
continuous optimizer's core against the JAX package on identical numpy seeds (float64),
and short ``BayesianOptimizer.optimize`` runs with small budgets."""
from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import Partial

from trieste_tpu import bayesian_optimizer as jbo
from trieste_tpu.acquisition import optimizer as jopt
from trieste_tpu.acquisition import rule as jrule
from trieste_tpu.acquisition.function import function as jfun
from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models.gp.gpr import GaussianProcessRegression as JGPR
from trieste_tpu.models.gp.posterior import GPRParams as JParams
from trieste_tpu.objectives import single_objectives as jobj
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu.space import Box as JBox
from trieste_tpu_torch import BayesianOptimizer, Dataset
from trieste_tpu_torch.acquisition import optimizer as topt
from trieste_tpu_torch.acquisition import rule as trule
from trieste_tpu_torch.acquisition.function import function as tfun
from trieste_tpu_torch.acquisition.rule import EfficientGlobalOptimization
from trieste_tpu_torch.convert import gpr_params_from_numpy
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.models.gp.gpr import GaussianProcessRegression
from trieste_tpu_torch.objectives import ScaledBranin, mk_observer
from trieste_tpu_torch.ops import fused_predict
from trieste_tpu_torch.space import Box as TBox

torch.set_num_threads(1)

F64 = torch.float64


def _models(n=9, seed=0):
    """The same ScaledBranin GPR in both packages, float64."""
    X = np.random.default_rng(seed).uniform(size=(n, 2))
    Y = np.asarray(jobj.ScaledBranin.objective(X))
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y))
    jmodel = JGPR(JParams(jstationary("matern52", 1.1, [0.3, 0.4], dtype=jnp.float64),
                          jnp.asarray(1e-3), jnp.asarray(-0.2)), jds)
    tds = Dataset.from_arrays(torch.as_tensor(X), torch.tensor(Y))
    tmodel = GaussianProcessRegression(
        gpr_params_from_numpy("matern52", 1.1, [0.3, 0.4], 1e-3, -0.2, device="cpu", dtype=F64), tds
    )
    return (jmodel, jds), (tmodel, tds)


def test_expected_improvement_matches_jax():
    (jm, jds), (tm, tds) = _models()
    jacq = jfun.ExpectedImprovement().prepare_acquisition_function(jm, jds)
    tacq = tfun.ExpectedImprovement().prepare_acquisition_function(tm, tds)
    x = np.random.default_rng(1).uniform(size=(40, 1, 2))
    np.testing.assert_allclose(tacq(torch.as_tensor(x)).numpy(), jacq(jnp.asarray(x)), rtol=1e-9, atol=1e-12)
    jg = jax.grad(lambda q: jnp.sum(jacq(q)))(jnp.asarray(x))
    q = torch.as_tensor(x).requires_grad_(True)
    (tg,) = torch.autograd.grad(tacq(q).sum(), q)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-8, atol=1e-12)
    with pytest.raises(ValueError, match="batch sizes of one"):
        tacq(torch.zeros(3, 2, 2, dtype=F64))


def test_min_posterior_mean_ignores_padding():
    (_, _), (tm, tds) = _models()
    eta = tfun._min_posterior_mean(tm, tds)
    mean, _ = tm.predict(tds.trimmed_query_points)
    assert tds.capacity > len(tds)
    np.testing.assert_allclose(eta.item(), mean.min().item(), rtol=1e-12)


def test_optimize_continuous_core_matches_jax():
    """Identical numpy seeds: the same seed scores, the same top-k starts, and the same
    winner after the lockstep L-BFGS runs."""
    (jm, jds), (tm, tds) = _models()
    jacq = jfun.ExpectedImprovement().prepare_acquisition_function(jm, jds)
    tacq = tfun.ExpectedImprovement().prepare_acquisition_function(tm, tds)
    seeds = np.random.default_rng(2).uniform(size=(512, 1, 2))
    lower, upper = np.zeros((1, 2)), np.ones((1, 2))
    R = 4

    jvals = np.asarray(jopt._scalar_wrap(jacq, jnp.asarray(seeds)))[:, 0]
    tvals = tacq(torch.as_tensor(seeds))[:, 0].numpy()
    np.testing.assert_allclose(tvals, jvals, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(np.argsort(-tvals)[:R], np.argsort(-jvals)[:R])

    jpts, jv, jimp = jopt._optimize_continuous_core(
        Partial(jopt._scalar_wrap, jacq), jnp.asarray(seeds), jnp.asarray(lower),
        jnp.asarray(upper), jnp.zeros(2, bool), R, 60,
    )
    acq = lambda x: tacq(x).reshape(x.shape[:-2] + (1,))  # noqa: E731
    pts, v, imp = topt._optimize_continuous_core(
        acq, torch.as_tensor(seeds), torch.as_tensor(lower), torch.as_tensor(upper), R, 60
    )
    np.testing.assert_allclose(pts.numpy(), jpts, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(v.numpy(), jv, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(imp.numpy(), jimp, rtol=1e-6, atol=1e-12)
    assert float(imp[0]) > 0.0  # the runs improved on the best seed


def test_continuous_optimizer_recovers_then_fails():
    space = ScaledBranin.search_space.to("cpu", F64)
    calls = []

    def flaky(x):  # non-finite everywhere on the first attempt, finite after
        calls.append(1)
        v = -torch.sum((x[..., 0, :] - 0.25) ** 2, -1, keepdim=True)
        return v if len(calls) > 3 else torch.full_like(v, torch.nan)

    opt = topt.generate_continuous_optimizer(num_initial_samples=64, num_optimization_runs=2)
    point = opt(space, flaky, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(point.numpy(), [[0.25, 0.25]], atol=1e-4)
    with pytest.raises(topt.FailedOptimizationError):
        topt.generate_continuous_optimizer(64, 2, num_recovery_runs=2)(
            space, lambda x: torch.full(x.shape[:-2] + (1,), torch.nan, dtype=F64),
            generator=torch.Generator().manual_seed(0),
        )


def _cpu_branin(dtype=F64):
    space = ScaledBranin.search_space.to("cpu", dtype)
    observer = mk_observer(ScaledBranin.objective)
    gen = torch.Generator().manual_seed(0)
    initial = observer(space.sample(gen, 5))
    return space, observer, gen, initial


def test_bayesian_optimizer_runs_three_steps(cpu_plain_fused):
    """The quickstart path end to end with small budgets, the fused path's plain version
    serving the seed pool."""
    space, observer, gen, initial = _cpu_branin(torch.float32)
    model = build_gpr(initial, space, num_kernel_samples=3)
    rule = EfficientGlobalOptimization(optimizer=topt.generate_continuous_optimizer(
        num_initial_samples=512, num_optimization_runs=4))
    result = BayesianOptimizer(observer, space).optimize(3, initial, model, rule, generator=gen)
    assert result.is_ok, result.final_result
    final = result.try_get_final_dataset()
    assert len(final) == 8 and len(result.history) == 3
    assert [len(r.dataset) for r in result.history] == [5, 6, 7]
    qp, obs = final.astuple()
    assert bool(space.contains(qp).all()) and bool(torch.isfinite(obs).all())
    point, value, idx = result.try_get_optimal_point()
    assert value.item() == obs.min().item() and torch.equal(point, qp[idx])
    assert result.try_get_final_model() is model
    assert cpu_plain_fused == [512, 512, 512]  # one fused seed-pool score per step


def test_default_rule_and_early_stop():
    space, observer, gen, initial = _cpu_branin()
    model = build_gpr(initial, space, num_kernel_samples=2)
    seen = []

    def stop_after_two(datasets, models, acquisition_state):
        assert acquisition_state is None  # the default rule keeps no state
        seen.append(len(datasets["OBJECTIVE"]))
        return len(seen) > 2

    result = BayesianOptimizer(observer, space).optimize(
        5, {"OBJECTIVE": initial}, {"OBJECTIVE": model}, generator=gen,
        early_stop_callback=stop_after_two, track_state=False,
    )
    assert result.is_ok and seen == [5, 6, 7] and result.history == []
    assert len(result.try_get_final_dataset()) == 7


def test_errors_end_the_run_as_err():
    space, observer, gen, initial = _cpu_branin()
    model = build_gpr(initial, space, num_kernel_samples=2)

    def broken(qp):
        raise RuntimeError("observer down")

    result = BayesianOptimizer(broken, space).optimize(2, initial, model, generator=gen)
    assert result.is_err and len(result.history) == 1
    with pytest.raises(RuntimeError, match="observer down"):
        result.try_get_final_dataset()
    with pytest.raises(ValueError, match="num_steps"):
        BayesianOptimizer(observer, space).optimize(-1, initial, model)
    with pytest.raises(ValueError, match="same global tags"):
        BayesianOptimizer(observer, space).optimize(1, {"A": initial}, {"B": model})


def test_rule_takes_one_query_point():
    """The default builder (EI) scores one point at a time: a batch needs a builder, and a
    batch acquired with EI all the same is refused by EI itself."""
    with pytest.raises(ValueError, match="builder must be specified"):
        EfficientGlobalOptimization(num_query_points=2)
    with pytest.raises(ValueError, match="greater than 0"):
        EfficientGlobalOptimization(num_query_points=0)
    (_, _), (tm, tds) = _models()
    rule = EfficientGlobalOptimization(tfun.ExpectedImprovement(), num_query_points=2)
    with pytest.raises(ValueError, match="batch sizes of one"):
        rule.acquire_single(ScaledBranin.search_space.to("cpu", F64), tm, tds,
                            generator=torch.Generator().manual_seed(0))


@pytest.fixture()
def cpu_plain_fused(monkeypatch):
    """Send CPU seed pools through the fused path's plain version; record pool sizes."""
    monkeypatch.setattr(fused_predict, "CPU_PLAIN", True)
    sizes = []
    orig = fused_predict.fused_predict_f

    def counting(params, cache, flat):
        sizes.append(flat.shape[0])
        return orig(params, cache, flat)

    monkeypatch.setattr(fused_predict, "MIN_POINTS", 256)
    monkeypatch.setattr(fused_predict, "fused_predict_f", counting)
    return sizes


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


SAVE_MESSAGE = (
    "Failed to save the optimization state; pass track_state=False to disable tracking"
)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


class _LockedModel:
    """A model that holds a lock, so that it cannot be deep-copied."""

    def __init__(self, predict_dtype):
        self._lock = threading.Lock()
        self._zeros = predict_dtype

    def predict(self, query_points):
        return self._zeros(query_points), self._zeros(query_points)

    def update(self, dataset):
        pass

    def optimize(self, dataset):
        pass


class _JFixed(jrule.AcquisitionRule):
    def acquire(self, search_space, models, datasets=None, key=None):
        return jnp.asarray([[0.5, 0.5]])


class _TFixed(trule.AcquisitionRule):
    def acquire(self, search_space, models, datasets=None, generator=None):
        return torch.tensor([[0.5, 0.5]], dtype=F64)


def test_a_state_that_cannot_be_saved_ends_the_loop_as_in_jax():
    X = np.array([[0.1, 0.2], [0.7, 0.4]])
    Y = np.sum(X, -1, keepdims=True)
    jdata = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y))
    jmodel = _LockedModel(lambda x: jnp.zeros(x.shape[:-1] + (1,)))
    jresult = jbo.BayesianOptimizer(lambda x: JDataset.from_arrays(x, jnp.sum(x, -1, keepdims=True)),
                                    JBox([0.0, 0.0], [1.0, 1.0])).optimize(
        1, jdata, jmodel, _JFixed(), track_state=True)
    tdata = Dataset.from_arrays(_t(X), _t(Y))
    tmodel = _LockedModel(lambda x: torch.zeros(x.shape[:-1] + (1,), dtype=F64))
    tresult = BayesianOptimizer(lambda x: Dataset.from_arrays(x, torch.sum(x, -1, keepdim=True)),
                                TBox([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu")).optimize(
        1, tdata, tmodel, _TFixed(), track_state=True)
    for result in (jresult, tresult):
        assert not result.final_result.is_ok
        error = result.final_result.error
        assert type(error) is NotImplementedError and str(error) == SAVE_MESSAGE
        assert isinstance(error.__cause__, TypeError)
    untracked = BayesianOptimizer(lambda x: Dataset.from_arrays(x, torch.sum(x, -1, keepdim=True)),
                                  TBox([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu")).optimize(
        1, tdata, tmodel, _TFixed(), track_state=False)
    assert untracked.final_result.is_ok


@pytest.mark.parametrize("max_iters", [1, 5])
def test_continuous_optimizer_takes_max_iters_as_in_jax(monkeypatch, max_iters):
    """The JAX optimizer's seed pool (its key, unsplit, samples the box) goes into the
    port; after ``max_iters`` iterations of each of the R runs the points and their values
    are JAX's."""
    X = np.random.default_rng(0).uniform(size=(9, 2))
    Y = np.sum((X - 0.45) ** 2, -1, keepdims=True)  # EI peaks inside the box, near (0.41, 0.51)
    jmodel = JGPR(JParams(jstationary("matern52", 0.1, [0.2, 0.25], dtype=jnp.float64),
                          jnp.asarray(1e-4), jnp.asarray(0.1)),
                  JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y)))
    tdata = Dataset.from_arrays(_t(X), _t(Y))
    tmodel = GaussianProcessRegression(
        gpr_params_from_numpy("matern52", 0.1, [0.2, 0.25], 1e-4, 0.1, device="cpu", dtype=F64),
        tdata)
    jacq = jfun.ExpectedImprovement().prepare_acquisition_function(
        jmodel, jmodel.get_internal_data())
    tacq = tfun.ExpectedImprovement().prepare_acquisition_function(tmodel, tdata)
    N, R, key = 256, 4, jax.random.PRNGKey(3)
    jspace = JBox([0.0, 0.0], [1.0, 1.0])
    want = np.asarray(jopt.generate_continuous_optimizer(
        N, R, optimizer_args={"max_iters": max_iters})(jspace, jacq, key=key))
    seeds = _t(jspace.sample(key, N))
    monkeypatch.setattr(TBox, "sample", lambda self, generator, n: seeds)
    space = TBox([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu")
    got = topt.generate_continuous_optimizer(N, R, optimizer_args={"max_iters": max_iters})(
        space, tacq)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tacq(got[:, None, :]).detach().numpy(),
                               np.asarray(jacq(jnp.asarray(want)[:, None, :])), rtol=1e-9)
    assert bool(((got > 0.05) & (got < 0.95)).all())  # an interior point: the steps show
    # one iteration stops short of the default sixty: the argument is read
    full = topt.generate_continuous_optimizer(N, R)(space, tacq)
    assert float(tacq(full[:, None, :])) >= float(tacq(got[:, None, :]))
    if max_iters == 1:
        assert float(torch.max(torch.abs(full - got))) > 1e-4

"""The port's Ask/Tell optimizer on the CPU: the behaviour cases of the JAX package's own
Ask/Tell tests (those that need no trust region) on the port, the tag helpers against the
JAX package, both packages' optimizers through the same tell sequence (datasets and
refitted hyperparameters compared, the fit's restarts injected from the JAX package), and
the slice as a whole: Ask/Tell with batch Monte-Carlo EI over three rounds, the port's
batches against the JAX package's with the base draws, the seed pools and the restarts
injected (atol 1e-6 on the points). Float64 throughout.
"""
from __future__ import annotations

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trieste_tpu import ask_tell_optimization as jat
from trieste_tpu.acquisition import rule as jrule
from trieste_tpu.acquisition.function import function as jfun
from trieste_tpu.acquisition.optimizer import generate_continuous_optimizer as jgenerate
from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models.gp import builders as jbuilders
from trieste_tpu.models.gp import training as jtrain
from trieste_tpu.space import Box as JBox
from trieste_tpu.utils import misc as jmisc
from trieste_tpu_torch import (
    AskTellOptimizer,
    AskTellOptimizerNoTraining,
    AskTellOptimizerState,
    Box,
    Dataset,
    Record,
)
from trieste_tpu_torch.acquisition import function as tfunctions
from trieste_tpu_torch.acquisition import optimizer as topt
from trieste_tpu_torch.acquisition import rule as trule
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.models.gp import gpr as tgpr
from trieste_tpu_torch.models.gp import sampler as tsam
from trieste_tpu_torch.models.gp import training as ttrain
from trieste_tpu_torch.observer import OBJECTIVE
from trieste_tpu_torch.utils import misc as tmisc
from trieste_tpu_torch.utils.misc import LocalizedTag

torch.set_num_threads(1)

F64 = torch.float64


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=F64)


def mk_dataset(query_points, observations) -> Dataset:
    qp = _t(query_points)
    return Dataset.from_arrays(qp, _t(observations), capacity=qp.shape[0])


class FixedAcquisitionRule(trule.AcquisitionRule):
    """A rule that returns fixed points."""

    def __init__(self, query_points):
        self._qp = _t(query_points)

    def acquire(self, search_space, models, datasets=None, generator=None):
        return self._qp


class FitCountingModel:
    """Counts the update and optimize calls."""

    def __init__(self):
        self.update_count = 0
        self.optimize_count = 0

    def predict(self, query_points):
        mean = torch.sum(query_points**2, -1, keepdim=True)
        return mean, torch.ones_like(mean)

    def update(self, dataset: Dataset) -> None:
        self.update_count += 1

    def optimize(self, dataset: Dataset) -> None:
        self.optimize_count += 1


class StatefulSpyRule(trule.AcquisitionRule):
    """A rule with state that records the state passed to its closure and one draw from
    the generator it is handed."""

    def __init__(self, query_points):
        self._qp = _t(query_points)
        self.seen_states = []
        self.seen_draws = []

    def acquire(self, search_space, models, datasets=None, generator=None):
        self.seen_draws.append(torch.rand(3, generator=generator))

        def stateful(state):
            self.seen_states.append(state)
            return (0 if state is None else state + 1), self._qp

        return stateful


@pytest.fixture
def setup():
    space = Box([-1.0, -1.0], [1.0, 1.0], dtype=F64, device="cpu")
    data = mk_dataset([[0.1, 0.2], [-0.3, 0.4]], [[0.05], [0.25]])
    return space, data, FitCountingModel()


def _origin():
    return FixedAcquisitionRule([[0.0, 0.0]])


# -- the behaviour cases of tests/unit/test_ask_tell.py ----------------------------------


def test_ask_returns_rule_points(setup):
    space, data, model = setup
    at = AskTellOptimizer(space, data, model, FixedAcquisitionRule([[0.25, 0.25]]))
    np.testing.assert_allclose(at.ask().numpy(), [[0.25, 0.25]])


def test_tell_appends_data(setup):
    space, data, model = setup
    at = AskTellOptimizer(space, data, model, FixedAcquisitionRule([[0.25, 0.25]]))
    pts = at.ask()
    at.tell(Dataset.from_arrays(pts, torch.sum(pts**2, -1, keepdim=True)))
    assert len(at.dataset) == 3
    np.testing.assert_allclose(at.dataset.trimmed_query_points[-1].numpy(), [0.25, 0.25])


def test_record_roundtrip(setup):
    space, data, model = setup
    rule = FixedAcquisitionRule([[0.25, 0.25]])
    at = AskTellOptimizer(space, data, model, rule)
    at.tell(mk_dataset([[0.1, 0.1]], [[0.02]]))
    restored = AskTellOptimizer.from_record(at.to_record(), space, rule)
    assert len(restored.dataset) == len(at.dataset) == 3
    torch.testing.assert_close(restored.dataset.trimmed_query_points, at.dataset.trimmed_query_points)
    torch.testing.assert_close(restored.dataset.trimmed_observations, at.dataset.trimmed_observations)
    np.testing.assert_allclose(restored.ask().numpy(), [[0.25, 0.25]])


def test_state_roundtrip(setup):
    space, data, model = setup
    at = AskTellOptimizer(space, data, model, _origin())
    state = at.to_state()
    assert isinstance(state, AskTellOptimizerState) and state.local_data_ixs is None
    restored = AskTellOptimizer.from_state(state, space, _origin())
    assert restored.dataset is at.dataset and restored.model is model  # to_state copies nothing
    isolated = AskTellOptimizer.from_state(at.to_state(copy=True), space, _origin())
    assert isolated.model is not model and len(isolated.dataset) == 2


def test_no_training_variant_does_not_train(setup):
    space, data, model = setup
    at = AskTellOptimizerNoTraining(space, data, model, _origin())
    at.tell(mk_dataset([[0.1, 0.1]], [[0.02]]))
    assert model.optimize_count == 0 and model.update_count == 0


def test_unknown_tell_tag_raises(setup):
    space, data, model = setup
    at = AskTellOptimizer(space, data, model, _origin())
    with pytest.raises(ValueError, match="Unknown tag"):
        at.tell({"UNKNOWN": mk_dataset([[0.0, 0.0]], [[0.0]])})


def test_dataset_and_model_accessors(setup):
    space, data, model = setup
    at = AskTellOptimizer(space, data, model, _origin())
    assert at.model is model and len(at.datasets) == 1 and OBJECTIVE in at.datasets


def test_track_data_false_replaces_datasets(setup):
    space, data, model = setup
    at = AskTellOptimizerNoTraining(space, data, model, _origin(), track_data=False)
    full = mk_dataset([[0.5, 0.5], [0.1, 0.1], [0.3, 0.3]], [[0.5], [0.02], [0.18]])
    at.tell(full)
    assert len(at.dataset) == 3
    torch.testing.assert_close(at.dataset.trimmed_query_points, full.trimmed_query_points)


# -- the behaviour cases of tests/unit/test_ask_tell_parity.py ---------------------------


def test_to_record_copy_true_is_isolated(setup):
    space, data, model = setup
    opt = AskTellOptimizer(space, data, model, _origin())
    record = opt.to_record(copy=True)
    before = record.dataset.query_points.clone()
    opt.tell(mk_dataset([[0.9, 0.9]], [[1.62]]))
    assert torch.equal(record.dataset.query_points, before)
    assert len(record.dataset) == 2 and len(opt.dataset) == 3


def test_to_record_copy_false_shares_objects(setup):
    space, data, model = setup
    opt = AskTellOptimizer(space, data, model, _origin())
    record = opt.to_record(copy=False)
    assert record.models[OBJECTIVE] is model
    assert record.datasets[OBJECTIVE] is opt.datasets[OBJECTIVE]


def test_to_record_copy_true_copies_model(setup):
    space, data, model = setup
    opt = AskTellOptimizer(space, data, model, _origin())
    assert opt.to_record(copy=True).models[OBJECTIVE] is not model


@pytest.mark.parametrize("via", ["record", "state"])
def test_restoring_does_not_train_model(setup, via):
    space, data, model = setup
    rule = _origin()
    opt = AskTellOptimizer(space, data, model, rule)
    assert model.optimize_count == 1
    if via == "record":
        restored = AskTellOptimizer.from_record(opt.to_record(copy=False), space, rule)
    else:
        restored = AskTellOptimizer.from_state(opt.to_state(), space, rule)
    assert model.optimize_count == 1 and restored.model is model


def test_constructor_trains_model_unless_fit_model_false(setup):
    space, data, model = setup
    AskTellOptimizer(space, data, model, _origin())
    assert model.optimize_count == 1 and model.update_count == 1
    model2 = FitCountingModel()
    AskTellOptimizer(space, data, model2, _origin(), fit_model=False)
    assert model2.optimize_count == 0


def test_empty_datasets_raise(setup):
    space, _, _ = setup
    with pytest.raises(ValueError, match="populated"):
        AskTellOptimizer(space, {}, {}, _origin())


def test_mismatched_keys_raise(setup):
    space, data, model = setup
    with pytest.raises(ValueError, match="same keys"):
        AskTellOptimizer(space, {"A": data}, {"B": model}, _origin())


def test_local_dataset_tags_accepted_against_global_model(setup):
    space, data, model = setup
    datasets = {OBJECTIVE: data, LocalizedTag(OBJECTIVE, 0): data, LocalizedTag(OBJECTIVE, 1): data}
    opt = AskTellOptimizer(space, datasets, {OBJECTIVE: model}, _origin())
    assert set(opt.datasets.keys()) == set(datasets.keys()) and opt.dataset is data


def test_default_acquisition_requires_objective_tag(setup):
    space, data, model = setup
    with pytest.raises(ValueError, match="Default acquisition"):
        AskTellOptimizer(space, {"not_objective": data}, {"not_objective": model})


def test_dataset_property_raises_for_multiple_tags(setup):
    space, data, model = setup
    opt = AskTellOptimizer(
        space, {OBJECTIVE: data, "CONSTRAINT": data},
        {OBJECTIVE: model, "CONSTRAINT": FitCountingModel()}, _origin(),
    )
    with pytest.raises(ValueError, match="single dataset"):
        opt.dataset
    with pytest.raises(ValueError, match="single model"):
        opt.model
    assert set(opt.datasets.keys()) == set(opt.models.keys()) == {OBJECTIVE, "CONSTRAINT"}


def test_constructor_acquisition_state_reaches_stateful_rule(setup):
    space, data, model = setup
    rule = StatefulSpyRule([[0.0, 0.0]])
    opt = AskTellOptimizer(space, data, model, rule, acquisition_state=41)
    opt.ask()
    assert rule.seen_states == [41] and opt.acquisition_state == 42


def test_stateful_rule_state_threads_through_asks(setup):
    space, data, model = setup
    rule = StatefulSpyRule([[0.0, 0.0]])
    opt = AskTellOptimizer(space, data, model, rule)
    opt.ask()
    opt.ask()
    assert rule.seen_states == [None, 0] and opt.acquisition_state == 1


def test_record_roundtrip_preserves_acquisition_state(setup):
    space, data, model = setup
    rule = StatefulSpyRule([[0.0, 0.0]])
    opt = AskTellOptimizer(space, data, model, rule, acquisition_state=7)
    record = opt.to_record()
    assert record.acquisition_state == 7
    assert AskTellOptimizer.from_record(record, space, rule).acquisition_state == 7


def test_ask_advances_the_generator(setup):
    space, data, model = setup
    rule = StatefulSpyRule([[0.0, 0.0]])
    opt = AskTellOptimizer(space, data, model, rule, generator=torch.Generator().manual_seed(0))
    opt.ask()
    opt.ask()
    assert not torch.equal(*rule.seen_draws)


def test_explicit_generator_makes_ask_deterministic(setup):
    space, data, _ = setup

    def first_draw(seed):
        rule = StatefulSpyRule([[0.0, 0.0]])
        generator = None if seed is None else torch.Generator().manual_seed(seed)
        AskTellOptimizer(space, data, FitCountingModel(), rule, generator=generator).ask()
        return rule.seen_draws[0]

    assert torch.equal(first_draw(123), first_draw(123))
    np.random.seed(5)  # without a generator the optimizer seeds its own from numpy
    a = first_draw(None)
    np.random.seed(5)
    assert torch.equal(a, first_draw(None))


def test_from_record_rule_override_is_used(setup):
    space, data, model = setup
    opt = AskTellOptimizer(space, data, model, _origin())
    restored = AskTellOptimizer.from_record(opt.to_record(), space, FixedAcquisitionRule([[0.5, 0.5]]))
    np.testing.assert_allclose(restored.ask().numpy(), [[0.5, 0.5]])


def test_no_training_variant_roundtrips_through_record(setup):
    space, data, model = setup
    opt = AskTellOptimizerNoTraining(space, data, model, _origin())
    restored = AskTellOptimizerNoTraining.from_record(opt.to_record(), space, _origin())
    restored.tell(mk_dataset([[0.9, 0.9]], [[1.62]]))
    assert model.optimize_count == 0 and len(restored.dataset) == 3


def test_tell_accepts_plain_dataset_for_single_objective(setup):
    space, data, model = setup
    opt = AskTellOptimizer(space, data, model, _origin())
    opt.tell(mk_dataset([[0.0, 0.0]], [[0.0]]))
    assert len(opt.dataset) == 3


def test_tell_retrains_all_models_once(setup):
    space, data, model = setup
    constraint_model = FitCountingModel()
    opt = AskTellOptimizer(
        space, {OBJECTIVE: data, "CONSTRAINT": data},
        {OBJECTIVE: model, "CONSTRAINT": constraint_model}, _origin(),
    )
    opt.tell({OBJECTIVE: mk_dataset([[0.0, 0.0]], [[0.0]]),
              "CONSTRAINT": mk_dataset([[0.0, 0.0]], [[0.0]])})
    assert model.optimize_count == 2 and constraint_model.optimize_count == 2


def test_models_setter_replaces_models(setup):
    space, data, model = setup
    opt = AskTellOptimizer(space, data, model, _origin())
    model2 = FitCountingModel()
    opt.models = {OBJECTIVE: model2}
    assert opt.models[OBJECTIVE] is model2 is not model and opt.model is model2


@pytest.mark.parametrize("keys", [(), (OBJECTIVE, "X"), ("CONSTRAINT",)])
def test_models_setter_errors(setup, keys):
    space, data, model = setup
    opt = AskTellOptimizer(space, data, model, _origin())
    with pytest.raises(ValueError, match="keys"):
        opt.models = {k: FitCountingModel() for k in keys}


def test_model_setter_replaces_single_objective_model(setup):
    space, data, model = setup
    opt = AskTellOptimizer(space, data, model, _origin())
    model2 = FitCountingModel()
    opt.model = model2
    assert opt.models[OBJECTIVE] is model2 is not model


def test_model_setter_errors(setup):
    space, data, model = setup
    odd_tag = AskTellOptimizer(space, {"X": data}, {"X": model}, _origin())
    with pytest.raises(ValueError, match="single model keyed"):
        odd_tag.model = model
    two = AskTellOptimizer(space, {OBJECTIVE: data, "X": data},
                           {OBJECTIVE: model, "X": FitCountingModel()}, _origin())
    with pytest.raises(ValueError, match="single model keyed"):
        two.model = model


def test_tell_unknown_localized_tag_raises_rather_than_dropping(setup):
    space, data, model = setup
    opt = AskTellOptimizer(space, data, model, _origin())
    with pytest.raises(ValueError, match="Unknown tag"):
        opt.tell({LocalizedTag(OBJECTIVE, 5): mk_dataset([[0.0, 0.0]], [[0.0]])})
    assert len(opt.dataset) == 2


def test_rules_with_local_datasets_are_refused_for_now(setup):
    space, data, model = setup

    class TwoRegionRule(FixedAcquisitionRule, trule.LocalDatasetsAcquisitionRule):
        num_local_datasets = 2

        def initialize_subspaces(self, search_space):
            pass

    # rules with local datasets are no longer refused: a restored state's local_data_ixs
    # give each region its rows of the global dataset
    state = AskTellOptimizerState(
        Record({OBJECTIVE: data}, {OBJECTIVE: model}), local_data_ixs=(_t([0]), _t([1]))
    )
    restored = AskTellOptimizer.from_state(state, space, TwoRegionRule([[0.0, 0.0]]))
    for i in range(2):
        local = restored.datasets[LocalizedTag(OBJECTIVE, i)]
        torch.testing.assert_close(local.trimmed_query_points, data.trimmed_query_points[i : i + 1])
    assert restored.dataset is data


def test_dataset_len(setup):
    space, data, model = setup
    one = mk_dataset([[0.1, 0.2]], [[0.05]])
    datasets = {OBJECTIVE: data, "CONSTRAINT": data, LocalizedTag(OBJECTIVE, 0): one}
    assert AskTellOptimizer.dataset_len(datasets) == 2  # local datasets are ignored
    with pytest.raises(ValueError, match="unique global dataset size"):
        AskTellOptimizer.dataset_len({OBJECTIVE: data, "CONSTRAINT": one})


# -- the tag helpers against the JAX package -----------------------------------------------


def test_tag_helpers_match_jax():
    mapping = {OBJECTIVE: 1, "C": 2, LocalizedTag("C", 0): 3, LocalizedTag("L", 1): 4,
               LocalizedTag("L", 0): 5}
    jmapping = {(jmisc.LocalizedTag(k.global_tag, k.local_index) if isinstance(k, LocalizedTag)
                 else k): v for k, v in mapping.items()}
    assert tmisc.ignoring_local_tags(mapping) == jmisc.ignoring_local_tags(jmapping) == {
        OBJECTIVE: 1, "C": 2, "L": 4}
    assert tmisc.map_values(lambda v: v * 2, {"a": 1, "b": 2}) == jmisc.map_values(
        lambda v: v * 2, {"a": 1, "b": 2})
    for tags in ((), ("C",), ("missing", "C"), ("missing",)):
        assert tmisc.get_value_for_tag(mapping, *tags) == jmisc.get_value_for_tag(jmapping, *tags)
    assert tmisc.get_value_for_tag(None) == jmisc.get_value_for_tag(None) == (None, None)


# -- both packages through the same sequence -------------------------------------------------


def _quadratic_pair(n=6, seed=0, num_kernel_samples=3):
    """The same data and the same ``build_gpr`` model in both packages, float64."""
    X = np.random.default_rng(seed).uniform(-1.0, 1.0, size=(n, 2))
    Y = np.sum(X**2, -1, keepdims=True)
    jspace = JBox([-1.0, -1.0], [1.0, 1.0])
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y))
    jmodel = jbuilders.build_gpr(jds, jspace, num_kernel_samples=num_kernel_samples,
                                 optimize_key=jax.random.PRNGKey(11))
    tspace = Box([-1.0, -1.0], [1.0, 1.0], dtype=F64, device="cpu")
    tds = Dataset.from_arrays(_t(X), _t(Y))
    tmodel = build_gpr(tds, tspace, num_kernel_samples=num_kernel_samples)
    return (jspace, jds, jmodel), (tspace, tds, tmodel)


@pytest.fixture
def jax_restarts(monkeypatch):
    """Make the port's model fit from the restarts that the JAX model is about to draw:
    ``next_fit(jmodel)`` before each JAX fit queues them (gpr.py: the model splits its key,
    training.py: ``randomize_starts`` of the sub-key)."""
    queue = []

    def next_fit(jmodel):
        sub = jax.random.split(jmodel._key)[1]
        queue.append(np.asarray(jtrain.randomize_starts(
            sub, jmodel.params, jmodel._num_kernel_samples, jmodel._train_noise,
            priors=jmodel._priors,
        )))

    def fit_from_queue(generator, params, X, Y, mask, *, num_starts, train_noise, max_iters, priors):
        return ttrain.fit_gpr_from_starts(_t(queue.pop(0)), params, X, Y, mask,
                                          train_noise=train_noise, max_iters=max_iters, priors=priors)

    monkeypatch.setattr(tgpr, "fit_gpr", fit_from_queue)
    return next_fit


def _assert_same_fit(tmodel, jmodel, rtol=1e-6):
    tp, jp = tmodel.params, jmodel.params
    np.testing.assert_allclose(tp.kernel.lengthscales.numpy(), jp.kernel.lengthscales, rtol=rtol)
    np.testing.assert_allclose(tp.kernel.variance.item(), float(jp.kernel.variance), rtol=rtol)
    np.testing.assert_allclose(tp.mean_constant.item(), float(jp.mean_constant), rtol=rtol, atol=1e-9)
    np.testing.assert_allclose(tp.noise_variance.item(), float(jp.noise_variance), rtol=rtol)


def test_both_packages_through_the_same_tell_sequence(jax_restarts):
    """A stub rule returns fixed points; after every tell the datasets are equal and the
    refitted hyperparameters agree to rtol 1e-6 (the tolerance of the fit's own test)."""
    (jspace, jds, jmodel), (tspace, tds, tmodel) = _quadratic_pair()
    asked = np.array([[0.3, -0.2], [0.6, 0.1]])

    class JFixed:
        def acquire(self, search_space, models, datasets=None, key=None):
            return jnp.asarray(asked)

        def filter_datasets(self, models, datasets):
            return datasets

    jax_restarts(jmodel)
    jopt = jat.AskTellOptimizer(jspace, jds, jmodel, JFixed())
    topt_ = AskTellOptimizer(tspace, tds, tmodel, FixedAcquisitionRule(asked))
    _assert_same_fit(tmodel, jmodel)
    rng = np.random.default_rng(1)
    for told in (2, 1, 4):  # the last one grows the capacity from 8 to 16
        np.testing.assert_allclose(topt_.ask().numpy(), jopt.ask())
        X = rng.uniform(-1.0, 1.0, size=(told, 2))
        Y = np.sum(X**2, -1, keepdims=True)
        jax_restarts(jmodel)
        jopt.tell(JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y)))
        topt_.tell(Dataset.from_arrays(_t(X), _t(Y)))
        assert len(topt_.dataset) == int(jopt.dataset.num_points)
        assert topt_.dataset.capacity == jopt.dataset.capacity
        np.testing.assert_array_equal(topt_.dataset.query_points.numpy(), jopt.dataset.query_points)
        np.testing.assert_array_equal(topt_.dataset.observations.numpy(), jopt.dataset.observations)
        _assert_same_fit(tmodel, jmodel)
    assert len(topt_.dataset) == 13 and topt_.dataset.capacity == 16


def test_ask_tell_with_batch_monte_carlo_ei_matches_jax_over_three_rounds(monkeypatch, jax_restarts):
    """The slice as a whole. Each round: ask (qEI over two points, maximized jointly),
    observe, tell (refit). The JAX optimizer's base draws, its seed pools (the optimizer
    splits its key at every ask and samples the product box with the sub-key) and its
    restarts go into the port."""
    (jspace, jds, jmodel), (tspace, tds, tmodel) = _quadratic_pair()
    S, N, R, B = 16, 96, 3, 2
    k_eps, k_loop = jax.random.split(jax.random.PRNGKey(7))
    jax_restarts(jmodel)
    jopt = jat.AskTellOptimizer(
        jspace, jds, jmodel,
        jrule.EfficientGlobalOptimization(jfun.BatchMonteCarloExpectedImprovement(S, key=k_eps),
                                          jgenerate(N, R), num_query_points=B),
        key=k_loop,
    )
    pools = []
    monkeypatch.setattr(Box, "sample", lambda self, generator, n: pools.pop(0))
    eps = _t(jax.random.normal(k_eps, (1, B, S), dtype=jnp.float64))
    monkeypatch.setattr(tsam, "standard_normal", lambda generator, shape, like: eps)
    topt_ = AskTellOptimizer(
        tspace, tds, tmodel,
        trule.EfficientGlobalOptimization(tfunctions.BatchMonteCarloExpectedImprovement(S),
                                          topt.generate_continuous_optimizer(N, R), num_query_points=B),
    )
    for _ in range(3):
        acquire_key = jax.random.split(jopt._key)[1]
        pools.append(_t((jspace**B).sample(acquire_key, N)))
        want = np.asarray(jopt.ask())
        got = topt_.ask()
        assert got.shape == (B, 2)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        Y = np.sum(want**2, -1, keepdims=True)
        jax_restarts(jmodel)
        jopt.tell(JDataset.from_arrays(jnp.asarray(want), jnp.asarray(Y)))
        topt_.tell(Dataset.from_arrays(_t(want), _t(Y)))
        _assert_same_fit(tmodel, jmodel)
    assert len(topt_.dataset) == 12 and not pools


def test_state_roundtrip_keeps_a_fitted_model_and_its_data():
    (_, _, _), (space, data, model) = _quadratic_pair()
    small = topt.generate_continuous_optimizer(num_initial_samples=128, num_optimization_runs=3)
    make_rule = lambda: trule.AsynchronousOptimization(  # noqa: E731
        tfunctions.BatchMonteCarloExpectedImprovement(16), small, num_query_points=2)
    gen = torch.Generator().manual_seed(0)
    opt = AskTellOptimizer(space, data, model, make_rule(), generator=gen)
    points = opt.ask()
    opt.tell(Dataset.from_arrays(points[:1], torch.sum(points[:1] ** 2, -1, keepdim=True)))
    buffer = io.BytesIO()
    torch.save(opt.to_state(copy=True), buffer)  # the state is storable as it is
    buffer.seek(0)
    state = torch.load(buffer, weights_only=False)
    restored = AskTellOptimizer.from_state(state, space, make_rule(), generator=gen)
    assert restored.model is not model
    torch.testing.assert_close(restored.model.params.kernel.lengthscales,
                               model.params.kernel.lengthscales, rtol=0, atol=0)
    assert len(restored.dataset) == 7
    torch.testing.assert_close(restored.dataset.query_points, opt.dataset.query_points)
    torch.testing.assert_close(restored.acquisition_state.pending_points, points)
    again = restored.ask()  # drops the observed point, keeps the other pending
    assert again.shape == (2, 2) and restored.acquisition_state.pending_points.shape == (3, 2)
    torch.testing.assert_close(restored.acquisition_state.pending_points[0], points[1])

"""The port's trust regions, local datasets and batch observer on the CPU, against the JAX
package where both compute the same thing.

Every region class runs through a scripted sequence of ``initialize``/``update`` calls in
both packages, with the JAX package's draws fed to the port (its box samples recorded as
they are made and replayed through the port's pure half, its discrete indices replayed
from the region's key chain); bounds, ``eps``/``L``, counters, phase, minimum and
location agree after every call at rtol 1e-9. Then ``_mask_to_region`` and
``filter_datasets`` (capacity kept), the local-dataset helpers, ``mk_batch_observer`` and
``stop_at_minimum``; the behaviour cases of the JAX package's trust-region and local Ask/Tell
tests; and the slice as a whole: three steps of TREGO through ``BayesianOptimizer.optimize``
and three Ask/Tell rounds of ``BatchTrustRegionBox(init_subspaces=3)`` in both packages,
the JAX run's draws replayed into the port's (query points at atol 1e-6; each loop then
observes the JAX package's points, so that region bounds compare at rtol 1e-9). Float64
throughout.
"""
from __future__ import annotations

import copy
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trieste_tpu as jt
from trieste_tpu import space as jsp
from trieste_tpu.acquisition import rule as jrule
from trieste_tpu.acquisition import trust_region as jtr
from trieste_tpu.acquisition import utils as jutils
from trieste_tpu.acquisition.function import function as jfun
from trieste_tpu.acquisition.optimizer import generate_continuous_optimizer as jgenerate
from trieste_tpu.bayesian_optimizer import stop_at_minimum as jstop_at_minimum
from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models.gp import posterior as jpost
from trieste_tpu.models.gp.gpr import GaussianProcessRegression as JGPR
from trieste_tpu.objectives import ScaledBranin as JScaledBranin
from trieste_tpu.objectives import utils as jobj
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu.utils.misc import LocalizedTag as JLocalizedTag
from trieste_tpu_torch import (
    AskTellOptimizer,
    AskTellOptimizerNoTraining,
    BayesianOptimizer,
    Dataset,
    Record,
    convert,
    stop_at_minimum,
)
from trieste_tpu_torch import space as tsp
from trieste_tpu_torch.acquisition import function as tfunctions
from trieste_tpu_torch.acquisition import optimizer as topt
from trieste_tpu_torch.acquisition import rule as trule
from trieste_tpu_torch.acquisition import trust_region as ttr
from trieste_tpu_torch.acquisition import utils as tutils
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.models.gp.gpr import GaussianProcessRegression
from trieste_tpu_torch.objectives import ScaledBranin, mk_batch_observer, mk_observer
from trieste_tpu_torch.observer import OBJECTIVE
from trieste_tpu_torch.utils.misc import LocalizedTag

torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-9


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=F64)


def _np(x):
    if x is None:
        return None
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _datasets(X, Y, capacity=None):
    """The same data in both packages: (JAX dataset, port dataset)."""
    X, Y = np.asarray(X, np.float64), np.asarray(Y, np.float64)
    cap = capacity or X.shape[0]
    return (JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y), capacity=cap),
            Dataset.from_arrays(_t(X), _t(Y), capacity=cap))


def _assert_same_dataset(tds, jds):
    assert tds.num_points == int(jds.num_points) and tds.capacity == jds.capacity
    np.testing.assert_allclose(_np(tds.query_points), _np(jds.query_points), rtol=RTOL, atol=0)
    np.testing.assert_allclose(_np(tds.observations), _np(jds.observations), rtol=RTOL, atol=0)


def _jtag(tag):
    return JLocalizedTag(tag.global_tag, tag.local_index) if isinstance(tag, LocalizedTag) else tag


def _boxes():
    return jsp.Box([0.0, 0.0], [1.0, 1.0]), tsp.Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu")


@pytest.fixture
def jax_draws(monkeypatch):
    """Feed the JAX package's draws to the port: every box sample the JAX package makes is
    recorded (its uniform draws) and the port's next box sample scales them to its own
    bounds; a port discrete region replays the index draws of ``_jax_key``, the key its
    JAX twin starts from. Returns the queue of recorded box draws."""
    queue = []
    original = jsp.Box.sample

    def record(self, key, n):
        queue.append(np.asarray(jax.random.uniform(key, (n, self.dimension), dtype=jnp.float64)))
        return original(self, key, n)

    def replay(self, generator, n):
        u = queue.pop(0)
        assert u.shape == (n, self.dimension)
        return self._scale(_t(u))

    def random_index(self):
        self._jax_key, sub = jax.random.split(self._jax_key)
        return int(jax.random.randint(sub, (), 0, self.global_search_space.points.shape[0]))

    monkeypatch.setattr(jsp.Box, "sample", record)
    monkeypatch.setattr(tsp.Box, "sample", replay)
    monkeypatch.setattr(ttr.UpdatableTrustRegionDiscrete, "_random_index", random_index)
    return queue


# -- the state of a region, compared field by field ---------------------------------------

FIELDS = ("location", "eps", "L", "success_counter", "failure_counter", "_y_min", "_is_global",
          "_needs_init")


def _state(region) -> dict:
    """The fields both packages' regions share, as numpy: a box region's bounds, a discrete
    region's points, a product region's members (prefixed by their tags)."""
    out = {}
    if hasattr(region, "regions"):
        for tag, member in region.regions.items():
            out.update({f"{tag}.{k}": v for k, v in _state(member).items()})
    elif isinstance(region, (jsp.GeneralDiscreteSearchSpace, tsp.GeneralDiscreteSearchSpace)):
        out["points"] = _np(region.points)
    else:
        out["lower"], out["upper"] = _np(region.lower), _np(region.upper)
    for name in FIELDS:
        if hasattr(region, name):
            out[name] = _np(getattr(region, name))
    return out


def _assert_same_state(tregion, jregion, when=""):
    got, want = _state(tregion), _state(jregion)
    assert got.keys() == want.keys(), when
    for name in want:
        if want[name] is None:
            assert got[name] is None, f"{when} {name}"
        else:
            np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=1e-12,
                                       err_msg=f"{when} {name}")


class _KernelModel:
    """Just a kernel: what TuRBO reads of a model."""

    def __init__(self, lengthscales):
        self._kernel = type("Kernel", (), {"lengthscales": lengthscales})()

    def get_kernel(self):
        return self._kernel


def _models(lengthscales=(0.5, 2.0)):
    return ({OBJECTIVE: _KernelModel(jnp.asarray(lengthscales))},
            {OBJECTIVE: _KernelModel(_t(lengthscales))})


def _point(jregion, where):
    """A member of the JAX region at fraction ``where`` of it, or the point ``where``."""
    if not isinstance(where, float):
        return np.asarray(where, np.float64)
    if hasattr(jregion, "regions"):
        return np.concatenate([_point(r, where) for r in jregion.regions.values()])
    if isinstance(jregion, jsp.GeneralDiscreteSearchSpace):
        pts = np.asarray(jregion.points)
        return pts[int(where * len(pts)) % len(pts)]
    lo, hi = np.asarray(jregion.lower), np.asarray(jregion.upper)
    return lo + where * (hi - lo)


WINDOW = 4


def _window(X, Y):
    """The last ``WINDOW`` observations, the oldest repeated in front while there are
    fewer: one shape on every step, so that the JAX package compiles its ops once."""
    X, Y = X[-WINDOW:], Y[-WINDOW:]
    pad = WINDOW - len(X)
    return _datasets([X[0]] * pad + X, [Y[0]] * pad + Y)


def _run_script(jregion, tregion, script, models=(None, None)):
    """``initialize`` both regions, then one ``update`` per step of ``script`` (a point
    and its observation, with the latest observations before it), the states compared
    after each call."""
    jm, tm = models
    jregion.initialize(jm, None)
    tregion.initialize(tm, None)
    _assert_same_state(tregion, jregion, "after initialize")
    X, Y = [], []
    for step, (where, y) in enumerate(script):
        X.append(_point(jregion, where))
        Y.append([y])
        jds, tds = _window(X, Y)
        jregion.update(jm, {OBJECTIVE: jds})
        tregion.update(tm, {OBJECTIVE: tds})
        _assert_same_state(tregion, jregion, f"after update {step}")


# improvement, a failure outside, failures until the region collapses and starts again,
# then improvement in the fresh region
BOX_SCRIPT = [(0.3, 1.0), (0.6, 0.5), ([0.99, 0.01], 2.0), (0.5, 3.0), (0.5, 3.0), (0.4, 3.0),
              (0.5, 3.0), (0.2, 0.1), (0.7, 0.05), (0.5, 4.0)]
GRID = np.stack(np.meshgrid(np.linspace(0, 1, 6), np.linspace(0, 1, 6)), -1).reshape(-1, 2)


def _region_pairs(kind):
    """(JAX region, port region, models) of one class, twins of one another."""
    jbox, tbox = _boxes()
    if kind == "box":
        return (jtr.SingleObjectiveTrustRegionBox(jbox, beta=0.5, min_eps=0.1, key=jax.random.PRNGKey(3)),
                ttr.SingleObjectiveTrustRegionBox(tbox, beta=0.5, min_eps=0.1), (None, None))
    if kind == "trego":
        return (jtr.TREGOBox(jbox, beta=0.5, min_eps=0.1, key=jax.random.PRNGKey(4)),
                ttr.TREGOBox(tbox, beta=0.5, min_eps=0.1), (None, None))
    if kind == "turbo":
        return (jtr.TURBOBox(jbox, L_min=0.3, success_tolerance=2, failure_tolerance=2),
                ttr.TURBOBox(tbox, L_min=0.3, success_tolerance=2, failure_tolerance=2), _models())
    if kind in ("discrete", "categorical", "fixed"):
        if kind == "categorical":
            jg, tg = jsp.CategoricalSearchSpace([3, 3, 2]), tsp.CategoricalSearchSpace([3, 3, 2], F64, device="cpu")
        else:
            jg, tg = jsp.DiscreteSearchSpace(jnp.asarray(GRID)), tsp.DiscreteSearchSpace(_t(GRID))
        if kind == "fixed":
            jr, tr = jtr.FixedPointTrustRegionDiscrete(jg, key=jax.random.PRNGKey(5)), \
                ttr.FixedPointTrustRegionDiscrete(tg)
        else:
            jr = jtr.SingleObjectiveTrustRegionDiscrete(jg, beta=0.5, min_eps=0.05, key=jax.random.PRNGKey(6))
            tr = ttr.SingleObjectiveTrustRegionDiscrete(tg, beta=0.5, min_eps=0.05)
        tr._jax_key = jr._key
        return jr, tr, (None, None)
    if kind in ("product", "product_fixed"):
        jd, td = jsp.DiscreteSearchSpace(jnp.linspace(0, 1, 6)[:, None]), tsp.DiscreteSearchSpace(_t(np.linspace(0, 1, 6)[:, None]))
        jc, tc = jsp.Box([0.0], [1.0]), tsp.Box([0.0], [1.0], dtype=F64, device="cpu")
        if kind == "product":
            jdr = jtr.SingleObjectiveTrustRegionDiscrete(jd, beta=0.5, min_eps=0.05, key=jax.random.PRNGKey(7))
            tdr = ttr.SingleObjectiveTrustRegionDiscrete(td, beta=0.5, min_eps=0.05)
        else:
            jdr = jtr.FixedPointTrustRegionDiscrete(jd, key=jax.random.PRNGKey(8))
            tdr = ttr.FixedPointTrustRegionDiscrete(td)
        tdr._jax_key = jdr._key
        jcr = jtr.SingleObjectiveTrustRegionBox(jc, beta=0.5, min_eps=0.1, key=jax.random.PRNGKey(9))
        tcr = ttr.SingleObjectiveTrustRegionBox(tc, beta=0.5, min_eps=0.1)
        return (jtr.UpdatableTrustRegionProduct([jdr, jcr], ["d", "c"], region_index=0),
                ttr.UpdatableTrustRegionProduct([tdr, tcr], ["d", "c"], region_index=0), (None, None))
    raise ValueError(kind)


SCRIPTS = {
    "box": BOX_SCRIPT,
    "trego": BOX_SCRIPT + [(0.5, -1.0), (0.5, 5.0), (0.5, 5.0), (0.5, 5.0), (0.5, 5.0)],
    "turbo": [(0.5, 1.0), (0.3, 0.5), (0.6, 0.2), (0.5, 3.0), (0.5, 3.0), (0.4, 3.0), (0.4, 3.0),
              (0.5, 3.0), (0.5, 3.0), (0.9, -1.0)],
    "discrete": [(0.0, 1.0), (0.5, 0.5), ([1.0, 1.0], 2.0), (0.3, 3.0), (0.3, 3.0), (0.6, 3.0),
                 (0.1, 0.2)],
    "fixed": [(0.0, 1.0), ([0.2, 0.4], 0.5)],
}
SCRIPTS["categorical"] = [(w, y) for w, y in SCRIPTS["discrete"] if isinstance(w, float)]
SCRIPTS["product"] = SCRIPTS["categorical"]
SCRIPTS["product_fixed"] = SCRIPTS["categorical"]


@pytest.mark.parametrize("kind", sorted(SCRIPTS))
def test_region_scripts_match_jax(kind, jax_draws):
    jregion, tregion, models = _region_pairs(kind)
    _run_script(jregion, tregion, SCRIPTS[kind], models)
    assert not jax_draws


def test_region_scripts_reach_every_branch(jax_draws):
    """The scripts above do what they are meant to: successes, failures, collapses and
    fresh starts, and both TREGO phases."""
    for kind in ("box", "trego", "turbo", "discrete"):
        jregion, tregion, models = _region_pairs(kind)
        jm, tm = models
        jregion.initialize(jm, None)
        tregion.initialize(tm, None)
        X, Y, seen = [], [], set()
        for where, y in SCRIPTS[kind]:
            X.append(_point(jregion, where))
            Y.append([y])
            jds, tds = _window(X, Y)
            before = copy.deepcopy(_state(tregion))
            jregion.update(jm, {OBJECTIVE: jds})
            tregion.update(tm, {OBJECTIVE: tds})
            if "eps" in before:
                ratio = np.max(np.asarray(tregion.eps)) / np.max(before["eps"])
                seen.add("grow" if ratio > 1.01 else "shrink" if ratio < 0.99 else "same")
            if "L" in before:
                seen.add("grow" if tregion.L > before["L"] else "shrink" if tregion.L < before["L"] else "same")
            if kind == "trego":
                seen.add("global" if tregion.is_global else "local")
        # a collapse starts the region again, at eps = zeta or L = L_init
        assert {"grow", "shrink"} <= seen, (kind, seen)
        if kind == "trego":
            assert {"global", "local"} <= seen


# -- convert: a port region put in the JAX region's state ---------------------------------


@pytest.mark.parametrize("kind", ["box", "trego", "turbo", "discrete"])
def test_region_state_from_numpy_then_updates_match_jax(kind, jax_draws):
    """The JAX region is moved on without the port's twin; then the twin is put in the same
    state through ``convert`` (no draws replayed) and both take the same update."""
    jregion, tregion, models = _region_pairs(kind)
    jm, tm = models
    jregion.initialize(jm, None)
    X, Y = [], []
    for where, y in SCRIPTS[kind][:3]:
        X.append(_point(jregion, where))
        Y.append([y])
        jregion.update(jm, {OBJECTIVE: _window(X, Y)[0]})
    jax_draws.clear()
    state = {k: v for k, v in _state(jregion).items() if v is not None}
    if kind == "discrete":
        convert.trust_region_discrete_state_from_numpy(
            tregion, state["points"], location=state["location"], eps=float(state["eps"]),
            y_min=float(state["_y_min"]), needs_init=bool(state["_needs_init"]))
    else:
        convert.trust_region_box_state_from_numpy(
            tregion, state["lower"], state["upper"], location=state.get("location"),
            eps=state.get("eps"), y_min=float(state["_y_min"]),
            needs_init=bool(state["_needs_init"]), is_global=state.get("_is_global"),
            L=state.get("L"), success_counter=state.get("success_counter", 0),
            failure_counter=state.get("failure_counter", 0))
    _assert_same_state(tregion, jregion, "after convert")
    X.append(_point(jregion, 0.45))
    Y.append([-2.0])
    jds, tds = _window(X, Y)
    jregion.update(jm, {OBJECTIVE: jds})
    tregion.update(tm, {OBJECTIVE: tds})
    _assert_same_state(tregion, jregion, "after the update")
    state = convert.batch_trust_region_state_from_regions([tregion])
    assert state.subspaces == (tregion,)


# -- _mask_to_region, filter_datasets -----------------------------------------------------


def test_mask_to_region_matches_jax_and_keeps_the_capacity():
    X = np.random.default_rng(0).uniform(size=(10, 2))
    jds, tds = _datasets(X, X.sum(-1, keepdims=True), capacity=16)
    for lo in (0.0, 0.3, 0.6, 0.95):
        inside = np.concatenate([np.all(X >= lo, axis=-1), np.zeros(6, bool)])
        want = jtr._mask_to_region(jds, jnp.asarray(inside))
        got = ttr._mask_to_region(tds, torch.as_tensor(inside))
        _assert_same_dataset(got, want)
        assert got.capacity == 16 and got.num_points == int(inside.sum())
        np.testing.assert_array_equal(_np(got.trimmed_query_points), X[inside[:10]])  # order kept


def _filter_pair(num_regions=3, n=20, seed=0):
    jbox, tbox = _boxes()
    X = np.random.default_rng(seed).uniform(size=(n, 2))
    jds, tds = _datasets(X, np.sum((X - 0.5) ** 2, -1, keepdims=True), capacity=32)
    jrule_, trule_ = jtr.BatchTrustRegionBox(init_subspaces=num_regions), ttr.BatchTrustRegionBox(init_subspaces=num_regions)
    jrule_.initialize_subspaces(jbox)
    trule_.initialize_subspaces(tbox)
    jdata = dict(jutils.with_local_datasets({OBJECTIVE: jds}, num_regions))
    tdata = tutils.with_local_datasets({OBJECTIVE: tds}, num_regions)
    return (jrule_, jdata), (trule_, tdata)


def test_filter_datasets_matches_jax_through_initialize_and_update(jax_draws):
    """The first call initializes the regions, the second updates them; every local
    dataset keeps the global capacity, re-masked to its region."""
    (jrule_, jdata), (trule_, tdata) = _filter_pair()
    jm, tm = _models()
    jstate = None
    tstate = None
    for _ in range(2):
        jstate, jfiltered = jrule_.filter_datasets(jm, jdata)(jstate)
        tstate, tfiltered = trule_.filter_datasets(tm, tdata)(tstate)
        assert set(tfiltered) == {OBJECTIVE} | {LocalizedTag(OBJECTIVE, i) for i in range(3)}
        for tag, tds in tfiltered.items():
            _assert_same_dataset(tds, jfiltered[_jtag(tag)])
            assert tds.capacity == 32
        for tr, jr in zip(tstate.subspaces, jstate.subspaces):
            _assert_same_state(tr, jr)
    assert not jax_draws
    # a region holding no observation yet keeps the whole dataset
    assert any(len(tfiltered[LocalizedTag(OBJECTIVE, i)]) < 20 for i in range(3))


def test_filter_empty_region_falls_back_to_global():
    _, tbox = _boxes()
    region = ttr.SingleObjectiveTrustRegionBox(tbox, generator=torch.Generator().manual_seed(0))
    region.initialize()
    region.location, region.eps = _t([0.05, 0.05]), _t([0.01, 0.01])
    region._resize_bounds()
    rule = ttr.BatchTrustRegionBox(init_subspaces=[region])
    rule.initialize_subspaces(tbox)
    rule._initialized = True  # the update path
    ds = Dataset.from_arrays(torch.full((4, 2), 0.9, dtype=F64), torch.ones(4, 1, dtype=F64))
    _, filtered = rule.filter_datasets({}, tutils.with_local_datasets({OBJECTIVE: ds}, 1))(None)
    assert len(filtered[LocalizedTag(OBJECTIVE, 0)]) == 4


def test_trego_filter_keeps_everything():
    _, tbox = _boxes()
    trego = ttr.TREGOBox(tbox, generator=torch.Generator().manual_seed(0))
    rule = ttr.BatchTrustRegionBox([trego], trule.EfficientGlobalOptimization())
    rule.initialize_subspaces(tbox)
    X = torch.rand(12, 2, generator=torch.Generator().manual_seed(1), dtype=F64)
    ds = Dataset.from_arrays(X, X.sum(-1, keepdim=True))
    _, filtered = rule.filter_datasets({}, tutils.with_local_datasets({OBJECTIVE: ds}, 1))(None)
    assert len(filtered[LocalizedTag(OBJECTIVE, 0)]) == 12
    trego._is_global = False
    trego.location, trego.eps = _t([0.1, 0.1]), _t([0.05, 0.05])
    trego._resize_bounds()
    assert bool(trego.dataset_filter_mask(ds).equal(ds.mask))
    plain = ttr.SingleObjectiveTrustRegionBox(tbox, generator=torch.Generator().manual_seed(0))
    plain.initialize()
    plain.location, plain.eps = _t([0.1, 0.1]), _t([0.05, 0.05])
    plain._resize_bounds()
    small = Dataset.from_arrays(_t([[0.1, 0.1], [0.9, 0.9]]), _t([[1.0], [2.0]]))
    assert plain.dataset_filter_mask(small)[:2].tolist() == [True, False]


# -- local datasets, the batch observer, early stop ----------------------------------------


@pytest.mark.parametrize("indices", [None, [[0, 1, 2], [3, 4]]])
def test_with_local_datasets_matches_jax(indices):
    X = np.random.default_rng(1).uniform(size=(6, 2))
    jds, tds = _datasets(X, X[:, :1])
    jix = None if indices is None else [jnp.asarray(i) for i in indices]
    tix = None if indices is None else [torch.as_tensor(i) for i in indices]
    want = jutils.with_local_datasets({OBJECTIVE: jds, "C": jds}, 2, jix)
    got = tutils.with_local_datasets({OBJECTIVE: tds, "C": tds}, 2, tix)
    assert [str(t) for t in got] == [str(t) for t in want]
    for tag, ds in got.items():
        _assert_same_dataset(ds, want[_jtag(tag)])
    again = tutils.with_local_datasets(got, 2)  # local datasets that exist are kept
    assert all(again[tag] is ds for tag, ds in got.items())


def test_local_dataset_and_model_helpers_match_jax():
    X = np.random.default_rng(2).uniform(size=(9, 2))
    jds, tds = _datasets(X, X[:, 1:])
    jb, tb = jsp.Box([0.2, 0.2], [0.8, 0.9]), tsp.Box([0.2, 0.2], [0.8, 0.9], dtype=F64, device="cpu")
    want, got = jutils.get_local_dataset(jb, jds), tutils.get_local_dataset(tb, tds)
    np.testing.assert_allclose(_np(got.trimmed_query_points), _np(want.trimmed_query_points), rtol=RTOL)
    assert len(got) == len(want) > 0
    with pytest.raises(ValueError, match="dimensions"):
        tutils.get_local_dataset(tsp.Box([0.0], [1.0], device="cpu"), tds)
    model = _KernelModel(_t([1.0]))
    local = tutils.copy_to_local_models(model, 3)
    assert list(local) == [LocalizedTag(OBJECTIVE, i) for i in range(3)]
    assert [str(t) for t in local] == [str(t) for t in jutils.copy_to_local_models(model, 3)]
    assert all(m is not model for m in local.values())
    assert list(tutils.copy_to_local_models(model, 1, "C")) == [LocalizedTag("C", 0)]


def test_mk_batch_observer_matches_jax():
    qps = np.random.default_rng(3).uniform(size=(2, 3, 2))
    jq = lambda x: jnp.sum(x**2, -1, keepdims=True)  # noqa: E731
    tq = lambda x: torch.sum(x**2, -1, keepdim=True)  # noqa: E731
    want = jobj.mk_batch_observer(jobj.mk_observer(jq))(jnp.asarray(qps))
    got = mk_batch_observer(mk_observer(tq))(_t(qps))
    assert [str(t) for t in got] == [str(t) for t in want]
    for tag, ds in got.items():
        _assert_same_dataset(ds, want[_jtag(tag)])
    # a rank-2 batch and an objective (not an observer) pass through; a multi-observer
    # keeps its tags
    flat = mk_batch_observer(tq)(_t(qps[0]))
    assert list(flat) == [OBJECTIVE] and len(flat[OBJECTIVE]) == 3
    multi = mk_batch_observer(lambda x: {"A": mk_observer(tq)(x)})(_t(qps))
    assert set(multi) == {"A"} | {LocalizedTag("A", v) for v in range(3)}
    with pytest.raises(ValueError, match="rank 2 or 3"):
        mk_batch_observer(tq)(_t(qps[None]))


@pytest.mark.parametrize("case", ["minimum", "minimizer", "neither", "local_only", "other_tag"])
def test_stop_at_minimum_matches_jax(case):
    X = np.array([[0.1, 0.2], [0.5, 0.5], [0.9, 0.3]])
    Y = np.array([[1.0], [-0.998], [2.0]])
    jds, tds = _datasets(X, Y)
    tag = {"local_only": LocalizedTag(OBJECTIVE, 0), "other_tag": "C"}.get(case, OBJECTIVE)
    kwargs = dict(minimum=[-1.0] if case != "minimizer" else None,
                  minimizers=[[0.5, 0.5]] if case == "minimizer" else [[0.0, 0.0]],
                  minimum_rtol=0.005 if case != "neither" else 1e-4)
    want = jstop_at_minimum(**kwargs)({_jtag(tag): jds}, {}, None)
    got = stop_at_minimum(**{k: (_t(v) if v is not None else None) for k, v in kwargs.items()
                             if k != "minimum_rtol"}, minimum_rtol=kwargs["minimum_rtol"])(
        {tag: tds}, {}, None)
    assert got == want
    assert got == (case in ("minimum", "minimizer", "local_only"))


def test_select_local_and_is_improvement_match_jax():
    mapping = {OBJECTIVE: 0, LocalizedTag(OBJECTIVE, 0): 1, LocalizedTag(OBJECTIVE, 1): 2, "C": 3}
    jmapping = {_jtag(k): v for k, v in mapping.items()}
    for i in range(3):
        assert ttr._select_local(mapping, i) == jtr._select_local(jmapping, i)
    for y_new, y_min, margin in ((1.0, math.inf, math.inf), (math.inf, math.inf, math.inf),
                                 (0.5, 1.0, 0.1), (0.95, 1.0, 0.1), (-1.0, -0.5, 0.0)):
        assert ttr._is_improvement(y_new, y_min, margin) == jtr._is_improvement(y_new, y_min, margin)


# -- behaviour of the regions and the rules (the JAX package's own cases) ---------------------


def _region(kind="box", **kwargs):
    _, tbox = _boxes()
    cls = {"box": ttr.SingleObjectiveTrustRegionBox, "trego": ttr.TREGOBox}[kind]
    return cls(tbox, generator=torch.Generator().manual_seed(0), **kwargs)


def _one(x, y):
    return {OBJECTIVE: Dataset.from_arrays(_t([x]), _t([[y]]))}


@pytest.mark.parametrize("y_min, factor", [(1.0, 1 / 0.7), (-10.0, 0.7)])
def test_single_objective_region_grows_on_success_and_shrinks_on_failure(y_min, factor):
    region = _region()
    region.initialize()
    region.location, region.eps, region._y_min = _t([0.5, 0.5]), _t([0.2, 0.2]), y_min
    region._resize_bounds()
    region.update(datasets=_one([0.5, 0.5], 0.5))
    np.testing.assert_allclose(_np(region.eps), 0.2 * factor, rtol=1e-12)
    np.testing.assert_allclose(region.lower.numpy(), 0.5 - 0.2 * factor, rtol=1e-12)


def test_region_reinitializes_when_tiny():
    region = _region(min_eps=0.1)
    region.initialize()
    region.eps, region._y_min = _t([0.11, 0.11]), -10.0
    region.update(datasets=_one([0.5, 0.5], 0.5))
    np.testing.assert_allclose(_np(region.eps), 0.5, rtol=1e-12)
    assert not region.requires_initialization


def test_trego_alternates_phases():
    region = _region("trego")
    region.initialize(datasets=_one([0.5, 0.5], 10.0))
    assert region.is_global and region.lower.tolist() == [0.0, 0.0]
    region.update(datasets=_one([0.5, 0.5], 20.0))  # the first update succeeds
    assert region.is_global
    region.update(datasets=_one([0.5, 0.5], 20.0))  # a failure: local
    assert not region.is_global
    eps = _np(region.eps)
    region.update(datasets=_one([0.4, 0.4], -5.0))  # a local success: global, eps grown
    assert region.is_global
    np.testing.assert_allclose(_np(region.eps), eps / 0.7, rtol=1e-12)
    np.testing.assert_allclose(_np(region.location), [0.4, 0.4])
    eps = _np(region.eps)
    region.update(datasets=_one([0.4, 0.4], -5.0))  # a global failure: local, eps kept
    assert not region.is_global
    np.testing.assert_allclose(_np(region.eps), eps)


def test_turbo_doubles_halves_and_is_inf_safe():
    _, tbox = _boxes()
    region = ttr.TURBOBox(tbox, success_tolerance=2, failure_tolerance=2)
    region.initialize(datasets=_one([0.5, 0.5], 1.0))
    L0 = region.L
    for y in (0.5, 0.2):
        region.update(datasets=_one([0.5, 0.5], y))
    assert region.L == pytest.approx(2 * L0)
    for y in (5.0, 5.0):
        region.update(datasets=_one([0.5, 0.5], y))
    assert region.L == pytest.approx(L0)
    fresh = ttr.TURBOBox(tbox, success_tolerance=1, failure_tolerance=2)
    fresh.initialize()  # no data: its centre is drawn, its minimum is inf
    assert math.isinf(fresh._y_min) and bool(tbox.contains(fresh.location))
    fresh.update(datasets=_one([0.5, 0.5], 1.0))
    assert fresh.L == pytest.approx(2 * fresh.L_init)
    with pytest.raises(ValueError, match="success tolerance"):
        ttr.TURBOBox(tbox, success_tolerance=0)
    with pytest.raises(ValueError, match="failure tolerance"):
        ttr.TURBOBox(tbox, failure_tolerance=0)


def test_discrete_region_first_update_succeeds_then_converges():
    grid = np.stack(np.meshgrid(np.linspace(0, 1, 11), np.linspace(0, 1, 11)), -1).reshape(-1, 2)
    space = tsp.DiscreteSearchSpace(_t(grid))
    region = ttr.SingleObjectiveTrustRegionDiscrete(space, generator=torch.Generator().manual_seed(0))
    region.initialize()
    assert math.isinf(region._y_min)
    inside = region.points[0]
    region.update(datasets={OBJECTIVE: Dataset.from_arrays(inside[None], _t([[3.5]]))})
    assert region._y_min == 3.5 and region.eps == pytest.approx(0.5 / 0.7)
    region.update(datasets={OBJECTIVE: Dataset.from_arrays(inside[None], _t([[10.0]]))})
    assert region._y_min == 3.5 and region.eps == pytest.approx(0.5)
    gen = torch.Generator().manual_seed(7)
    region = ttr.SingleObjectiveTrustRegionDiscrete(space, generator=torch.Generator().manual_seed(3))
    region.initialize()
    for _ in range(8):
        qp = region.points[torch.randint(0, region.points.shape[0], (4,), generator=gen)]
        region.update(datasets={OBJECTIVE: Dataset.from_arrays(qp, torch.sum((qp - 0.5) ** 2, -1, keepdim=True))})
    assert math.isfinite(region._y_min)
    np.testing.assert_allclose(_np(region.location), [0.5, 0.5], atol=0.3)


def _mixed_space():
    return tsp.TaggedProductSearchSpace(
        [tsp.Box([0.0], [1.0], dtype=F64, device="cpu"), tsp.DiscreteSearchSpace(_t(np.linspace(0, 1, 11)[:, None]))],
        tags=["cont", "disc"],
    )


def _product_region():
    space = _mixed_space()
    gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    return space, ttr.UpdatableTrustRegionProduct(
        [ttr.SingleObjectiveTrustRegionBox(space.get_subspace("cont"), generator=gen(0)),
         ttr.SingleObjectiveTrustRegionDiscrete(space.get_subspace("disc"), generator=gen(7))],
        tags=["cont", "disc"], region_index=0,
    )


def test_product_regions_read_their_own_columns():
    space, region = _product_region()
    region.initialize()
    cont, disc = region.regions.values()
    assert (cont.input_active_dims, disc.input_active_dims) == ((0, 1), (1, 2))
    cont.location, cont.eps, cont._y_min = _t([0.5]), _t([0.3]), 1.0
    cont._resize_bounds()
    ds = Dataset.from_arrays(_t([[0.52, 0.4], [0.9, 0.6]]), _t([[0.5], [2.0]]))
    region.update(datasets={OBJECTIVE: ds})
    np.testing.assert_allclose(_np(cont.location), [0.52], atol=1e-12)
    cont.location, cont.eps = _t([0.5]), _t([0.1])
    cont._resize_bounds()
    mask = cont.dataset_filter_mask(Dataset.from_arrays(_t([[0.5, 0.2], [0.95, 0.2]]), _t([[1.0], [2.0]])))
    assert mask[:2].tolist() == [True, False]
    # membership is componentwise
    member = torch.cat([cont.location, disc.points[0]])
    assert bool(region.contains(member))
    assert not bool(region.contains(member + _t([0.0, 0.03])))
    assert not region.requires_initialization
    disc._needs_init = True
    assert region.requires_initialization


def test_batch_trust_region_product_defaults_and_refusals():
    rule = ttr.BatchTrustRegionProduct(init_subspaces=2)
    rule.initialize_subspaces(_mixed_space())
    assert rule.num_local_datasets == 2
    for s in rule._subspaces:
        assert isinstance(s, ttr.UpdatableTrustRegionProduct)
        assert [type(r).__name__ for r in s.regions.values()] == [
            "SingleObjectiveTrustRegionBox", "SingleObjectiveTrustRegionDiscrete"]
    assert isinstance(rule._rule, list) and len(rule._rule) == 2
    with pytest.raises(ValueError, match="TaggedProductSearchSpace"):
        ttr.BatchTrustRegionProduct(init_subspaces=2).initialize_subspaces(_boxes()[1])
    space = tsp.DiscreteSearchSpace(_t(np.linspace(0, 1, 7)[:, None]))
    fixed = ttr.FixedPointTrustRegionDiscrete(space, generator=torch.Generator().manual_seed(0))
    fixed.initialize()
    before = fixed.points.clone()
    fixed.update(datasets=_one([0.5], 0.1))
    assert torch.equal(fixed.points, before) and fixed.points.shape == (1, 1)


def test_rule_bookkeeping():
    _, tbox = _boxes()
    regions = [ttr.SingleObjectiveTrustRegionBox(tbox, generator=torch.Generator().manual_seed(i)) for i in range(3)]
    rule = ttr.BatchTrustRegionBox(init_subspaces=regions)
    assert [r.region_index for r in regions] == [0, 1, 2] and rule.num_local_datasets == 3
    rule = ttr.BatchTrustRegionBox(init_subspaces=4)
    rule.initialize_subspaces(tbox)
    assert rule.num_local_datasets == 4 and len(rule._subspaces) == 4
    assert isinstance(rule._rule._builder, object) and rule._rule.num_query_points == 4
    with pytest.raises(ValueError, match="not initialized"):
        ttr.BatchTrustRegionBox(2).filter_datasets({}, {})(None)
    assert isinstance(rule, trule.LocalDatasetsAcquisitionRule)


def test_region_fleet_state_copies_and_saves(tmp_path):
    _, tbox = _boxes()
    regions = tuple(ttr.SingleObjectiveTrustRegionBox(tbox, region_index=i, generator=torch.Generator().manual_seed(i))
                    for i in range(3))
    for r in regions:
        r.initialize()
    state = ttr.BatchTrustRegionState(regions)
    assert state.acquisition_space.num_subspaces == 3
    copied = copy.deepcopy(state)
    np.testing.assert_allclose(_np(copied.subspaces[0].lower), _np(state.subspaces[0].lower))
    # the copy's generator goes on as the original's does
    draws = [r._generator for r in (state.subspaces[1], copied.subspaces[1])]
    assert torch.equal(torch.rand(3, generator=draws[0]), torch.rand(3, generator=draws[1]))
    ds = Dataset.from_arrays(_t([[0.5, 0.5]]), _t([[1.0]]))
    frozen = Record({OBJECTIVE: ds}, {}, state).save(tmp_path / "step.0.pickle")
    loaded = frozen.acquisition_state
    np.testing.assert_allclose(_np(loaded.subspaces[2].upper), _np(state.subspaces[2].upper))
    np.testing.assert_allclose(_np(loaded.subspaces[2].eps), _np(state.subspaces[2].eps))
    buffer = io.BytesIO()
    torch.save(state, buffer)
    assert buffer.tell() > 0


# -- acquire paths and the loops -----------------------------------------------------------


def _gpr(n=10, seed=0, capacity=16):
    X = np.random.default_rng(seed).uniform(size=(n, 2))
    ds = Dataset.from_arrays(_t(X), _t(np.sum((X - 0.5) ** 2, -1, keepdims=True)), capacity=capacity)
    model = GaussianProcessRegression(
        convert.gpr_params_from_numpy("matern52", 0.5, [0.4, 0.5], 1e-3, 0.0, device="cpu", dtype=F64),
        ds, num_kernel_samples=2, max_optimize_iters=20, num_rff_features=64,
    )
    return model, ds


SMALL = topt.generate_continuous_optimizer(num_initial_samples=128, num_optimization_runs=3)


@pytest.mark.parametrize("path", ["vectorized", "per_region"])
def test_acquire_paths_give_one_point_per_region(path):
    model, ds = _gpr()
    _, tbox = _boxes()
    V = 3 if path == "vectorized" else 2
    rules = None if path == "vectorized" else [trule.EfficientGlobalOptimization(optimizer=SMALL) for _ in range(V)]
    rule = ttr.BatchTrustRegionBox(init_subspaces=V, rule=rules)
    rule.initialize_subspaces(tbox)
    state, filtered = rule.filter_datasets({OBJECTIVE: model}, tutils.with_local_datasets({OBJECTIVE: ds}, V))(None)
    gen = torch.Generator().manual_seed(0)
    state, points = rule.acquire(tbox, {OBJECTIVE: model}, filtered, generator=gen)(state)
    assert tuple(points.shape) == (1, V, 2)
    for v in range(V):
        assert bool(state.subspaces[v].contains(points[0, v]))
    assert bool(state.acquisition_space.contains(points).all())


def _quadratic(x):
    return torch.sum((x - 0.5) ** 2, -1, keepdim=True)


def test_batch_trust_region_with_local_models_in_the_loop():
    _, tbox = _boxes()
    observer = mk_observer(_quadratic)
    gen = torch.Generator().manual_seed(1)
    initial = observer(tbox.sample(gen, 6))
    local_models = tutils.copy_to_local_models(build_gpr(initial, tbox, num_kernel_samples=2), 2)
    rule = ttr.BatchTrustRegionBox(2, [trule.EfficientGlobalOptimization(optimizer=SMALL) for _ in range(2)])
    result = BayesianOptimizer(observer, tbox).optimize(
        2, {OBJECTIVE: initial}, dict(local_models), rule, generator=gen, track_state=False)
    assert result.is_ok, result.final_result
    datasets = result.try_get_final_datasets()
    assert LocalizedTag(OBJECTIVE, 0) in datasets and len(datasets[OBJECTIVE]) == 6 + 2 * 2


def _local_opt(kind=AskTellOptimizerNoTraining, n=2, **kwargs):
    _, tbox = _boxes()
    model, ds = _gpr(8, capacity=None)
    rule = ttr.BatchTrustRegionBox(n, [trule.EfficientGlobalOptimization(optimizer=SMALL) for _ in range(n)])
    return tbox, kind(tbox, {OBJECTIVE: ds}, {OBJECTIVE: model}, rule,
                      generator=torch.Generator().manual_seed(1), **kwargs)


def test_ask_tell_with_a_local_rule():
    """The local Ask/Tell flows: local datasets made at construction (from
    ``local_data_ixs`` where given), a tell of the global data only, a state round trip
    that goes on asking, and a training optimizer that refits on the global data."""
    space, opt = _local_opt()
    assert set(opt.datasets) == {OBJECTIVE, LocalizedTag(OBJECTIVE, 0), LocalizedTag(OBJECTIVE, 1)}
    points = opt.ask()
    assert tuple(points.shape) == (1, 2, 2)
    opt.tell({OBJECTIVE: mk_observer(_quadratic)(points.reshape(-1, 2))})
    assert len(opt.datasets[OBJECTIVE]) == 10
    resumed = AskTellOptimizerNoTraining.from_state(
        opt.to_state(copy=True), space,
        ttr.BatchTrustRegionBox(2, [trule.EfficientGlobalOptimization(optimizer=SMALL) for _ in range(2)]))
    again = resumed.ask()
    assert tuple(again.shape) == (1, 2, 2) and bool(space.contains(again.reshape(-1, 2)).all())
    _, subset = _local_opt(local_data_ixs=(torch.tensor([0, 1, 2]), torch.tensor([3, 4])))
    assert len(subset.datasets[LocalizedTag(OBJECTIVE, 0)]) == 3
    assert len(subset.datasets[LocalizedTag(OBJECTIVE, 1)]) == 2
    space, trained = _local_opt(AskTellOptimizer, n=1)
    for _ in range(2):
        points = trained.ask()
        trained.tell({OBJECTIVE: mk_observer(_quadratic)(points.reshape(-1, 2))})
    assert len(trained.datasets[OBJECTIVE]) == 10 and trained.model.dataset.num_points == 10


def test_the_loop_stops_at_the_minimum_with_a_trust_region():
    _, tbox = _boxes()
    observer = mk_observer(_quadratic)
    gen = torch.Generator().manual_seed(0)
    initial = observer(tbox.sample(gen, 5))
    rule = ttr.BatchTrustRegionBox([ttr.TREGOBox(tbox, generator=gen)], trule.EfficientGlobalOptimization(optimizer=SMALL))
    result = BayesianOptimizer(observer, tbox).optimize(
        10, initial, build_gpr(initial, tbox, num_kernel_samples=1), rule, generator=gen,
        early_stop_callback=stop_at_minimum(minimizers=_t([[0.5, 0.5]]), minimizers_atol=0.05))
    assert result.is_ok, result.final_result
    assert len(result.history) < 10 and len(result.try_get_final_dataset()) == 5 + len(result.history)
    assert isinstance(result.history[-1].acquisition_state, ttr.BatchTrustRegionState)


# -- the slice as a whole, both packages --------------------------------------------------


def _without_hyperparameter_fits(*models):
    """The loops still update each model with its data; its hyperparameters stay (their
    fit is held against the JAX package's in ``tests/test_torch_ask_tell.py``, and
    compiling the JAX fit would double these tests' time)."""
    for model in models:
        model.optimize = lambda dataset: None


def _branin_pair(n=6, seed=0):
    """ScaledBranin data (capacity 16) and the same GPR over it in both packages."""
    X = np.random.default_rng(seed).uniform(size=(n, 2))
    Y = np.asarray(JScaledBranin.objective(jnp.asarray(X)))
    jds, tds = _datasets(X, Y, capacity=16)
    jspace = JScaledBranin.search_space
    tspace = ScaledBranin.search_space.to("cpu", F64)
    hyper = ("matern52", float(Y.var()), [0.3, 0.4], float(Y.var()) / 100, float(Y.mean()))
    jmodel = JGPR(jpost.GPRParams(jstationary(*hyper[:3], dtype=jnp.float64),
                                  jnp.asarray(hyper[3]), jnp.asarray(hyper[4])), jds)
    tmodel = GaussianProcessRegression(
        convert.gpr_params_from_numpy(*hyper, device="cpu", dtype=F64), tds)
    return (jspace, jds, jmodel), (tspace, tds, tmodel)


def _fleet_states(state):
    return [_state(r) for r in state.subspaces] if state is not None else None


def _assert_same_fleets(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        for a, b in zip(g, w):
            for name in ("lower", "upper", "eps", "_is_global"):
                if name in b:
                    np.testing.assert_allclose(a[name], b[name], rtol=RTOL, atol=1e-12)


N, R = 96, 3


def test_trego_through_the_loop_matches_jax_over_three_steps(jax_draws):
    """Three steps of TREGO with EI through ``BayesianOptimizer.optimize`` in both
    packages; the JAX run first (its region and seed draws and its query points recorded),
    then the port's on those draws, its observer holding each batch to the JAX package's
    and observing the latter."""
    (jspace, jds, jmodel), (tspace, tds, tmodel) = _branin_pair()
    _without_hyperparameter_fits(jmodel, tmodel)
    jfleets, tfleets, asked = [], [], []

    def jobserver(qp):
        asked.append(np.asarray(qp))
        return jobj.mk_observer(JScaledBranin.objective)(qp)

    def tobserver(qp):
        want = asked.pop(0)
        np.testing.assert_allclose(_np(qp), want, atol=1e-6)
        return mk_observer(ScaledBranin.objective)(_t(want))

    jrule_ = jtr.BatchTrustRegionBox(
        [jtr.TREGOBox(jspace, key=jax.random.PRNGKey(3))], jrule.EfficientGlobalOptimization(optimizer=jgenerate(N, R)))
    jresult = jt.BayesianOptimizer(jobserver, jspace).optimize(
        3, jds, jmodel, jrule_, key=jax.random.PRNGKey(5), track_state=False,
        early_stop_callback=lambda d, m, s: jfleets.append(_fleet_states(s)) or False)
    trule_ = ttr.BatchTrustRegionBox(
        [ttr.TREGOBox(tspace)], trule.EfficientGlobalOptimization(optimizer=topt.generate_continuous_optimizer(N, R)))
    tresult = BayesianOptimizer(tobserver, tspace).optimize(
        3, tds, tmodel, trule_, track_state=False,
        early_stop_callback=lambda d, m, s: tfleets.append(_fleet_states(s)) or False)
    assert jresult.is_ok and tresult.is_ok, tresult.final_result
    assert not jax_draws and not asked
    want, got = jresult.try_get_final_dataset(), tresult.try_get_final_dataset()
    assert len(got) == int(want.num_points) == 9
    _assert_same_dataset(got, want)
    _assert_same_fleets(tfleets, jfleets)
    jfinal = jresult.final_result.unwrap().acquisition_state
    _assert_same_fleets([_fleet_states(tresult.final_result.unwrap().acquisition_state)], [_fleet_states(jfinal)])
    assert set(tresult.try_get_final_datasets()) == {OBJECTIVE, LocalizedTag(OBJECTIVE, 0)}


def test_ask_tell_batch_trust_region_matches_jax_over_three_rounds(jax_draws):
    """Three Ask/Tell rounds of ``BatchTrustRegionBox(init_subspaces=3)`` with its default
    regions and MONLCB over the fleet (a smaller seed pool), in both packages; the JAX run
    first, then the port's on its draws."""
    (jspace, jds, jmodel), (tspace, tds, tmodel) = _branin_pair(seed=1)
    _without_hyperparameter_fits(jmodel, tmodel)
    jmon = jrule.EfficientGlobalOptimization(
        jfun.MultipleOptimismNegativeLowerConfidenceBound(jspace),
        jgenerate(N, R), num_query_points=3)
    jopt_ = jt.AskTellOptimizer(jspace, jds, jmodel, jtr.BatchTrustRegionBox(3, jmon), key=jax.random.PRNGKey(2))
    jpoints, jfleets = [], []
    for _ in range(3):
        points = jopt_.ask()
        jpoints.append(np.asarray(points))
        jopt_.tell(jobj.mk_observer(JScaledBranin.objective)(jnp.reshape(points, (-1, 2))))
        jfleets.append(_fleet_states(jopt_.acquisition_state))
    tmon = trule.EfficientGlobalOptimization(
        tfunctions.MultipleOptimismNegativeLowerConfidenceBound(tspace), topt.generate_continuous_optimizer(N, R), 3)
    topt_ = AskTellOptimizer(tspace, tds, tmodel, ttr.BatchTrustRegionBox(3, tmon))
    tfleets = []
    for want in jpoints:
        points = topt_.ask()
        assert tuple(points.shape) == (1, 3, 2)
        np.testing.assert_allclose(_np(points), want, atol=1e-6)
        topt_.tell(mk_observer(ScaledBranin.objective)(_t(want).reshape(-1, 2)))
        tfleets.append(_fleet_states(topt_.acquisition_state))
    assert not jax_draws
    _assert_same_fleets(tfleets, jfleets)
    assert len(topt_.dataset) == 15 and topt_.dataset.capacity == 16
    # the state carries the fleet across a restart (whose fresh rule initializes it anew)
    jax_draws.extend(np.full((1, 2), 0.5) for _ in range(3))
    state = topt_.to_state(copy=True)
    restored = AskTellOptimizer.from_state(state, tspace, ttr.BatchTrustRegionBox(3, tmon))
    assert set(restored.datasets) == set(topt_.datasets)
    assert isinstance(restored.acquisition_state, ttr.BatchTrustRegionState)

"""The port's improvement and confidence-bound family (PoI, EI with a search space,
augmented EI, the LCBs, PoF, constrained EI, ``MakePositive``, MONLCB), the combinators
and the function forms on the CPU, against the JAX package in float64.

Each module-level function and each builder is held against its JAX counterpart on the
same GPR (made from a seed with numpy, carried over by ``convert``) at rtol 1e-9 /
atol 1e-10; the closed-form checks of the JAX package's own tests follow, on the port.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import Partial

from trieste_tpu.acquisition import combination as jcomb
from trieste_tpu.acquisition.utils import predictor as jpredictor
from trieste_tpu.acquisition.function import function as jfun
from trieste_tpu.acquisition.function import functional as jfl
from trieste_tpu.acquisition.function import utils as jfutils
from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models.gp import posterior as jpost
from trieste_tpu.models.gp.gpr import GaussianProcessRegression as JGPR
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu.space import Box as JBox
from trieste_tpu_torch import Box, Dataset, convert
from trieste_tpu_torch import acquisition as tacq
from trieste_tpu_torch.acquisition import combination as tcomb
from trieste_tpu_torch.acquisition.function import function as tfun
from trieste_tpu_torch.acquisition.function import functional as tfl
from trieste_tpu_torch.acquisition.interface import VectorizedAcquisitionFunctionBuilder
from trieste_tpu_torch.models.gp.gpr import GaussianProcessRegression

torch.set_num_threads(1)

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-10)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _pair(n=9, seed=0, noise=1e-2, target=lambda X: np.sum(X**2, -1, keepdims=True)):
    """The same 2-D GPR (capacity 16, partly padded) in both packages, float64."""
    X = np.random.default_rng(seed).uniform(-1.0, 1.0, size=(n, 2))
    Y = target(X)
    jmodel = JGPR(jpost.GPRParams(jstationary("matern52", 1.1, [0.6, 0.8], dtype=jnp.float64),
                                  jnp.asarray(noise), jnp.asarray(0.3)),
                  JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y)))
    tmodel = GaussianProcessRegression(
        convert.gpr_params_from_numpy("matern52", 1.1, [0.6, 0.8], noise, 0.3, device="cpu",
                                      dtype=F64),
        Dataset.from_arrays(_t(X), _t(Y)),
    )
    return jmodel, tmodel


@pytest.fixture(scope="module")
def pair():
    jm, tm = _pair()
    return jm, tm, jm.get_internal_data(), tm.dataset


def _x(lead=(12,), B=1, seed=1):
    """Queries of 12 rows in all, so that the JAX package compiles its prediction once."""
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=lead + (B, 2))


_APPLY = jax.jit(lambda f, x: f(x))
"""A JAX acquisition function at ``x``, compiled whole (op by op it compiles every
primitive anew, several seconds a function); a ``Partial`` is an argument, so a function
of the same structure and shapes compiles once."""


def _same(tfn, jfn, x):
    got, want = tfn(_t(x)), np.asarray(_APPLY(jfn, jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


# -- the module-level functions -------------------------------------------------------------


@pytest.mark.parametrize("lead", [(12,), (3, 4)])
@pytest.mark.parametrize("name", ["_ei_fn", "_poi_fn", "_neg_lcb_fn", "_pof_fn"])
def test_single_point_functions_match_jax(pair, name, lead):
    jm, tm, _, _ = pair
    scalar = 0.35
    _same(lambda x: getattr(tfun, name)(tm.predict, torch.tensor(scalar, dtype=F64), x),
          Partial(getattr(jfun, name), jpredictor(jm), jnp.asarray(scalar)), _x(lead))


def test_augmented_ei_and_make_positive_match_jax(pair):
    jm, tm, _, _ = pair
    noise = 0.05
    _same(lambda x: tfun._aei_fn(tm.predict, 0.2, torch.tensor(noise, dtype=F64), x),
          Partial(jfun._aei_fn, jpredictor(jm), jnp.asarray(0.2), jnp.asarray(noise)), _x())
    tbase = lambda x: tfun._neg_lcb_fn(tm.predict, 1.0, x)  # noqa: E731
    jbase = Partial(jfun._neg_lcb_fn, jpredictor(jm), jnp.asarray(1.0))
    _same(lambda x: tfun._make_positive_fn(tbase, x),
          Partial(jfun._make_positive_fn, jbase), _x())
    _same(lambda x: tfun._product_fn((tbase, tbase), x),
          Partial(jfun._product_fn, (jbase, jbase)), _x())


@pytest.mark.parametrize("V", [1, 3])
def test_monlcb_functions_match_jax(pair, V):
    jm, tm, _, _ = pair
    x = _x((12 // V,), V)
    _same(lambda x: tfun._monlcb_fn_spread(tm.predict, 2.0, x),
          Partial(jfun._monlcb_fn_spread, jpredictor(jm), jnp.asarray(2.0)), x)
    betas = np.linspace(0.1, 3.0, V)
    _same(lambda x: tfun._monlcb_fn(tm.predict, _t(betas), x),
          Partial(jfun._monlcb_fn, jpredictor(jm), jnp.asarray(betas)), x)


def test_single_point_functions_refuse_batches(pair):
    _, tm, _, _ = pair
    with pytest.raises(ValueError, match="batch sizes of one"):
        tfun._poi_fn(tm.predict, 0.0, _t(_x(B=2)))


# -- the builders ------------------------------------------------------------------------


BUILDERS = [
    ("ProbabilityOfImprovement", ()),
    ("AugmentedExpectedImprovement", ()),
    ("NegativeLowerConfidenceBound", (1.5,)),
    ("NegativePredictiveMean", ()),
    ("ProbabilityOfFeasibility", (0.4,)),
]


@pytest.mark.parametrize("name, args", BUILDERS)
def test_builders_match_jax(pair, name, args):
    jm, tm, jds, tds = pair
    jfn = getattr(jfun, name)(*args).prepare_acquisition_function(jm, jds)
    tbuilder = getattr(tfun, name)(*args)
    tfn = tbuilder.prepare_acquisition_function(tm, tds)
    _same(tfn, jfn, _x())
    _same(tbuilder.update_acquisition_function(tfn, tm, tds), jfn, _x())
    assert repr(tbuilder) == repr(getattr(jfun, name)(*args))


def test_builders_validate_their_arguments(pair):
    _, tm, _, _ = pair
    with pytest.raises(ValueError, match="beta must be non-negative"):
        tfun.NegativeLowerConfidenceBound(-1.0)
    with pytest.raises(ValueError, match="non-empty dataset"):
        tfun.ProbabilityOfImprovement().prepare_acquisition_function(tm, None)
    with pytest.raises(ValueError, match="min_feasibility_probability"):
        tfun.ExpectedConstrainedImprovement("OBJECTIVE", tfun.ProbabilityOfFeasibility(0.0), 1.5)
    assert tfun.ProbabilityOfFeasibility(0.25).threshold == 0.25


def test_expected_improvement_takes_a_search_space(pair):
    """``ExpectedImprovement(space)``: an unconstrained box leaves the incumbent as it is."""
    jm, tm, jds, tds = pair
    jfn = jfun.ExpectedImprovement(JBox([-1.0, -1.0], [1.0, 1.0])).prepare_acquisition_function(
        jm, jds)
    space = Box([-1.0, -1.0], [1.0, 1.0], dtype=F64, device="cpu")
    _same(tfun.ExpectedImprovement(space).prepare_acquisition_function(tm, tds), jfn, _x())


def test_expected_improvement_eta_over_feasible_points(pair):
    """A space with constraints takes the incumbent over its feasible observed points (the
    JAX logic; no space of the port has constraints yet, so a stand-in gives them)."""
    _, tm, _, tds = pair

    class HalfPlane:
        has_constraints = True

        def is_feasible(self, x):
            return x[:, 0] > 0.0

    builder = tfun.ExpectedImprovement(HalfPlane())
    mean, _ = tm.predict(tds.trimmed_query_points)
    feasible = tds.trimmed_query_points[:, 0] > 0.0
    assert bool(feasible.any()) and not bool(feasible.all())
    assert float(builder._eta(tm, tds)) == float(mean[feasible].min())
    assert float(tfun.ExpectedImprovement()._eta(tm, tds)) == float(mean.min())


def test_make_positive_matches_jax_and_keeps_its_base(pair):
    jm, tm, jds, tds = pair
    jbuilder = jfun.MakePositive(jfun.ExpectedImprovement())
    tbuilder = tfun.MakePositive(tfun.ExpectedImprovement())
    jfn = jbuilder.prepare_acquisition_function(jm, jds)
    tfn = tbuilder.prepare_acquisition_function(tm, tds)
    _same(tfn, jfn, _x())
    base = tbuilder._base_fn
    updated = tbuilder.update_acquisition_function(tfn, tm, tds)
    _same(updated, jbuilder.update_acquisition_function(jfn, jm, jds), _x())
    assert tbuilder._base_fn is not base and repr(tbuilder) == "MakePositive(ExpectedImprovement())"


def test_monlcb_builder_matches_jax(pair):
    jm, tm, jds, tds = pair
    jbuilder = jfun.MultipleOptimismNegativeLowerConfidenceBound(JBox([-1.0] * 2, [1.0] * 2))
    tbuilder = tfun.MultipleOptimismNegativeLowerConfidenceBound(
        Box([-1.0] * 2, [1.0] * 2, dtype=F64, device="cpu"))
    jfn = jbuilder.prepare_acquisition_function(jm, jds)
    tfn = tbuilder.prepare_acquisition_function(tm, tds)
    _same(tfn, jfn, _x((3,), 4))
    _same(tbuilder.update_acquisition_function(tfn, tm, tds),
          jbuilder.update_acquisition_function(jfn, jm, jds), _x((3,), 4))
    assert isinstance(tbuilder.using("OBJECTIVE"), VectorizedAcquisitionFunctionBuilder)


@pytest.mark.parametrize("threshold", [0.6, -5.0])  # some observed points feasible; none
def test_expected_constrained_improvement_matches_jax(threshold):
    """Two tagged models: EI of the objective times PoF of the constraint, or PoF alone
    while no observed point is feasible."""
    jobj, tobj = _pair(seed=2)
    jcon, tcon = _pair(seed=2, target=lambda X: X[:, :1] + 0.5 * X[:, 1:])
    jmodels, tmodels = {"OBJECTIVE": jobj, "CONSTRAINT": jcon}, {"OBJECTIVE": tobj, "CONSTRAINT": tcon}
    jdata = {"OBJECTIVE": jobj.get_internal_data(), "CONSTRAINT": jcon.get_internal_data()}
    tdata = {"OBJECTIVE": tobj.dataset, "CONSTRAINT": tcon.dataset}
    jfn = jfun.ExpectedConstrainedImprovement(
        "OBJECTIVE", jfun.ProbabilityOfFeasibility(threshold).using("CONSTRAINT")
    ).prepare_acquisition_function(jmodels, jdata)
    tbuilder = tfun.ExpectedConstrainedImprovement(
        "OBJECTIVE", tfun.ProbabilityOfFeasibility(threshold).using("CONSTRAINT"))
    _same(tbuilder.prepare_acquisition_function(tmodels, tdata), jfn, _x())
    with pytest.raises(ValueError, match="requires a dataset for tag"):
        tbuilder.prepare_acquisition_function(tmodels, {"CONSTRAINT": tdata["CONSTRAINT"]})


# -- combinations -------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["Sum", "Product", "Map"])
def test_combinations_match_jax(pair, name):
    jm, tm, jds, tds = pair
    jparts = (jfun.ExpectedImprovement().using("OBJECTIVE"),
              jfun.NegativeLowerConfidenceBound(0.5).using("OBJECTIVE"))
    tparts = (tfun.ExpectedImprovement().using("OBJECTIVE"),
              tfun.NegativeLowerConfidenceBound(0.5).using("OBJECTIVE"))
    if name == "Map":
        jbuilder = jcomb.Map(lambda v: jnp.exp(-v), jparts[1])
        tbuilder = tcomb.Map(lambda v: torch.exp(-v), tparts[1])
    else:
        jbuilder, tbuilder = getattr(jcomb, name)(*jparts), getattr(tcomb, name)(*tparts)
    jfn = jbuilder.prepare_acquisition_function({"OBJECTIVE": jm}, {"OBJECTIVE": jds})
    tfn = tbuilder.prepare_acquisition_function({"OBJECTIVE": tm}, {"OBJECTIVE": tds})
    _same(tfn, jfn, _x())
    _same(tbuilder.update_acquisition_function(tfn, {"OBJECTIVE": tm}, {"OBJECTIVE": tds}), jfn,
          _x())
    assert len(tbuilder.acquisitions) == len(jbuilder.acquisitions)


def test_reducer_needs_a_builder():
    with pytest.raises(TypeError, match="At least one builder"):
        tcomb.Sum()
    assert repr(tcomb.Product(tfun.ProbabilityOfImprovement().using("A"))).startswith("Product(")


# -- function forms ---------------------------------------------------------------------------


def test_function_forms_match_jax(pair):
    jm, tm, _, _ = pair
    eta = 0.3
    forms = [
        ("expected_improvement", (eta,)),
        ("augmented_expected_improvement", (eta,)),
        ("probability_below_threshold", (eta,)),
        ("lower_confidence_bound", (1.5,)),
    ]
    for name, args in forms:
        _same(getattr(tfl, name)(tm, *args), getattr(jfl, name)(jm, *(jnp.asarray(a) for a in args)),
              _x())
    _same(tfl.multiple_optimism_lower_confidence_bound(tm, 2),
          jfl.multiple_optimism_lower_confidence_bound(jm, 2), _x((4,), 3))


def test_function_forms_match_their_builders(pair):
    """The JAX package's own checks of the forms against the builders, on the port."""
    _, tm, _, tds = pair
    xs = torch.linspace(-1.0, 1.0, 7, dtype=F64)[:, None, None] * torch.ones(1, 1, 2, dtype=F64)
    eta = tfun._min_posterior_mean(tm, tds)
    builder_fn = tfun.ExpectedImprovement().prepare_acquisition_function(tm, tds)
    close = lambda a, b: np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)  # noqa: E731
    close(tfl.expected_improvement(tm, eta)(xs), builder_fn(xs))
    neg = tfun.NegativeLowerConfidenceBound(beta=1.5).prepare_acquisition_function(tm)
    close(tfl.lower_confidence_bound(tm, 1.5)(xs), -neg(xs))
    poi = tfun.ProbabilityOfImprovement().prepare_acquisition_function(tm, tds)
    close(tfl.probability_below_threshold(tm, eta)(xs), poi(xs))
    aei = tfl.augmented_expected_improvement(tm, torch.tensor(0.5, dtype=F64))(xs)
    assert aei.shape == (7, 1) and bool((aei >= 0.0).all())
    assert tfl.multiple_optimism_lower_confidence_bound(tm, 2)(xs.expand(7, 3, 2)).shape == (7, 3)


def test_acquisition_exports_match_jax_names():
    """Every builder of this family is exported under its JAX name."""
    for name in ("ProbabilityOfImprovement", "AugmentedExpectedImprovement",
                 "NegativeLowerConfidenceBound", "NegativePredictiveMean",
                 "ProbabilityOfFeasibility", "ExpectedConstrainedImprovement", "MakePositive",
                 "MultipleOptimismNegativeLowerConfidenceBound", "Sum", "Product", "Map",
                 "Reducer", "LocalPenalization", "Fantasizer", "GIBBON", "MinValueEntropySearch",
                 "PredictiveVariance", "ExpectedFeasibility", "IntegratedVarianceReduction",
                 "BayesianActiveLearningByDisagreement"):
        assert hasattr(tacq, name), name


def _jax_sample(predict, eps, x):
    """Marginal samples ``[..., S, B, L]`` from fixed base draws ``eps [S, 1, 1]``."""
    mean, var = predict(x)
    return mean[..., None, :, :] + jnp.sqrt(var)[..., None, :, :] * eps


def _torch_sample(predict, eps, x):
    mean, var = predict(x)
    return mean[..., None, :, :] + torch.sqrt(var)[..., None, :, :] * eps


def test_sampling_and_batch_function_forms_match_jax(pair):
    """The Monte-Carlo forms over the same sample callable (fixed base draws), the
    analytic qEI over the same QMC points (its Genz CDFs are long sums: rtol 1e-6, as
    ``test_torch_batch_acquisition.py`` holds it), and the penalized product."""
    jm, tm, _, _ = pair
    eta = 0.3
    eps = np.random.default_rng(3).normal(size=(16, 1, 1))
    jsample = Partial(_jax_sample, jpredictor(jm), jnp.asarray(eps))
    tsample = partial(_torch_sample, tm.predict, _t(eps))
    _same(tfl.monte_carlo_expected_improvement(tsample, eta),
          jfl.monte_carlo_expected_improvement(jsample, eta), _x())
    _same(tfl.monte_carlo_augmented_expected_improvement(tsample, tm, eta),
          jfl.monte_carlo_augmented_expected_improvement(jsample, jm, eta), _x())
    _same(tfl.batch_monte_carlo_expected_improvement(tsample, eta),
          jfl.batch_monte_carlo_expected_improvement(jsample, eta), _x((6,), 2))
    qmc = jfutils.make_mvn_cdf(64, dimension=3)
    got = tfl.batch_expected_improvement(tm, eta, _t(qmc))(_t(_x((6,), 2)))
    want = _APPLY(jfl.batch_expected_improvement(jm, jnp.asarray(eta), qmc), jnp.asarray(_x((6,), 2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-10)
    tbase = tfl.expected_improvement(tm, eta)
    tpen = tfl.soft_local_penalizer(tm, _t(_x((2,))[:, 0]), 12.0, eta)
    jbase = jfl.expected_improvement(jm, jnp.asarray(eta))
    jpen = jfl.soft_local_penalizer(jm, jnp.asarray(_x((2,))[:, 0]), jnp.asarray(12.0), jnp.asarray(eta))
    _same(tfl.local_penalizer(tbase, tpen), jfl.local_penalizer(jbase, jpen), _x())

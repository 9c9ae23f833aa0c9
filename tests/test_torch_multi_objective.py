"""The port's multi-objective slice on the CPU, against the JAX package in float64:
dominance, both partitions (cell by cell, in order), the hypervolume, the reference point,
the Sharpe-ratio diverse subset, NSGA-II, the multi-objective problems and their fronts,
EHVI (values and gradients), qEHVI, ECHVI in both branches, HIPPO and qHSRI; then the
slice as a whole: two BO steps of EHVI on VLMOP2 and one HIPPO(2) acquire through
Ask/Tell.

The two packages cannot share random draws. The JAX draws are rebuilt from their keys
(the fronts' Dirichlet and normal draws, each stack member's base normals) or recorded as
the JAX code makes them (seed pools, fit restarts), and fed to the port. Given the same
draws, functions agree at rtol 1e-9 and the slices at atol 1e-6 on the points. A JAX
acquisition function is evaluated compiled whole (``_APPLY``): op by op it compiles every
primitive anew.
"""
from __future__ import annotations

import doctest

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import Partial
from test_torch_model_stacks import member_numbers, stack_pair

from trieste_tpu import ask_tell_optimization as jat
from trieste_tpu import bayesian_optimizer as jbo
from trieste_tpu.acquisition import rule as jrule
from trieste_tpu.acquisition.function import function as jfun
from trieste_tpu.acquisition.function import functional as jfl
from trieste_tpu.acquisition.function import multi_objective as jmo
from trieste_tpu.acquisition.multi_objective import dominance as jdom
from trieste_tpu.acquisition.multi_objective import nsga2 as jnsga2
from trieste_tpu.acquisition.multi_objective import pareto as jpareto
from trieste_tpu.acquisition.multi_objective import partition as jpart
from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models import interfaces as jint
from trieste_tpu.models.gp import builders as jbuilders
from trieste_tpu.models.gp import training as jtrain
from trieste_tpu.models.gp.gpr import GaussianProcessRegression as JGPR
from trieste_tpu.models.gp.posterior import GPRParams as JParams
from trieste_tpu.objectives import multi_objectives as jmobj
from trieste_tpu.objectives import single_objectives as jsobj
from trieste_tpu.objectives import utils as jobj_utils
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu.space import Box as JBox
from trieste_tpu_torch import AskTellOptimizer, BayesianOptimizer, Box, Dataset, convert
from trieste_tpu_torch.acquisition import optimizer as topt
from trieste_tpu_torch.acquisition import rule as trule
from trieste_tpu_torch.acquisition.function import function as tfun
from trieste_tpu_torch.acquisition.function import functional as tfl
from trieste_tpu_torch.acquisition.function import multi_objective as tmo
from trieste_tpu_torch.acquisition.multi_objective import (
    DividedAndConquerNonDominated,
    ExactPartition2dNonDominated,
    Pareto,
    get_reference_point,
    non_dominated,
    non_dominated_mask,
    non_dominated_partition_bounds,
    prepare_default_non_dominated_partition_bounds,
)
from trieste_tpu_torch.acquisition.multi_objective import dominance as tdom
from trieste_tpu_torch.acquisition.multi_objective import nsga2 as tnsga2
from trieste_tpu_torch.acquisition.multi_objective import pareto as tpareto
from trieste_tpu_torch.acquisition.multi_objective import partition as tpart
from trieste_tpu_torch.models import TrainableModelStack
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.models.gp import gpr as tgpr
from trieste_tpu_torch.models.gp import sampler as tsampler
from trieste_tpu_torch.models.gp import training as ttrain
from trieste_tpu_torch.models.gp.gpr import GaussianProcessRegression
from trieste_tpu_torch.objectives import (
    DTLZ1,
    DTLZ2,
    VLMOP2,
    SimpleQuadratic,
    dtlz1,
    dtlz2,
    mk_multi_observer,
    mk_observer,
    vlmop2,
)
from trieste_tpu_torch.objectives import multi_objectives as tmobj
from trieste_tpu_torch.observer import OBJECTIVE

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def quick_jax_compiles():
    """XLA's optimizations off while this module runs: the JAX side compiles each of its
    many small programs once, and compiling dominates its time (the results agree to the
    same tolerances)."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-12)

_APPLY = jax.jit(lambda f, x: f(x))
"""A JAX acquisition function at ``x``, compiled whole; a ``Partial`` is an argument, so
functions of one structure and shape compile once."""

_GRAD = jax.jit(jax.grad(lambda f, x: jnp.sum(f(x)), argnums=1))


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _close(got, want, tol=TOL):
    assert tuple(got.shape) == tuple(np.shape(want)), (got.shape, np.shape(want))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _cloud(n, M, seed):
    """``n`` objective vectors in ``M`` dimensions with dominated rows, ties and repeats."""
    rng = np.random.default_rng(seed)
    obs = rng.uniform(size=(n, M))
    obs[1] = obs[0]  # a repeated point
    obs[2, 0] = obs[3, 0]  # a tie in one objective
    return obs


# -- dominance, partitions, hypervolume --------------------------------------------------------


@pytest.mark.parametrize("M", [2, 3])
def test_non_dominated_matches_jax(M):
    obs = _cloud(40, M, seed=M)
    front, mask = non_dominated(_t(obs))
    jfront, jmask = jdom.non_dominated(jnp.asarray(obs))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    _close(front, jfront)
    assert 0 < int(mask.sum()) < 40 and bool(non_dominated_mask(_t(obs))[0]) == bool(mask[1])


def _same_cells(got, want):
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("M", [2, 3])
def test_partitions_match_jax_cell_by_cell(M):
    obs = _cloud(25, M, seed=10 + M)
    front = np.asarray(jdom.non_dominated(jnp.asarray(obs))[0])
    ref = obs.max(0) + 0.3
    anti = obs.min(0) - 0.2
    _same_cells(non_dominated_partition_bounds(_t(ref), _t(front)),
                jpart.non_dominated_partition_bounds(ref, front))
    _same_cells(non_dominated_partition_bounds(_t(ref), _t(front), _t(anti)),
                jpart.non_dominated_partition_bounds(ref, front, anti))
    _same_cells(DividedAndConquerNonDominated(_t(front)).partition_bounds(_t(anti), _t(ref)),
                jpart.DividedAndConquerNonDominated(front).partition_bounds(anti, ref))
    _same_cells(prepare_default_non_dominated_partition_bounds(_t(ref), _t(obs)),
                jpart.prepare_default_non_dominated_partition_bounds(jnp.asarray(ref), obs))
    _same_cells(prepare_default_non_dominated_partition_bounds(_t(ref), _t(obs), _t(anti)),
                jpart.prepare_default_non_dominated_partition_bounds(
                    jnp.asarray(ref), obs, jnp.asarray(anti)))
    _same_cells(prepare_default_non_dominated_partition_bounds(_t(ref)),
                jpart.prepare_default_non_dominated_partition_bounds(jnp.asarray(ref)))
    if M == 2:
        _same_cells(ExactPartition2dNonDominated(_t(front)).partition_bounds(_t(anti), _t(ref)),
                    jpart.ExactPartition2dNonDominated(front).partition_bounds(anti, ref))
        with pytest.raises(ValueError, match="2 objectives"):
            ExactPartition2dNonDominated(torch.zeros(3, 3))
    with pytest.raises(ValueError, match="dominate every front point"):
        non_dominated_partition_bounds(_t(obs.min(0)), _t(front))


def test_partition_bounds_take_the_fronts_device_and_dtype():
    front = torch.tensor([[0.2, 0.6], [0.5, 0.1]], dtype=torch.float32)
    lower, upper = prepare_default_non_dominated_partition_bounds(torch.tensor([1.0, 1.0]), front)
    assert lower.dtype == upper.dtype == torch.float32
    assert lower.shape == upper.shape == (3, 2) and bool(torch.isinf(lower[:, 1]).all())


@pytest.mark.parametrize("M", [2, 3])
def test_hypervolume_and_reference_point_match_jax(M):
    obs = _cloud(30, M, seed=20 + M)
    ref = get_reference_point(_t(obs))
    jref = jpareto.get_reference_point(jnp.asarray(obs))
    _close(ref, jref)
    hv = Pareto(_t(obs)).hypervolume_indicator(ref)
    _close(hv, jpareto.Pareto(jnp.asarray(obs)).hypervolume_indicator(jref))
    # a Monte-Carlo estimate of the same volume, to a few hundredths
    lo = obs.min(0)
    u = lo + np.random.default_rng(0).uniform(size=(100_000, M)) * (ref.numpy() - lo)
    dominated = np.any(np.all(obs[None] <= u[:, None], axis=-1), axis=-1)
    box = np.prod(ref.numpy() - lo)
    assert abs(dominated.mean() * box - float(hv)) < 0.02 * box


def test_hypervolume_of_a_square_and_its_errors():
    obs = torch.tensor([[0.0, 2.0], [1.0, 1.0], [2.0, 0.0], [2.0, 2.0]], dtype=F64)
    assert float(Pareto(obs).hypervolume_indicator(torch.tensor([3.0, 3.0], dtype=F64))) == 6.0
    one = Pareto(torch.tensor([[1.0, 1.0]], dtype=F64))
    assert float(one.hypervolume_indicator(torch.tensor([2.0, 3.0], dtype=F64))) == 2.0
    with pytest.raises(ValueError, match="dominate the whole front"):
        Pareto(obs).hypervolume_indicator(torch.tensor([1.0, 3.0], dtype=F64))
    with pytest.raises(ValueError, match="empty"):
        get_reference_point(torch.zeros(0, 2))


def _arc(n, seed):
    """``n`` points near a quarter circle: most of them are on the front."""
    rng = np.random.default_rng(seed)
    angle = rng.uniform(0.0, 0.5 * np.pi, size=n)
    radius = 1.0 + 0.05 * rng.uniform(size=n)
    return np.stack([radius * np.cos(angle), radius * np.sin(angle)], -1)


@pytest.mark.parametrize("sample_size, allow_repeats", [(3, True), (7, True), (4, False)])
def test_sample_diverse_subset_matches_jax(sample_size, allow_repeats):
    obs = _arc(30, seed=31)
    samples, counts = Pareto(_t(obs)).sample_diverse_subset(sample_size, allow_repeats)
    jsamples, jcounts = jpareto.Pareto(jnp.asarray(obs)).sample_diverse_subset(
        sample_size, allow_repeats)
    assert len(counts) > 10  # a front of many points
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    _close(samples, jsamples)
    assert int(counts.sum()) == sample_size and (allow_repeats or int(counts.max()) == 1)
    with pytest.raises(ValueError, match="distinct points"):
        Pareto(_t(obs[:2])).sample_diverse_subset(3, allow_repeats=False)


def test_sharpe_weights_are_on_the_simplex():
    """The weights are a point of the simplex. (How far they are from the largest Sharpe
    ratio is the JAX package's algorithm: its projection is a clip and a rescale.)"""
    front = Pareto(_t(_arc(30, seed=32))).front.numpy()
    lower, upper = front.min(0) - 0.1, front.max(0) + 0.1
    p = np.prod((upper - front) / (upper - lower), -1)
    both = np.maximum(front[:, None], front[None])
    Q = np.prod((upper - both) / (upper - lower), -1) - np.outer(p, p) + 1e-9 * np.eye(len(p))
    w = tpareto._sharpe_weights(_t(Q), _t(p)).numpy()
    assert np.all(w >= 0.0) and abs(w.sum() - 1.0) < 1e-12


def test_nsga2_matches_jax_exactly():
    def objective(x):
        return np.stack([np.sum((x - 0.2) ** 2, -1), np.sum((x - 0.7) ** 2, -1)], -1)

    lower, upper = np.zeros(3), np.ones(3)
    got = tnsga2.nsga2(objective, lower, upper, population_size=24, num_generations=6)
    want = jnsga2.nsga2(objective, lower, upper, population_size=24, num_generations=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    again = tnsga2.nsga2(objective, lower, upper, population_size=24, num_generations=6)
    np.testing.assert_array_equal(again[0], got[0])  # the default generator is seeded
    assert np.all(tnsga2._fast_non_dominated_ranks(got[1]) == 0)


# -- the problems ------------------------------------------------------------------------------


def test_multi_objective_problems_match_jax():
    x2 = np.random.default_rng(40).uniform(-2.0, 2.0, size=(7, 2))
    x6 = np.random.default_rng(41).uniform(size=(7, 6))
    _close(vlmop2(_t(x2)), jax.jit(jmobj.vlmop2)(jnp.asarray(x2)))
    for M in (2, 3):
        _close(dtlz1(_t(x6), M), jax.jit(jmobj.dtlz1, static_argnums=1)(jnp.asarray(x6), M))
        _close(dtlz2(_t(x6), M), jax.jit(jmobj.dtlz2, static_argnums=1)(jnp.asarray(x6), M))
        _close(DTLZ2(6, M).objective(_t(x6)), jax.jit(jmobj.DTLZ2(6, M).objective)(jnp.asarray(x6)))
    assert DTLZ1(6, 3).name == "DTLZ1(6, 3)" and DTLZ2(6, 2).search_space.dimension == 6
    with pytest.raises(ValueError, match="input_dim > num_objectives"):
        DTLZ2(2, 2)
    x = np.random.default_rng(42).uniform(size=(5, 2))
    _close(SimpleQuadratic.objective(_t(x)), jsobj.SimpleQuadratic.objective(jnp.asarray(x)))
    np.testing.assert_array_equal(SimpleQuadratic.minimum, jsobj.SimpleQuadratic.minimum)
    np.testing.assert_array_equal(SimpleQuadratic.minimizers, jsobj.SimpleQuadratic.minimizers)
    _close(SimpleQuadratic.objective(_t(SimpleQuadratic.minimizers)), [[-2.0]])


@pytest.fixture
def float64_default():
    """torch's default float dtype set to float64 for the test (the problems' fronts are
    made in it)."""
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    yield
    torch.set_default_dtype(dtype)


def test_pareto_fronts_match_jax_given_its_draws(monkeypatch, float64_default):
    key = jax.random.PRNGKey(43)
    gen = torch.Generator().manual_seed(0)
    def jax_front(problem):  # compiled whole
        return jax.jit(problem.gen_pareto_optimal_points, static_argnums=0)(9, key)

    _close(VLMOP2.gen_pareto_optimal_points(9, gen), jax_front(jmobj.VLMOP2))
    w = _t(jax.jit(lambda k: jax.random.dirichlet(k, jnp.ones(3), (9,)))(key))
    monkeypatch.setattr(tmobj, "dirichlet_ones", lambda generator, n, M, like: w)
    _close(DTLZ1(5, 3).gen_pareto_optimal_points(9, gen), jax_front(jmobj.DTLZ1(5, 3)))
    z = _t(jax.random.normal(key, (9, 3)))
    monkeypatch.setattr(tmobj, "standard_normal", lambda generator, shape, like: z)
    _close(DTLZ2(5, 3).gen_pareto_optimal_points(9, gen), jax_front(jmobj.DTLZ2(5, 3)))


def test_front_draws_lie_on_the_fronts(float64_default):
    gen = torch.Generator().manual_seed(1)
    w = DTLZ1(5, 3).gen_pareto_optimal_points(50, gen)
    z = DTLZ2(5, 3).gen_pareto_optimal_points(50, gen)
    assert w.dtype == F64 and w.device.type == "cpu"
    torch.testing.assert_close(w.sum(-1), torch.full((50,), 0.5, dtype=F64))
    torch.testing.assert_close(torch.linalg.vector_norm(z, dim=-1), torch.ones(50, dtype=F64))
    assert bool((w > 0).all()) and bool((z >= 0).all())
    # the DTLZ2 front is DTLZ2 at g = 0: x_j = 0.5 for the distance variables
    angles = torch.tensor([[0.3], [0.8]], dtype=F64)
    x = torch.cat([angles, torch.full((2, 4), 0.5, dtype=F64)], -1)
    torch.testing.assert_close(torch.linalg.vector_norm(dtlz2(x, 2), dim=-1),
                               torch.ones(2, dtype=F64))


def test_mk_multi_observer_matches_jax():
    x = np.random.default_rng(44).uniform(size=(4, 2))
    observer = mk_multi_observer(A=lambda q: q[:, :1] ** 2, B=lambda q: q.sum(-1, keepdims=True))
    jobserver = jobj_utils.mk_multi_observer(A=lambda q: q[:, :1] ** 2,
                                             B=lambda q: q.sum(-1, keepdims=True))
    got, want = observer(_t(x)), jobserver(jnp.asarray(x))
    assert list(got) == list(want) == ["A", "B"]
    for tag in got:
        _close(got[tag].trimmed_observations, want[tag].trimmed_observations)


# -- EHVI, qEHVI, ECHVI, HIPPO -------------------------------------------------------------------


@pytest.fixture(scope="module")
def stacks():
    """A two-member stack in both packages, its datasets, and queries ``[12, 1, 2]``."""
    jstack, tstack = stack_pair()
    X = np.asarray(jstack.models[0].get_internal_data().trimmed_query_points)
    Y = np.concatenate([np.asarray(m.get_internal_data().trimmed_observations)
                        for m in jstack.models], -1)
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y))
    tds = Dataset.from_arrays(_t(X), _t(Y))
    return jstack, tstack, jds, tds


def _x(lead=(12,), seed=1):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=lead + (1, 2))


def test_psi_minus_diff_matches_jax_with_infinite_lower_bounds():
    rng = np.random.default_rng(50)
    mean, std = rng.normal(size=(6, 1, 2)), rng.uniform(0.1, 1.0, size=(6, 1, 2))
    lower = np.array([[-np.inf, -np.inf], [0.1, -np.inf], [-0.3, 0.2]])
    upper = np.array([[0.1, 1.5], [0.6, 0.2], [0.9, 1.0]])
    _close(tmo._psi_minus_diff(_t(mean), _t(std), _t(lower), _t(upper)),
           jax.jit(jmo._psi_minus_diff)(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(lower),
                                        jnp.asarray(upper)))


def test_ehvi_matches_jax_in_values_and_gradients(stacks):
    jstack, tstack, jds, tds = stacks
    jfn = jmo.ExpectedHypervolumeImprovement().prepare_acquisition_function(jstack, jds)
    fn = tmo.ExpectedHypervolumeImprovement().prepare_acquisition_function(tstack, tds)
    assert bool(torch.isinf(fn.args[1]).any())  # a cell unbounded below
    x = _x()
    _close(fn(_t(x)), _APPLY(jfn, jnp.asarray(x)))
    q = _t(x).requires_grad_(True)
    (grad,) = torch.autograd.grad(fn(q).sum(), q)
    assert bool(torch.isfinite(grad).all())
    _close(grad, _GRAD(jfn, jnp.asarray(x)), dict(rtol=1e-8, atol=1e-12))
    assert float(fn(_t(x)).min()) >= 0.0
    # the function form over the same cells
    _close(tfl.expected_hv_improvement(tstack, fn.args[1:])(_t(x)),
           _APPLY(jfl.expected_hv_improvement(jstack, jfn.args[1:]), jnp.asarray(x)))
    with pytest.raises(ValueError, match="non-empty dataset"):
        tmo.ExpectedHypervolumeImprovement().prepare_acquisition_function(tstack, None)


def test_ehvi_gradient_is_finite_in_a_cell_unbounded_below():
    """A query whose mean lies deep in the one cell with ``-inf`` lower bounds: the
    discarded branch of ``psi(l)`` is evaluated at a finite stand-in."""
    mean = torch.tensor([[-5.0, -4.0]], dtype=F64, requires_grad=True)
    var = torch.tensor([[0.3, 0.2]], dtype=F64, requires_grad=True)
    lower = torch.tensor([[-torch.inf, -torch.inf]], dtype=F64)
    upper = torch.tensor([[1.0, 1.0]], dtype=F64)
    value = tmo._ehvi_fn(lambda x: (mean, var), lower, upper, torch.zeros(1, 1, 2, dtype=F64))
    value.sum().backward()
    assert torch.isfinite(mean.grad).all() and torch.isfinite(var.grad).all()
    # far below the cell the improvement is (u - mean) in each objective
    torch.testing.assert_close(value, torch.tensor([[6.0 * 5.0]], dtype=F64), rtol=1e-9, atol=0)


def test_subset_masks_follow_itertools_product():
    masks = tmo._subset_masks(3)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmo._subset_masks(3)))
    assert masks.shape == (7, 3) and masks[0].tolist() == [False, False, True]


def test_batch_ehvi_matches_jax_given_its_samples(stacks, monkeypatch):
    """qEHVI over batches of two: the JAX stack splits its key per member, and each
    member draws ``[1, B, S]`` normals (sampler.py, ``pure_batch_reparam_sample``)."""
    jstack, tstack, jds, tds = stacks
    key, S, B = jax.random.PRNGKey(51), 16, 2
    jfn = jmo.BatchMonteCarloExpectedHypervolumeImprovement(S, key=key).prepare_acquisition_function(
        jstack, jds)
    draws = [_t(jax.random.normal(k, (1, B, S), dtype=jnp.float64))
             for k in jax.random.split(key, 2)]
    monkeypatch.setattr(tsampler, "standard_normal", lambda generator, shape, like: draws.pop(0))
    builder = tmo.BatchMonteCarloExpectedHypervolumeImprovement(S)
    fn = builder.prepare_acquisition_function(tstack, tds)
    x = np.random.default_rng(52).uniform(-1.0, 1.0, size=(5, B, 2))
    jfn = jfn._partial_for(B)  # compiled whole
    _close(fn(_t(x)), _APPLY(jfn, jnp.asarray(x)))
    assert not draws
    _close(fn(_t(x[:2])), _APPLY(jfn, jnp.asarray(x[:2])))  # frozen draws
    assert repr(builder) == "BatchMonteCarloExpectedHypervolumeImprovement(16)"
    # the function form, on the prepared function's sampler and cells
    form = tfl.batch_ehvi(fn._sample, 1e-6, (fn._lower, fn._upper))
    _close(form(_t(x)), fn(_t(x)))


def test_batch_ehvi_of_one_point_tends_to_ehvi(stacks):
    _, tstack, _, tds = stacks
    x = np.random.default_rng(52).uniform(-1.0, 1.0, size=(3, 1, 2))
    big = tmo.BatchMonteCarloExpectedHypervolumeImprovement(20_000).prepare_acquisition_function(
        tstack, tds)
    ehvi = tmo.ExpectedHypervolumeImprovement().prepare_acquisition_function(tstack, tds)
    np.testing.assert_allclose(big(_t(x)).numpy(), ehvi(_t(x)).numpy(), rtol=0.05, atol=1e-3)


def test_batch_ehvi_of_a_batch_is_the_union_not_the_sum():
    """Two identical points improve no more than one."""
    lower = torch.tensor([[-torch.inf, -torch.inf]], dtype=F64)
    upper = torch.tensor([[1.0, 1.0]], dtype=F64)
    sample = lambda x: torch.zeros(x.shape[:-2] + (1, x.shape[-2], 2), dtype=F64)  # noqa: E731
    one = tmo._batch_ehvi_fn(sample, lower, upper, tmo._subset_masks(1), torch.zeros(1, 1, 2))
    two = tmo._batch_ehvi_fn(sample, lower, upper, tmo._subset_masks(2), torch.zeros(1, 2, 2))
    torch.testing.assert_close(one, two)
    torch.testing.assert_close(one, torch.ones(1, 1, dtype=F64))


@pytest.fixture(scope="module")
def constrained():
    """The stack under OBJECTIVE and a one-output GP of a constraint under CONSTRAINT."""
    jstack, tstack = stack_pair()
    X = np.asarray(jstack.models[0].get_internal_data().trimmed_query_points)
    Y = np.concatenate([np.asarray(m.get_internal_data().trimmed_observations)
                        for m in jstack.models], -1)
    C = X[:, :1] + 0.2 * X[:, 1:]
    jc = JGPR(JParams(jstationary("matern52", 0.5, [0.7, 0.7], dtype=jnp.float64),
                      jnp.asarray(1e-3), jnp.asarray(0.0)),
              JDataset.from_arrays(jnp.asarray(X), jnp.asarray(C)))
    tc = GaussianProcessRegression(
        convert.gpr_params_from_numpy("matern52", 0.5, [0.7, 0.7], 1e-3, 0.0, device="cpu",
                                      dtype=F64),
        Dataset.from_arrays(_t(X), _t(C)))
    jmodels, tmodels = {OBJECTIVE: jstack, "CONSTRAINT": jc}, {OBJECTIVE: tstack, "CONSTRAINT": tc}
    jdata = {OBJECTIVE: JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y)),
             "CONSTRAINT": jc.get_internal_data()}
    tdata = {OBJECTIVE: Dataset.from_arrays(_t(X), _t(Y)), "CONSTRAINT": tc.dataset}
    return jmodels, tmodels, jdata, tdata


@pytest.mark.parametrize("threshold, feasible", [(0.0, True), (-5.0, False)])
def test_echvi_matches_jax_in_both_branches(constrained, threshold, feasible):
    jmodels, tmodels, jdata, tdata = constrained
    jfn = jmo.ExpectedConstrainedHypervolumeImprovement(
        OBJECTIVE, jfun.ProbabilityOfFeasibility(threshold).using("CONSTRAINT")
    ).prepare_acquisition_function(jmodels, jdata)
    builder = tmo.ExpectedConstrainedHypervolumeImprovement(
        OBJECTIVE, tfun.ProbabilityOfFeasibility(threshold).using("CONSTRAINT"))
    fn = builder.prepare_acquisition_function(tmodels, tdata)
    assert (fn.func is tfun._product_fn) is feasible  # else the feasibility alone
    x = _x(seed=53)
    _close(fn(_t(x)), _APPLY(jfn, jnp.asarray(x)))
    with pytest.raises(ValueError, match="requires a dataset"):
        builder.prepare_acquisition_function(tmodels, {"CONSTRAINT": tdata["CONSTRAINT"]})


PENDING = np.array([[0.5, -0.5], [-0.2, 0.6]])


def test_hippo_matches_jax_with_and_without_pending_points(stacks):
    jstack, tstack, jds, tds = stacks
    x = _x(seed=54)
    jpenalty = Partial(jmo._hippo_penalty_fn, jmo.HIPPO()._member_states(jstack),
                       jnp.asarray(PENDING))
    penalty = tfl.hippo_penalizer(tstack, _t(PENDING))
    _close(penalty(_t(x)), _APPLY(jpenalty, jnp.asarray(x)))
    _close(penalty(_t(x)), _APPLY(jfl.hippo_penalizer(jstack, jnp.asarray(PENDING)), jnp.asarray(x)))
    assert bool(((penalty(_t(x)) >= 0) & (penalty(_t(x)) <= 1)).all())
    assert float(penalty(_t(PENDING[:1, None]))) < 1e-6  # a pending point is fully penalized
    builder, jbuilder = tmo.HIPPO(), jmo.HIPPO()
    base = builder.prepare_acquisition_function(tstack, tds)
    _close(base(_t(x)), _APPLY(jbuilder.prepare_acquisition_function(jstack, jds), jnp.asarray(x)))
    fn = builder.update_acquisition_function(base, tstack, tds, _t(PENDING),
                                             new_optimization_step=False)
    jfn = jbuilder.update_acquisition_function(None, jstack, jds, jnp.asarray(PENDING))
    _close(fn(_t(x)), _APPLY(jfn, jnp.asarray(x)))
    q = _t(x).requires_grad_(True)
    (grad,) = torch.autograd.grad(fn(q).sum(), q)
    _close(grad, _GRAD(jfn, jnp.asarray(x)), dict(rtol=1e-8, atol=1e-12))
    assert repr(builder) == "HIPPO('OBJECTIVE', ExpectedHypervolumeImprovement())"
    predict_only = TrainableModelStack(*[(_PredictOnly(m), 1) for m in tstack.models])
    with pytest.raises(NotImplementedError, match="exact-GP members"):
        tmo.HIPPO().prepare_acquisition_function(predict_only, tds, _t(PENDING))


class _PredictOnly:
    def __init__(self, model):
        self.predict = model.predict


# -- qHSRI ---------------------------------------------------------------------------------------


def test_qhsri_matches_jax_with_the_same_model():
    """The same float64 GP on SimpleQuadratic data in both packages: NSGA-II's
    deterministic generator, the filter and the diverse subset give the same points."""
    X = np.random.default_rng(60).uniform(size=(8, 2))
    Y = np.asarray(jsobj.SimpleQuadratic.objective(X))
    jm = JGPR(JParams(jstationary("matern52", 0.6, [0.4, 0.4], dtype=jnp.float64),
                      jnp.asarray(1e-5), jnp.asarray(-0.8)),
              JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y)))
    tm = GaussianProcessRegression(
        convert.gpr_params_from_numpy("matern52", 0.6, [0.4, 0.4], 1e-5, -0.8, device="cpu",
                                      dtype=F64),
        Dataset.from_arrays(_t(X), _t(Y)))
    rule = trule.BatchHypervolumeSharpeRatioIndicator(3, ga_population_size=20, ga_n_generations=5)
    jrule_ = jrule.BatchHypervolumeSharpeRatioIndicator(3, ga_population_size=20,
                                                        ga_n_generations=5)
    space = Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu")
    got = rule.acquire_single(space, tm, tm.dataset)
    want = jrule_.acquire_single(JBox([0.0, 0.0], [1.0, 1.0]), jm, jm.get_internal_data())
    assert got.shape == (3, 2) and got.dtype == F64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    with pytest.raises(ValueError, match="single key"):
        rule.acquire(space, {"A": tm}, {"A": tm.dataset})
    with pytest.raises(ValueError, match="non-empty objective dataset"):
        rule.acquire(space, {OBJECTIVE: tm}, None)
    with pytest.raises(ValueError, match="filter_threshold"):
        trule.BatchHypervolumeSharpeRatioIndicator(filter_threshold=1.0)
    with pytest.raises(ValueError, match="num_query_points"):
        trule.BatchHypervolumeSharpeRatioIndicator(0)


# -- the slice as a whole ----------------------------------------------------------------------


_RANDOMIZE_STARTS = jax.jit(jtrain.randomize_starts, static_argnums=(2, 3))


@pytest.fixture
def jax_draws(monkeypatch):
    """Record the JAX package's seed pools (a box's uniforms) and fit restarts as it makes
    them, and make the port replay them: its box samples scale the uniforms, its fits start
    from the restarts. Returns the two queues."""
    pools, restarts = [], []
    sample, optimize = JBox.sample, JGPR.optimize

    def record_pool(self, key, n):
        pools.append(np.asarray(jax.random.uniform(key, (n, self.dimension), dtype=jnp.float64)))
        return sample(self, key, n)

    def record_fit(self, dataset):
        sub = jax.random.split(self._key)[1]
        restarts.append(np.asarray(_RANDOMIZE_STARTS(
            sub, self.params, self._num_kernel_samples, self._train_noise, priors=self._priors)))
        return optimize(self, dataset)

    def replay_pool(self, generator, n):
        u = pools.pop(0)
        assert u.shape == (n, self.dimension)
        return self._scale(_t(u))

    def replay_fit(generator, params, X, Y, mask, *, num_starts, train_noise, max_iters, priors,
                pool_sharding):
        return ttrain.fit_gpr_from_starts(_t(restarts.pop(0)), params, X, Y, mask,
                                          train_noise=train_noise, max_iters=max_iters,
                                          priors=priors,
                                          pool_sharding=pool_sharding)

    monkeypatch.setattr(JBox, "sample", record_pool)
    monkeypatch.setattr(JGPR, "optimize", record_fit)
    monkeypatch.setattr(Box, "sample", replay_pool)
    monkeypatch.setattr(tgpr, "fit_gpr", replay_fit)
    return pools, restarts


def _vlmop2_stacks(n=9, seed=61):
    """VLMOP2's reference setup in both packages at a small size: two ``build_gpr``
    members at a likelihood variance of 1e-5, three fit restarts each."""
    X = np.random.default_rng(seed).uniform(-2.0, 2.0, size=(n, 2))
    Y = np.asarray(jmobj.vlmop2(jnp.asarray(X)))
    jspace = JBox([-2.0, -2.0], [2.0, 2.0])
    tspace = Box([-2.0, -2.0], [2.0, 2.0], dtype=F64, device="cpu")

    def members(make, space, data, cut):
        return [(make(cut(data, i), space), 1) for i in range(2)]

    jstack = jint.TrainableModelStack(*members(
        lambda d, s: jbuilders.build_gpr(d, s, likelihood_variance=1e-5, num_kernel_samples=3),
        jspace, (X, Y), lambda d, i: JDataset.from_arrays(jnp.asarray(d[0]),
                                                          jnp.asarray(d[1][:, i:i + 1]))))
    tstack = TrainableModelStack(*members(
        lambda d, s: build_gpr(d, s, likelihood_variance=1e-5, num_kernel_samples=3),
        tspace, (X, Y), lambda d, i: Dataset.from_arrays(_t(d[0]), _t(d[1][:, i:i + 1]))))
    return (jspace, JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y)), jstack), (
        tspace, Dataset.from_arrays(_t(X), _t(Y)), tstack)


N_SEEDS = 512


def _jax_random_search(space, f, key):
    """The JAX package's random-search optimizer with the pool's scores compiled whole.
    The slices maximize by random search: the JAX package compiles its L-BFGS optimizer
    anew for every set of cells (5 s each here); the continuous optimizer's parity is held
    in ``test_torch_bo.py`` and ``test_torch_repairs.py``."""
    seeds = space.sample(key, N_SEEDS)[:, None, :]
    return seeds[jnp.argmax(_APPLY(f, seeds)[:, 0])]


def test_two_ehvi_steps_on_vlmop2_match_jax(jax_draws):
    """Two BO steps of EHVI through ``BayesianOptimizer.optimize``, every fit and seed
    pool of the JAX run replayed in the port's."""
    pools, restarts = jax_draws
    (jspace, jds, jstack), (tspace, tds, tstack) = _vlmop2_stacks()
    jresult = jbo.BayesianOptimizer(jobj_utils.mk_observer(jmobj.vlmop2), jspace).optimize(
        2, jds, jstack, jrule.EfficientGlobalOptimization(
            jmo.ExpectedHypervolumeImprovement().using(OBJECTIVE), _jax_random_search),
        key=jax.random.PRNGKey(62), track_state=False)
    assert len(pools) == 2 and len(restarts) == 6  # two members fitted three times
    result = BayesianOptimizer(mk_observer(vlmop2), tspace).optimize(
        2, tds, tstack, trule.EfficientGlobalOptimization(
            tmo.ExpectedHypervolumeImprovement().using(OBJECTIVE),
            topt.generate_random_search_optimizer(N_SEEDS)),
        track_state=False)
    assert not pools and not restarts
    want = jresult.final_result.unwrap().datasets[OBJECTIVE]
    got = result.final_result.unwrap().datasets[OBJECTIVE]
    assert len(got) == 11 and got.capacity == 16
    np.testing.assert_allclose(got.trimmed_query_points[9:].numpy(),
                               np.asarray(want.trimmed_query_points[9:]), atol=1e-6)
    for jm, tm in zip(jstack.models, tstack.models):
        np.testing.assert_allclose(tm.params.kernel.lengthscales.numpy(),
                                   np.asarray(jm.params.kernel.lengthscales), rtol=1e-6)


def test_a_hippo_batch_through_ask_tell_matches_jax(jax_draws):
    """One HIPPO(2) ask: the fit at construction, then the first point by EHVI and the
    second by EHVI times the penalty around the first."""
    pools, restarts = jax_draws
    (jspace, jds, jstack), (tspace, tds, tstack) = _vlmop2_stacks()
    jopt = jat.AskTellOptimizer(jspace, jds, jstack, jrule.EfficientGlobalOptimization(
        jmo.HIPPO(), _jax_random_search, num_query_points=2), key=jax.random.PRNGKey(64))
    want = np.asarray(jopt.ask())
    assert len(pools) == 2 and len(restarts) == 2
    topt_ = AskTellOptimizer(tspace, tds, tstack, trule.EfficientGlobalOptimization(
        tmo.HIPPO(), topt.generate_random_search_optimizer(N_SEEDS), num_query_points=2))
    got = topt_.ask()
    assert not pools and not restarts and got.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert float(torch.linalg.vector_norm(got[0] - got[1])) > 1e-2


# -- the docstrings' examples ----------------------------------------------------------------------


@pytest.mark.parametrize("module", [tdom, tpart, tpareto, tmobj], ids=lambda m: m.__name__)
def test_docstring_examples(module):
    assert doctest.testmod(module, raise_on_error=True).attempted > 0


def test_model_stack_from_numpy_builds_each_stack_type(stacks):
    jstack, tstack, _, _ = stacks
    for stack_type in (convert.ModelStack, TrainableModelStack):
        stack = convert.model_stack_from_numpy(
            [(*member_numbers(m), 1) for m in jstack.models], stack_type=stack_type,
            device="cpu", dtype=F64, num_kernel_samples=4)
        assert type(stack) is stack_type and stack.models[0]._num_kernel_samples == 4
        _close(stack.predict(_t(_x()))[0], tstack.predict(_t(_x()))[0])


def test_the_smokes_vlmop2_designs_are_the_jax_tests():
    """``chip_smoke.VLMOP2_DESIGNS`` are the initial designs of the JAX package's VLMOP2
    test for seeds 0 to 4 (``_run_vlmop2``), drawn in float32."""
    from chip_smoke import VLMOP2_DESIGNS

    lower, upper = jnp.full(2, -2.0, jnp.float32), jnp.full(2, 2.0, jnp.float32)
    for seed, design in enumerate(VLMOP2_DESIGNS):
        k_init, _ = jax.random.split(jax.random.PRNGKey(seed))
        u = jax.random.uniform(k_init, (10, 2), dtype=jnp.float32)
        want = np.asarray(lower + u * (upper - lower))
        np.testing.assert_array_equal(np.asarray(design, dtype=np.float32).reshape(10, 2), want)

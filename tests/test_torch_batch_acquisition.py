"""The port's Monte-Carlo and batch acquisition functions, the Genz MVN CDF, continuous
Thompson sampling and the batch optimizers on the CPU, against the JAX package in float64.

The JAX builders regenerate their base draws from a fixed key at every call; the tests
rebuild those draws and hand them to the port in place of its own (``standard_normal`` of
the sampler module). Tolerances: rtol 1e-9 / atol 1e-10 given the same draws; rtol 1e-6 for
``mvn_cdf`` and the analytic qEI (long sums) and for their gradients against ``jax.grad``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch
from jax.tree_util import Partial

from trieste_tpu.acquisition import optimizer as jopt
from trieste_tpu.acquisition import utils as jutils
from trieste_tpu.acquisition.function import function as jfun
from trieste_tpu.acquisition.function import utils as jfutils
from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models.gp import posterior as jpost
from trieste_tpu.models.gp import sampler as jsam
from trieste_tpu.models.gp.gpr import GaussianProcessRegression as JGPR
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu_torch import Box, Dataset, convert
from trieste_tpu_torch.acquisition import optimizer as topt
from trieste_tpu_torch.acquisition import utils as tutils
from trieste_tpu_torch.acquisition.function import continuous_thompson_sampling as tcts
from trieste_tpu_torch.acquisition.function import function as tfun
from trieste_tpu_torch.acquisition.function import utils as tfutils
from trieste_tpu_torch.acquisition.interface import (
    GreedyAcquisitionFunctionBuilder,
    VectorizedAcquisitionFunctionBuilder,
)
from trieste_tpu_torch.models.gp import sampler as tsam
from trieste_tpu_torch.models.gp.gpr import GaussianProcessRegression

torch.set_num_threads(1)

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-10)
LONG_SUMS = dict(rtol=1e-6, atol=1e-10)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _models(n=9, seed=0, noise=1e-2):
    """The same 2-D GPR over a quadratic in both packages, float64."""
    X = np.random.default_rng(seed).uniform(-1.0, 1.0, size=(n, 2))
    Y = np.sum(X**2, -1, keepdims=True)
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y))
    jmodel = JGPR(jpost.GPRParams(jstationary("matern52", 1.1, [0.6, 0.8], dtype=jnp.float64),
                                  jnp.asarray(noise), jnp.asarray(0.3)), jds)
    tds = Dataset.from_arrays(_t(X), _t(Y))
    tmodel = GaussianProcessRegression(
        convert.gpr_params_from_numpy("matern52", 1.1, [0.6, 0.8], noise, 0.3, device="cpu", dtype=F64),
        tds,
    )
    return (jmodel, jds), (tmodel, tds)


def _assert_values_and_grads(tacq, jacq, x, tol):
    np.testing.assert_allclose(tacq(_t(x)).numpy(), jacq(jnp.asarray(x)), **tol)
    jg = jax.grad(lambda q: jnp.sum(jacq(q)))(jnp.asarray(x))
    q = _t(x).requires_grad_(True)
    (tg,) = torch.autograd.grad(tacq(q).sum(), q)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=max(tol["rtol"], 1e-8), atol=1e-10)


# -- the multivariate-normal CDF ------------------------------------------------------


def _mvn_inputs(lead, Q, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=lead + (Q, Q))
    cov = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(Q)
    return rng.normal(size=lead + (Q,)), 0.3 * rng.normal(size=lead + (Q,)), cov


@pytest.mark.parametrize("lead, Q", [((), 2), ((5,), 3), ((2, 3), 4), ((4,), 1)])
def test_mvn_cdf_matches_jax(lead, Q):
    x, mean, cov = _mvn_inputs(lead, Q)
    qmc = jfutils.make_mvn_cdf(64, Q)
    tq = tfutils.make_mvn_cdf(64, Q, dtype=F64, device="cpu")
    np.testing.assert_allclose(tq.numpy(), qmc, **TOL)
    want = jfutils.mvn_cdf(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(cov), qmc)
    got = tfutils.mvn_cdf(_t(x), _t(mean), _t(cov), tq)
    assert got.shape == lead
    np.testing.assert_allclose(got.numpy(), want, **LONG_SUMS)


def test_mvn_cdf_gradients_match_jax():
    x, mean, cov = _mvn_inputs((3,), 3, seed=1)
    qmc = jfutils.make_mvn_cdf(64, 3)
    jg = jax.grad(lambda *a: jnp.sum(jfutils.mvn_cdf(*a, qmc)), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(mean), jnp.asarray(cov)
    )
    args = [_t(a).requires_grad_(True) for a in (x, mean, cov)]
    tg = torch.autograd.grad(tfutils.mvn_cdf(*args, _t(qmc)).sum(), args)
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), w, **LONG_SUMS)


def test_mvn_cdf_matches_scipy():
    mean = np.array([0.3, -0.5, 0.2])
    cov = np.array([[1.0, 0.4, 0.2], [0.4, 1.2, -0.3], [0.2, -0.3, 0.8]])
    x = np.array([0.5, 0.0, 1.0])
    cdf = tfutils.MultivariateNormalCDF(512, 3, dtype=F64, device="cpu")
    ours = float(cdf(_t(x[None]), _t(mean[None]), _t(cov[None]))[0])
    expected = scipy.stats.multivariate_normal(mean=mean, cov=cov).cdf(x)
    np.testing.assert_allclose(ours, expected, atol=0.01)
    one = tfutils.MultivariateNormalCDF(64, 1, dtype=F64, device="cpu")
    exact = float(one(_t([[0.7]]), _t([[0.2]]), _t([[[4.0]]]))[0])
    np.testing.assert_allclose(exact, scipy.stats.norm.cdf(0.25), atol=1e-10)
    with pytest.raises(ValueError, match="sample_size"):
        tfutils.MultivariateNormalCDF(0, 2, device="cpu")
    with pytest.raises(ValueError, match="dim"):
        tfutils.MultivariateNormalCDF(8, 0, device="cpu")


# -- Monte-Carlo and batch expected improvement -----------------------------------------


def _with_draws(monkeypatch, eps):
    """Make the port's samplers draw ``eps`` (checked against the shape they ask for)."""
    eps = _t(eps)

    def draw(generator, shape, like):
        assert tuple(shape) == tuple(eps.shape), (shape, eps.shape)
        return eps

    monkeypatch.setattr(tsam, "standard_normal", draw)


def test_monte_carlo_ei_matches_jax_given_its_draws(monkeypatch):
    (jm, jds), (tm, tds) = _models()
    key, S = jax.random.PRNGKey(1), 16
    jacq = jfun.MonteCarloExpectedImprovement(S, key=key).prepare_acquisition_function(jm, jds)
    _with_draws(monkeypatch, jax.random.normal(key, (S, 1, 1), dtype=jnp.float64))
    tacq = tfun.MonteCarloExpectedImprovement(S).prepare_acquisition_function(tm, tds)
    x = np.random.default_rng(1).uniform(-1, 1, size=(12, 1, 2))
    _assert_values_and_grads(tacq, jacq, x, TOL)
    with pytest.raises(ValueError, match="batch sizes of one"):
        tacq(torch.zeros(3, 2, 2, dtype=F64))


def test_monte_carlo_augmented_ei_matches_jax_given_its_draws(monkeypatch):
    (jm, jds), (tm, tds) = _models(noise=0.05)
    key, S = jax.random.PRNGKey(2), 16
    jacq = jfun.MonteCarloAugmentedExpectedImprovement(S, key=key).prepare_acquisition_function(jm, jds)
    _with_draws(monkeypatch, jax.random.normal(key, (S, 1, 1), dtype=jnp.float64))
    tacq = tfun.MonteCarloAugmentedExpectedImprovement(S).prepare_acquisition_function(tm, tds)
    x = np.random.default_rng(2).uniform(-1, 1, size=(12, 1, 2))
    _assert_values_and_grads(tacq, jacq, x, TOL)

    class NoNoise:
        predict = tm.predict

    with pytest.raises(NotImplementedError, match="observation noise"):
        tfun.MonteCarloAugmentedExpectedImprovement(4).prepare_acquisition_function(NoNoise(), tds)


@pytest.mark.parametrize("B", [1, 4])
def test_batch_monte_carlo_ei_matches_jax_given_its_draws(monkeypatch, B):
    (jm, jds), (tm, tds) = _models()
    key, S = jax.random.PRNGKey(3), 32
    jacq = jfun.BatchMonteCarloExpectedImprovement(S, key=key).prepare_acquisition_function(jm, jds)
    _with_draws(monkeypatch, jax.random.normal(key, (1, B, S), dtype=jnp.float64))
    tacq = tfun.BatchMonteCarloExpectedImprovement(S).prepare_acquisition_function(tm, tds)
    x = np.random.default_rng(3).uniform(-1, 1, size=(10, B, 2))
    _assert_values_and_grads(tacq, jacq, x, TOL)


def test_monte_carlo_surfaces_are_frozen_within_a_step():
    """One prepared function is one surface; the default generator gives the same surface
    at every preparation, a caller's generator moves on."""
    (_, _), (tm, tds) = _models()
    x = _t(np.random.default_rng(4).uniform(-1, 1, size=(6, 2, 2)))
    builder = tfun.BatchMonteCarloExpectedImprovement(16)
    acq = builder.prepare_acquisition_function(tm, tds)
    first = acq(x)
    assert torch.equal(acq(x), first) and first.shape == (6, 1)
    again = builder.update_acquisition_function(acq, tm, tds)
    assert again is not acq and torch.equal(again(x), first)
    with pytest.raises(ValueError, match="batches of size 2"):
        acq(x[:, :1])
    own = tfun.BatchMonteCarloExpectedImprovement(16, generator=torch.Generator().manual_seed(7))
    a = own.prepare_acquisition_function(tm, tds)(x)
    b = own.prepare_acquisition_function(tm, tds)(x)
    assert not torch.equal(a, b)


@pytest.mark.parametrize("cls", [tfun.MonteCarloExpectedImprovement,
                                 tfun.MonteCarloAugmentedExpectedImprovement,
                                 tfun.BatchMonteCarloExpectedImprovement,
                                 tfun.BatchExpectedImprovement])
def test_builders_validate_their_arguments(cls):
    (_, _), (tm, tds) = _models()
    with pytest.raises(ValueError, match="sample_size"):
        cls(0)
    with pytest.raises(ValueError, match="non-empty dataset"):
        cls(4).prepare_acquisition_function(tm, None)
    assert repr(cls(4)) == f"{cls.__name__}(4)"


def test_batch_mc_ei_needs_a_reparam_sampler():
    (_, _), (tm, tds) = _models()

    class PredictOnly:
        predict = tm.predict

    with pytest.raises(ValueError, match="reparam_sampler"):
        tfun.BatchMonteCarloExpectedImprovement(4).prepare_acquisition_function(PredictOnly(), tds)


def test_analytic_batch_ei_matches_jax():
    (jm, jds), (tm, tds) = _models()
    jacq = jfun.BatchExpectedImprovement(32).prepare_acquisition_function(jm, jds)
    tacq = tfun.BatchExpectedImprovement(32).prepare_acquisition_function(tm, tds)
    rng = np.random.default_rng(5)
    # jitted: the JAX function's Python loops dispatch thousands of small ops otherwise
    _assert_values_and_grads(tacq, jax.jit(jacq), rng.uniform(-1, 1, size=(4, 2, 2)), LONG_SUMS)
    x = rng.uniform(-1, 1, size=(2, 3, 2))
    np.testing.assert_allclose(tacq(_t(x)).numpy(), jax.jit(jacq)(jnp.asarray(x)), **LONG_SUMS)


def test_analytic_batch_ei_reduces_to_ei_and_matches_monte_carlo():
    (_, _), (tm, tds) = _models()
    aqei = tfun.BatchExpectedImprovement(256).prepare_acquisition_function(tm, tds)
    ei = tfun.ExpectedImprovement().prepare_acquisition_function(tm, tds)
    x = torch.tensor([[[0.1, -0.2]]], dtype=F64)
    np.testing.assert_allclose(aqei(x).item(), ei(x).item(), rtol=1e-2)
    mc = tfun.BatchMonteCarloExpectedImprovement(50_000).prepare_acquisition_function(tm, tds)
    batch = torch.tensor([[[0.1, -0.2], [-0.3, 0.2], [0.0, 0.5]]], dtype=F64)
    np.testing.assert_allclose(aqei(batch).item(), mc(batch).item(), rtol=0.05)
    assert aqei(batch).item() >= aqei(batch[:, :2]).item() - 1e-9  # monotone in the batch


# -- continuous Thompson sampling -------------------------------------------------------


def test_parallel_continuous_thompson_sampling():
    (_, _), (tm, tds) = _models()
    builder = tcts.ParallelContinuousThompsonSampling()
    assert isinstance(builder.using(), VectorizedAcquisitionFunctionBuilder)
    acq = builder.prepare_acquisition_function(tm, tds)
    x = _t(np.random.default_rng(6).uniform(-1, 1, size=(7, 3, 2)))
    vals = acq(x)
    assert vals.shape == (7, 3) and torch.equal(acq(x), vals)  # one draw per slice, frozen
    same_point = x[:, :1].expand(7, 3, 2)
    cols = acq(same_point)
    assert not torch.allclose(cols[:, 0], cols[:, 1])  # the slices are different functions
    renewed = builder.update_acquisition_function(acq, tm, tds)
    assert not torch.equal(renewed(x), vals)  # every update draws afresh
    with pytest.raises(ValueError, match="trajectory_sampler"):
        builder.prepare_acquisition_function(object(), tds)


def test_greedy_continuous_thompson_sampling_and_negation():
    (_, _), (tm, tds) = _models()
    builder = tcts.GreedyContinuousThompsonSampling(generator=torch.Generator().manual_seed(0))
    assert isinstance(builder.using(), GreedyAcquisitionFunctionBuilder)
    acq = builder.prepare_acquisition_function(tm, tds)
    x = _t(np.random.default_rng(7).uniform(-1, 1, size=(2, 5, 1, 2)))
    assert acq(x).shape == (2, 5, 1)
    pending = x[0, :2, 0]
    renewed = builder.update_acquisition_function(acq, tm, tds, pending, new_optimization_step=False)
    assert not torch.equal(renewed(x), acq(x))
    traj = tm.trajectory_sampler().get_trajectory(torch.Generator().manual_seed(1), 1)
    flat = x.reshape(-1, 1, 2)
    torch.testing.assert_close(tcts.negate_trajectory_function(traj)(flat), -traj(flat))


def test_vectorized_optimizer_core_matches_jax_on_a_carried_trajectory():
    """Three slices, each its own trajectory carried over from the JAX package: the same
    seeds give the same starts and the same winners in both optimizers."""
    (jm, _), (tm, _) = _models()
    jtraj = jsam.RandomFourierFeatureTrajectorySampler(jm, 32).get_trajectory(
        jax.random.PRNGKey(8), batch_size=3
    )
    ttraj = convert.rff_trajectory_from_numpy(
        jtraj.mean_constant, jtraj.features.W, jtraj.features.b, jtraj.features.variance,
        jtraj.theta, device="cpu",
    )
    flat = np.random.default_rng(8).uniform(-1, 1, size=(128, 2))
    seeds = np.tile(flat[:, None, :], (1, 3, 1))
    lower, upper = -np.ones((3, 2)), np.ones((3, 2))
    jpts, jv, _ = jopt._optimize_continuous_core(
        Partial(jopt._vec_wrap, Partial(lambda x: -jtraj(x)[..., 0])), jnp.asarray(seeds),
        jnp.asarray(lower), jnp.asarray(upper), jnp.zeros(2, bool), 4, 60,
    )
    acq, V = topt._as_vectorized((lambda x: -ttraj(x)[..., 0], 3))
    pts, v, _ = topt._optimize_continuous_core(acq, _t(seeds), _t(lower), _t(upper), 4, 60)
    assert V == 3
    np.testing.assert_allclose(pts.numpy(), jpts, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), jv, rtol=1e-6, atol=1e-9)


# -- the batch optimizers and the space they search ---------------------------------------


def test_box_power_is_the_product_box_on_the_same_device_and_dtype():
    box = Box([-1.0, 2.0], [1.0, 5.0], dtype=F64, device="cpu")
    cube = box**3
    assert isinstance(cube, Box) and cube.dimension == 6
    assert cube.device == box.device and cube.dtype == box.dtype
    np.testing.assert_array_equal(cube.lower.numpy(), [-1.0, 2.0] * 3)
    np.testing.assert_array_equal(cube.upper.numpy(), [1.0, 5.0] * 3)
    assert box**1 == box
    pts = cube.sample(torch.Generator().manual_seed(0), 10)
    assert pts.shape == (10, 6) and pts.dtype == F64 and bool(cube.contains(pts).all())
    with pytest.raises(ValueError, match="power"):
        box**0


def _bowl(x: torch.Tensor) -> torch.Tensor:  # [..., 1, D] -> [..., 1], maximum at 0.25
    return -torch.sum((x[..., 0, :] - 0.25) ** 2, -1, keepdim=True)


def test_continuous_optimizer_takes_a_vectorized_function():
    space = Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu")
    targets = torch.tensor([[0.2, 0.8], [0.5, 0.5], [0.9, 0.1], [0.0, 1.0]], dtype=F64)

    def vectorized(x):  # [..., 4, 2] -> [..., 4]: slice v peaks at targets[v]
        return -torch.sum((x - targets) ** 2, -1)

    opt = topt.generate_continuous_optimizer(num_initial_samples=64, num_optimization_runs=3)
    pts = opt(space, (vectorized, 4), generator=torch.Generator().manual_seed(0))
    assert pts.shape == (4, 2)
    np.testing.assert_allclose(pts.numpy(), targets.numpy(), atol=1e-5)
    one = topt.automatic_optimizer_selector(space, _bowl, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(one.numpy(), [[0.25, 0.25]], atol=1e-5)
    via_selector = topt.batchify_vectorize(topt.automatic_optimizer_selector, 4)(
        space, vectorized, generator=torch.Generator().manual_seed(0)
    )
    np.testing.assert_allclose(via_selector.numpy(), targets.numpy(), atol=1e-5)


def test_batchify_joint_searches_the_product_space():
    space = Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu")
    targets = torch.tensor([[0.2, 0.8], [0.5, 0.5], [0.9, 0.1]], dtype=F64)
    seen = []

    def joint(x):  # [..., 3, 2] -> [..., 1]
        seen.append(tuple(x.shape[-2:]))
        return -torch.sum((x - targets) ** 2, (-2, -1))[..., None]

    inner = topt.generate_continuous_optimizer(num_initial_samples=64, num_optimization_runs=3)
    pts = topt.batchify_joint(inner, 3)(space, joint, generator=torch.Generator().manual_seed(0))
    assert pts.shape == (3, 2) and set(seen) == {(3, 2)}
    np.testing.assert_allclose(pts.numpy(), targets.numpy(), atol=1e-5)
    for lift in (topt.batchify_joint, topt.batchify_vectorize):
        with pytest.raises(ValueError, match="batch_size"):
            lift(inner, 0)
        with pytest.raises(ValueError, match="vectorized"):
            lift(inner, 2)(space, (joint, 2))


def test_random_search_optimizer():
    space = Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu")
    opt = topt.generate_random_search_optimizer(2000)
    point = opt(space, _bowl, generator=torch.Generator().manual_seed(0))
    assert point.shape == (1, 2) and float((point - 0.25).abs().max()) < 0.05
    targets = torch.tensor([[0.2, 0.8], [0.9, 0.1]], dtype=F64)
    pts = opt(space, (lambda x: -torch.sum((x - targets) ** 2, -1), 2),
              generator=torch.Generator().manual_seed(0))
    assert pts.shape == (2, 2) and float((pts - targets).abs().max()) < 0.05
    with pytest.raises(ValueError, match="num_samples"):
        topt.generate_random_search_optimizer(0)


# -- acquisition utilities ----------------------------------------------------------------


def test_split_acquisition_function_and_calls():
    sizes = []

    def fn(x):
        sizes.append(x.shape[0])
        return x.sum((-2, -1))[..., None]

    x = _t(np.random.default_rng(9).uniform(size=(10, 1, 2)))
    split = tutils.split_acquisition_function(fn, 4)
    torch.testing.assert_close(split(x), fn(x))
    assert sizes[:3] == [4, 4, 2]
    jsplit = jutils.split_acquisition_function(lambda q: q.sum((-2, -1))[..., None], 4)
    np.testing.assert_allclose(split(x).numpy(), jsplit(jnp.asarray(x.numpy())), **TOL)
    with pytest.raises(ValueError, match="split_size"):
        tutils.split_acquisition_function(fn, 0)
    space = Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu")
    sizes.clear()
    inner = topt.generate_continuous_optimizer(num_initial_samples=64, num_optimization_runs=3)
    chunked = tutils.split_acquisition_function_calls(inner, 16)
    point = chunked(space, _bowl, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(point.numpy(), [[0.25, 0.25]], atol=1e-5)
    pts = chunked(space, (lambda x: -torch.sum((x - 0.5) ** 2, -1), 2),
                  generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(pts.numpy(), np.full((2, 2), 0.5), atol=1e-5)


def test_select_nth_output_and_unique_points_mask_match_jax():
    x = np.random.default_rng(10).uniform(size=(4, 3, 2))
    np.testing.assert_array_equal(tutils.select_nth_output(_t(x), 1).numpy(),
                                  jutils.select_nth_output(jnp.asarray(x), 1))
    pts = np.array([[0.0, 0.0], [1.0, 1.0], [0.0, 1e-7], [1.0, 1.0], [0.5, 0.5], [0.0, 2e-6]])
    for tolerance in (1e-6, 1e-5):
        np.testing.assert_array_equal(
            tutils.get_unique_points_mask(_t(pts), tolerance).numpy(),
            np.asarray(jutils.get_unique_points_mask(jnp.asarray(pts), tolerance)),
        )

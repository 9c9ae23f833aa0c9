"""The port's data, space, objectives and exact-GP model against the JAX package in
float64 on the CPU: log marginal likelihood, posterior cache, predictions, priors, the
builders, and the multi-start fit from starts drawn by the JAX package."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models.gp import builders as jbuild
from trieste_tpu.models.gp import posterior as jpost
from trieste_tpu.models.gp import priors as jpri
from trieste_tpu.models.gp import training as jtrain
from trieste_tpu.objectives import single_objectives as jobj
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu.space import Box as JBox
from trieste_tpu_torch import convert
from trieste_tpu_torch.data import Dataset
from trieste_tpu_torch.models.gp import builders as tbuild
from trieste_tpu_torch.models.gp import posterior as tpost
from trieste_tpu_torch.models.gp import priors as tpri
from trieste_tpu_torch.models.gp import training as ttrain
from trieste_tpu_torch.models.gp.gpr import GaussianProcessRegression
from trieste_tpu_torch.objectives import single_objectives as tobj
from trieste_tpu_torch.observer import filter_finite
from trieste_tpu_torch.space import Box

torch.set_num_threads(1)

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-12)


def _problem(n=11, cap=16, d=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    Y = (np.sin(3 * X[:, :1]) + X[:, 1:2] ** 2) + 0.01 * rng.normal(size=(n, 1))
    return X, Y, cap


def _both(kind="matern52", noise=1e-2, seed=0, n=11, cap=16):
    X, Y, cap = _problem(n=n, cap=cap, seed=seed)
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y), capacity=cap)
    jparams = jpost.GPRParams(
        kernel=jstationary(kind, 1.3, [0.3, 0.5], dtype=jnp.float64),
        noise_variance=jnp.asarray(noise), mean_constant=jnp.asarray(0.1),
    )
    tds = convert.dataset_from_numpy(np.asarray(jds.query_points), np.asarray(jds.observations),
                                     int(jds.num_points), device="cpu")
    tparams = convert.gpr_params_from_numpy(
        kind, np.asarray(jparams.kernel.variance), np.asarray(jparams.kernel.lengthscales),
        np.asarray(jparams.noise_variance), np.asarray(jparams.mean_constant), device="cpu",
    )
    return (jparams, jds), (tparams, tds)


# -- data, space, objectives ------------------------------------------------------------


def test_dataset_padding_and_growth_follow_jax():
    rng = np.random.default_rng(0)
    X, Y = rng.uniform(size=(5, 2)), rng.uniform(size=(5, 1))
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y))
    tds = Dataset.from_arrays(torch.as_tensor(X), torch.as_tensor(Y))
    assert tds.capacity == jds.capacity == 8 and len(tds) == 5
    for extra in (3, 1, 9):
        Xe, Ye = rng.uniform(size=(extra, 2)), rng.uniform(size=(extra, 1))
        jds = jds + JDataset.from_arrays(jnp.asarray(Xe), jnp.asarray(Ye))
        tds = tds + Dataset.from_arrays(torch.as_tensor(Xe), torch.as_tensor(Ye))
        assert (tds.capacity, len(tds)) == (jds.capacity, len(jds))
        np.testing.assert_array_equal(tds.query_points.numpy(), jds.query_points)
        np.testing.assert_array_equal(tds.mask.numpy(), jds.mask)
    qp, obs = tds.astuple()
    assert qp.shape == (18, 2) and obs.shape == (18, 1)
    assert tds.with_capacity(32).capacity == 32 and len(tds.with_capacity(18)) == 18
    with pytest.raises(ValueError):
        tds.with_capacity(10)
    with pytest.raises(ValueError):
        Dataset.from_arrays(torch.zeros(3, 2), torch.zeros(4, 1))
    with pytest.raises(TypeError):
        Dataset.from_arrays(np.zeros((3, 2)), np.zeros((3, 1)))


def test_filter_finite():
    qp = torch.tensor([[0.0], [1.0], [2.0]])
    kept = filter_finite(qp, torch.tensor([[1.0], [float("nan")], [3.0]]))
    np.testing.assert_array_equal(kept.trimmed_query_points.numpy(), [[0.0], [2.0]])


def test_box_semantics():
    box = Box([0.0, -1.0], [1.0, 1.0], dtype=F64, device="cpu")
    pts = box.sample(torch.Generator().manual_seed(0), 200)
    assert pts.shape == (200, 2) and pts.dtype == F64
    assert bool(box.contains(pts).all())
    assert not bool(box.contains(torch.tensor([2.0, 0.0], dtype=F64)))
    assert Box([0.5], [0.5], device="cpu").dimension == 1  # zero width is valid
    with pytest.raises(ValueError):
        Box([1.0], [0.0], device="cpu")
    prod = box * Box([2.0], [3.0], dtype=F64, device="cpu")
    np.testing.assert_array_equal(prod.upper.numpy(), [1.0, 1.0, 3.0])
    assert (box**2).dimension == 4
    assert box.to("cpu", torch.float32).lower.dtype == torch.float32
    assert box == Box([0.0, -1.0], [1.0, 1.0], device="cpu")


@pytest.mark.parametrize("name", ["Branin", "ScaledBranin", "Hartmann6"])
def test_objectives_match_jax(name):
    jp, tp = getattr(jobj, name), getattr(tobj, name)
    lo, hi = np.asarray(jp.search_space.lower), np.asarray(jp.search_space.upper)
    x = np.random.default_rng(1).uniform(lo, hi, size=(50, lo.shape[0]))
    np.testing.assert_allclose(tp.objective(torch.as_tensor(x)).numpy(), jp.objective(x), **TOL)
    np.testing.assert_allclose(tp.minimum, jp.minimum)
    np.testing.assert_allclose(tp.minimizers, jp.minimizers)
    np.testing.assert_array_equal(tp.search_space.to("cpu").lower.numpy(), lo)


# -- posterior --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rbf", "matern12", "matern32", "matern52"])
def test_lml_cache_and_predictions_match_jax(kind):
    (jp, jds), (tp, tds) = _both(kind)
    lml = tpost.log_marginal_likelihood(tp, tds.query_points, tds.observations, tds.mask)
    jlml = jpost.log_marginal_likelihood(jp, jds.query_points, jds.observations, jds.mask)
    np.testing.assert_allclose(lml.item(), float(jlml), **TOL)

    cache = tpost.build_cache(tp, tds.query_points, tds.observations, tds.mask)
    jcache = jpost.build_cache(jp, jds.query_points, jds.observations, jds.mask)
    for name in ("L", "alpha", "LinvT"):
        np.testing.assert_allclose(getattr(cache, name).numpy(), getattr(jcache, name), rtol=1e-9, atol=1e-10)

    x = np.random.default_rng(2).uniform(size=(3, 4, 2))
    mean, var = tpost.predict_f(tp, cache, torch.as_tensor(x))
    jmean, jvar = jpost.predict_f(jp, jcache, jnp.asarray(x))
    assert mean.shape == (3, 4, 1)
    np.testing.assert_allclose(mean.numpy(), jmean, **TOL)
    np.testing.assert_allclose(var.numpy(), jvar, rtol=1e-9, atol=1e-12)
    ymean, yvar = tpost.predict_y(tp, cache, torch.as_tensor(x))
    jymean, jyvar = jpost.predict_y(jp, jcache, jnp.asarray(x))
    np.testing.assert_allclose(yvar.numpy(), jyvar, rtol=1e-9, atol=1e-12)


def test_batched_lml_matches_per_restart():
    (_, _), (tp, tds) = _both("matern32")
    u = ttrain.pack_params(tp, train_noise=True)
    shifts = torch.as_tensor(np.random.default_rng(3).uniform(-0.5, 0.5, size=(4, u.shape[0])))
    batch = ttrain.unpack_params(u + shifts, tp, train_noise=True)
    got = tpost.log_marginal_likelihood(batch, tds.query_points, tds.observations, tds.mask)
    for r in range(4):
        one = ttrain.unpack_params(u + shifts[r], tp, train_noise=True)
        want = tpost.log_marginal_likelihood(one, tds.query_points, tds.observations, tds.mask)
        np.testing.assert_allclose(got[r].item(), want.item(), **TOL)


def test_pack_matches_jax():
    (jp, _), (tp, _) = _both()
    for train_noise in (False, True):
        np.testing.assert_allclose(ttrain.pack_params(tp, train_noise).numpy(),
                                   jtrain.pack_params(jp, train_noise), **TOL)
        u = ttrain.pack_params(tp, train_noise)
        back = ttrain.unpack_params(u, tp, train_noise)
        np.testing.assert_allclose(back.kernel.lengthscales.numpy(), tp.kernel.lengthscales.numpy(), **TOL)
        np.testing.assert_allclose(back.noise_variance.item(), tp.noise_variance.item(), **TOL)


def test_priors_match_jax():
    (jp, _), (tp, _) = _both()
    jpr = jpri.default_priors(jp.kernel)
    tpr = tpri.default_priors(tp.kernel)
    np.testing.assert_allclose(tpr.ls_loc.numpy(), jpr.ls_loc, **TOL)
    far = tp.kernel.replace(lengthscales=tp.kernel.lengthscales * 1e5, variance=tp.kernel.variance * 0.3)
    jfar = jp.kernel.replace(lengthscales=jp.kernel.lengthscales * 1e5, variance=jp.kernel.variance * 0.3)
    np.testing.assert_allclose(tpri.log_prior_density(far, tpr).item(),
                               float(jpri.log_prior_density(jfar, jpr)), **TOL)
    sq, jsq = tpri.squeeze_kernel(far, tpr), jpri.squeeze_kernel(jfar, jpr)
    np.testing.assert_allclose(sq.lengthscales.numpy(), jsq.lengthscales, **TOL)
    np.testing.assert_allclose(sq.variance.item(), float(jsq.variance), **TOL)
    ported = convert.priors_from_numpy(np.asarray(jpr.ls_loc), np.asarray(jpr.var_loc),
                                       np.asarray(jpr.scale), device="cpu")
    np.testing.assert_allclose(ported.var_loc.item(), tpr.var_loc.item(), **TOL)


def test_default_gpr_params_match_jax():
    (_, jds), (_, tds) = _both()
    jspace = JBox([0.0, 0.0], [1.0, 2.0])
    tspace = Box([0.0, 0.0], [1.0, 2.0], dtype=F64, device="cpu")
    for lik in (None, 1e-4):
        jp = jbuild.default_gpr_params(jds, jspace, likelihood_variance=lik)
        tp = tbuild.default_gpr_params(tds, tspace, likelihood_variance=lik)
        np.testing.assert_allclose(tp.kernel.lengthscales.numpy(), jp.kernel.lengthscales, **TOL)
        np.testing.assert_allclose(tp.kernel.variance.item(), float(jp.kernel.variance), **TOL)
        np.testing.assert_allclose(tp.noise_variance.item(), float(jp.noise_variance), **TOL)
        np.testing.assert_allclose(tp.mean_constant.item(), float(jp.mean_constant), **TOL)


@pytest.mark.parametrize(
    "with_priors, train_noise",
    [(True, False), (True, True), (False, False)],
    ids=["map-fixed-noise", "map-trained-noise", "mle-fixed-noise"],
)
def test_fit_from_jax_starts_reaches_jax_optimum(with_priors, train_noise):
    """The JAX package draws the restarts; both packages fit from them. (Without priors a
    trained noise leaves a flat direction, where the two stop within gtol of each other
    but not within 1e-6 in the parameters; the losses still agree.)"""
    (jp, jds), (tp, tds) = _both("matern52", noise=1e-2)
    jpr = jpri.default_priors(jp.kernel) if with_priors else None
    tpr = tpri.default_priors(tp.kernel) if with_priors else None
    key = jax.random.PRNGKey(3)
    want = jtrain.fit_gpr(key, jp, jds.query_points, jds.observations, jds.mask,
                          num_starts=4, train_noise=train_noise, max_iters=100, priors=jpr)
    starts = np.asarray(jtrain.randomize_starts(key, jp, 4, train_noise, priors=jpr))
    got = ttrain.fit_gpr_from_starts(torch.tensor(starts), tp, tds.query_points, tds.observations,
                                     tds.mask, train_noise=train_noise, max_iters=100, priors=tpr)
    np.testing.assert_allclose(got.all_losses.numpy(), want.all_losses, rtol=1e-6)
    np.testing.assert_allclose(got.loss.item(), float(want.loss), rtol=1e-6)
    np.testing.assert_allclose(got.params.kernel.lengthscales.numpy(), want.params.kernel.lengthscales, rtol=1e-6)
    np.testing.assert_allclose(got.params.kernel.variance.item(), float(want.params.kernel.variance), rtol=1e-6)
    np.testing.assert_allclose(got.params.noise_variance.item(), float(want.params.noise_variance), rtol=1e-6)
    np.testing.assert_allclose(got.params.mean_constant.item(), float(want.params.mean_constant), rtol=1e-6, atol=1e-9)


def test_randomize_starts_layout():
    (_, _), (tp, _) = _both()
    pr = tpri.default_priors(tp.kernel)
    g = torch.Generator().manual_seed(0)
    starts = ttrain.randomize_starts(g, tp, 6, train_noise=False, priors=pr)
    u0 = ttrain.pack_params(tp, False)
    assert starts.shape == (6, u0.shape[0])
    np.testing.assert_array_equal(starts[0].numpy(), u0.numpy())
    np.testing.assert_array_equal(starts[1:, 3].numpy(), np.full(5, u0[3].item()))  # mean kept
    free = ttrain.randomize_starts(g, tp, 6, train_noise=True)
    assert float((free[1:] - ttrain.pack_params(tp, True)).abs().max()) <= ttrain.LN10
    np.testing.assert_array_equal(free[1:, 3].numpy(), np.full(5, u0[3].item()))


def test_gpr_model_update_optimize_predict():
    (_, _), (tp, tds) = _both()
    model = GaussianProcessRegression(tp, tds, num_kernel_samples=3, max_optimize_iters=30,
                                      priors=tpri.default_priors(tp.kernel))
    before = model.predict(tds.query_points[:3])[0]
    result = model.optimize(tds)
    assert torch.isfinite(result.loss) and result.all_losses.shape == (3,)
    assert model.params is result.params
    mean, var = model.predict(tds.query_points[:3])
    assert bool((var > 0).all()) and not torch.equal(mean, before)
    more = tds + Dataset.from_arrays(torch.rand(9, 2, dtype=F64), torch.rand(9, 1, dtype=F64))
    model.update(more)
    assert model.dataset.capacity == 32
    assert model.posterior_cache.X.shape == (32, 2)
    model.params = tp
    assert model.params is tp
    np.testing.assert_allclose(
        model.posterior_cache.alpha.numpy(),
        tpost.build_cache(tp, more.query_points, more.observations, more.mask).alpha.numpy(),
    )
    with pytest.raises(ValueError, match="dimension"):
        model.update(Dataset.from_arrays(torch.zeros(2, 3, dtype=F64), torch.zeros(2, 1, dtype=F64)))

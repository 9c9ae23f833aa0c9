"""The port's joint posterior, conditioning, QMC sequences, reparametrization samplers,
trajectory samplers and Thompson samplers on the CPU, against the JAX package in float64.

Randomness cannot match draw for draw across the two packages, so every parity test
rebuilds the JAX function's base draws from its key, with the key splits the JAX code
makes, and feeds them as numpy to the pure half of the port's function. Tolerances:
rtol 1e-9 / atol 1e-10 for everything given the same base draws or the same state.
The statistical tests at the end need no JAX.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trieste_tpu.acquisition import sampler as jts
from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models import interfaces as jinterfaces
from trieste_tpu.models.gp import posterior as jpost
from trieste_tpu.models.gp import sampler as jsam
from trieste_tpu.models.gp.gpr import GaussianProcessRegression as JGPR
from trieste_tpu.ops import qmc as jqmc
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu_torch import Box, Dataset, convert
from trieste_tpu_torch.acquisition import sampler as tts
from trieste_tpu_torch.models import interfaces as tinterfaces
from trieste_tpu_torch.models.gp import posterior as tpost
from trieste_tpu_torch.models.gp import sampler as tsam
from trieste_tpu_torch.models.gp.gpr import GaussianProcessRegression
from trieste_tpu_torch.ops import qmc as tqmc

torch.set_num_threads(1)

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-10)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _models(kind="matern52", n=11, D=2, seed=0, noise=1e-3, num_rff_features=64):
    """The same GPR (capacity 16, partly padded) in both packages, float64."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, D))
    Y = np.sin(3.0 * X.sum(-1, keepdims=True)) + 0.1 * rng.normal(size=(n, 1))
    ls = [0.3 + 0.1 * d for d in range(D)]
    jmodel = JGPR(
        jpost.GPRParams(jstationary(kind, 1.1, ls, dtype=jnp.float64), jnp.asarray(noise),
                        jnp.asarray(-0.2)),
        JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y)), num_rff_features=num_rff_features,
    )
    tmodel = GaussianProcessRegression(
        convert.gpr_params_from_numpy(kind, 1.1, ls, noise, -0.2, device="cpu", dtype=F64),
        Dataset.from_arrays(_t(X), _t(Y)), num_rff_features=num_rff_features,
    )
    return jmodel, tmodel


# -- the joint posterior and conditioning ---------------------------------------------


@pytest.mark.parametrize("lead", [(), (5,), (2, 3)])
def test_predict_joint_matches_jax(lead):
    jm, tm = _models()
    x = np.random.default_rng(1).uniform(size=lead + (4, 2))
    jmean, jcov = jm.predict_joint(jnp.asarray(x))
    mean, cov = tm.predict_joint(_t(x))
    np.testing.assert_allclose(mean.numpy(), jmean, **TOL)
    np.testing.assert_allclose(cov.numpy(), jcov, **TOL)


def test_predict_joint_grad_matches_jax():
    jm, tm = _models()
    x = np.random.default_rng(2).uniform(size=(3, 4, 2))
    loss = lambda mc: (mc[0] ** 2).sum() + (mc[1] ** 2).sum()  # noqa: E731
    jg = jax.grad(lambda q: loss(jm.predict_joint(q)))(jnp.asarray(x))
    q = _t(x).requires_grad_(True)
    (tg,) = torch.autograd.grad(loss(tm.predict_joint(q)), q)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-8, atol=1e-10)


def test_sample_joint_matches_jax_given_its_draws():
    jm, tm = _models()
    key = jax.random.PRNGKey(3)
    x = np.random.default_rng(3).uniform(size=(2, 4, 2))
    want = jm.sample(key, jnp.asarray(x), 7)
    eps = jax.random.normal(key, (2, 1, 7, 4), dtype=jnp.float64)  # posterior.py: [..., P, S, B]
    got = tpost.sample_joint_from_eps(tm.params, tm.posterior_cache, _t(x), _t(eps))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    drawn = tm.sample(torch.Generator().manual_seed(0), _t(x), 7)
    assert drawn.shape == got.shape and bool(torch.isfinite(drawn).all())


@pytest.mark.parametrize("lead", [(), (3,)])
def test_covariance_between_points_matches_jax(lead):
    jm, tm = _models(kind="rbf")
    rng = np.random.default_rng(4)
    x1, x2 = rng.uniform(size=lead + (5, 2)), rng.uniform(size=(3, 2))
    want = jm.covariance_between_points(jnp.asarray(x1), jnp.asarray(x2))
    got = tm.covariance_between_points(_t(x1), _t(x2))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cho_solve_batched_matches_jax():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(3, 4, 4))
    L = np.linalg.cholesky(A @ A.transpose(0, 2, 1) + 4 * np.eye(4))
    b = rng.normal(size=(3, 4, 2))
    want = jpost.cho_solve_batched(jnp.asarray(L), jnp.asarray(b))
    np.testing.assert_allclose(tpost.cho_solve_batched(_t(L), _t(b)).numpy(), want, **TOL)


def _extra(lead, M=3):
    rng = np.random.default_rng(6)
    return rng.uniform(size=lead + (M, 2)), rng.normal(size=lead + (M, 1))


@pytest.mark.parametrize("method", ["conditional_predict_joint", "conditional_predict_f",
                                    "conditional_predict_y"])
@pytest.mark.parametrize("lead, query_lead", [((), ()), ((4,), ()), ((2, 3), (2, 3))])
def test_conditional_predictions_match_jax(method, lead, query_lead):
    jm, tm = _models()
    ex, ey = _extra(lead)
    x = np.random.default_rng(7).uniform(size=query_lead + (5, 2))
    jfn, tfn = getattr(jpost, method), getattr(tpost, method)
    want = jfn(jm.params, jm.posterior_cache, jnp.asarray(x), jnp.asarray(ex), jnp.asarray(ey))
    got = tfn(tm.params, tm.posterior_cache, _t(x), _t(ex), _t(ey))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_conditional_model_methods_and_samples_match_jax():
    jm, tm = _models()
    ex, ey = _extra(())
    x = np.random.default_rng(8).uniform(size=(5, 2))
    jextra = JDataset.from_arrays(jnp.asarray(ex), jnp.asarray(ey))
    textra = Dataset.from_arrays(_t(ex), _t(ey))  # padded: the model reads the valid rows
    for name in ("conditional_predict_f", "conditional_predict_joint", "conditional_predict_y"):
        for g, w in zip(getattr(tm, name)(_t(x), textra), getattr(jm, name)(jnp.asarray(x), jextra)):
            np.testing.assert_allclose(g.numpy(), w, **TOL)
    key = jax.random.PRNGKey(9)
    want = jm.conditional_predict_f_sample(key, jnp.asarray(x), jextra, 6)
    eps = jax.random.normal(key, (1, 6, 5), dtype=jnp.float64)
    got = tpost.conditional_predict_f_sample_from_eps(
        tm.params, tm.posterior_cache, _t(x), _t(ex), _t(ey), _t(eps)
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    drawn = tm.conditional_predict_f_sample(torch.Generator().manual_seed(1), _t(x), textra, 6)
    assert drawn.shape == got.shape


def test_model_accessors_match_jax():
    jm, tm = _models()
    x = np.random.default_rng(10).uniform(size=(6, 2))
    for g, w in zip(tm.predict_y(_t(x)), jm.predict_y(jnp.asarray(x))):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    assert tm.get_kernel() is tm.params.kernel and tm.get_internal_data() is tm.dataset
    assert float(tm.get_observation_noise()) == float(jm.get_observation_noise())
    np.testing.assert_allclose(tm.get_mean_function()(_t(x)).numpy(),
                               jm.get_mean_function()(jnp.asarray(x)), **TOL)
    assert tm.num_rff_features == jm.num_rff_features == 64
    assert isinstance(tm.reparam_sampler(4), tsam.BatchReparametrizationSampler)
    assert isinstance(tm.trajectory_sampler(), tsam.RandomFourierFeatureTrajectorySampler)


@pytest.mark.parametrize("protocol", [
    "ProbabilisticModel", "TrainableProbabilisticModel", "SupportsPredictJoint", "SupportsPredictY",
    "SupportsGetKernel", "SupportsGetObservationNoise", "SupportsGetInternalData",
    "SupportsGetMeanFunction", "FastUpdateModel", "SupportsCovarianceBetweenPoints",
    "HasTrajectorySampler", "HasReparamSampler",
])
def test_gpr_has_the_capabilities_it_has_in_jax(protocol):
    jm, tm = _models()
    assert isinstance(jm, getattr(jinterfaces, protocol))
    assert isinstance(tm, getattr(tinterfaces, protocol))
    assert not isinstance(object(), getattr(tinterfaces, protocol))


# -- quasi-Monte-Carlo sequences ------------------------------------------------------


@pytest.mark.parametrize("n, d, skip", [(16, 3, None), (9, 2, 5), (1, 1, 0)])
def test_sobol_sample_matches_jax(n, d, skip):
    got = tqmc.sobol_sample(n, d, skip, dtype=F64, device="cpu")
    np.testing.assert_allclose(got.numpy(), jqmc.sobol_sample(n, d, skip, dtype=jnp.float64), **TOL)


@pytest.mark.parametrize("n, d", [(17, 3), (200, 6), (4, 0)])
def test_deterministic_halton_matches_jax(n, d):
    got = tqmc.halton_sample(None, n, d, dtype=F64, device="cpu")
    np.testing.assert_allclose(got.numpy(), jqmc.halton_sample(None, n, d, dtype=jnp.float64), **TOL)


def test_randomized_halton_is_a_rotation_of_the_sequence():
    base = tqmc.halton_sample(None, 50, 3, dtype=F64, device="cpu")
    gen = torch.Generator().manual_seed(0)
    rotated = tqmc.halton_sample(gen, 50, 3, dtype=F64, device="cpu")
    shift = torch.remainder(rotated - base, 1.0)
    assert bool(((rotated >= 0) & (rotated < 1)).all())
    np.testing.assert_allclose(shift.numpy(), np.broadcast_to(shift[0].numpy(), (50, 3)), atol=1e-12)
    assert float(shift[0].min()) > 0.0
    with pytest.raises(ValueError, match="168"):
        tqmc.halton_sample(None, 4, 169, device="cpu")


def test_qmc_normal_samples_match_jax():
    got = tqmc.qmc_normal_samples(32, 3, skip=2, dtype=F64, device="cpu")
    np.testing.assert_allclose(got.numpy(), jqmc.qmc_normal_samples(32, 3, skip=2, dtype=jnp.float64), **TOL)


def test_box_qmc_sampling_stays_in_the_box():
    box = Box([-1.0, 2.0], [1.0, 5.0], dtype=F64, device="cpu")
    sobol = box.sample_sobol(64, skip=3)
    want = -1.0 + 2.0 * np.asarray(jqmc.sobol_sample(64, 2, 3, dtype=jnp.float64))[:, 0]
    np.testing.assert_allclose(sobol[:, 0].numpy(), want, **TOL)
    halton = box.sample_halton(torch.Generator().manual_seed(0), 64)
    for pts in (sobol, halton):
        assert pts.shape == (64, 2) and pts.dtype == F64 and bool(box.contains(pts).all())


# -- reparametrization samplers -------------------------------------------------------


def test_independent_reparam_sampler_matches_jax_given_its_draws():
    jm, tm = _models()
    key = jax.random.PRNGKey(11)
    at = np.random.default_rng(11).uniform(size=(5, 1, 2))
    want = jsam.IndependentReparametrizationSampler(8, jm).sample(jnp.asarray(at), key=key)
    eps = jax.random.normal(key, (8, 1, 1), dtype=jnp.float64)  # sampler.py: [S, 1, L]
    got = tsam.IndependentReparametrizationSampler(8, tm, eps=_t(eps)).sample(_t(at))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the pure function that the JAX package's MC-EI closes over draws the same eps
    s_token = jnp.zeros(8)
    pure = jsam.pure_marginal_reparam_sample(jm.params, jm.posterior_cache, key, s_token, jnp.asarray(at))
    np.testing.assert_allclose(got.numpy(), pure, **TOL)


def test_batch_reparam_sampler_matches_jax_given_its_draws():
    jm, tm = _models()
    key = jax.random.PRNGKey(12)
    at = np.random.default_rng(12).uniform(size=(5, 3, 2))
    want = jsam.BatchReparametrizationSampler(8, jm).sample(jnp.asarray(at), key=key)
    eps = jax.random.normal(key, (1, 3, 8), dtype=jnp.float64)  # sampler.py: [L, B, S]
    sampler = tsam.BatchReparametrizationSampler(8, tm, eps=_t(eps))
    np.testing.assert_allclose(sampler.sample(_t(at), jitter=1e-6).numpy(), want, **TOL)
    # the pure function behind the JAX package's batch MC-EI uses the dtype's jitter
    pure = jsam.pure_batch_reparam_sample(jm.params, jm.posterior_cache, key, jnp.zeros(8), jnp.asarray(at))
    np.testing.assert_allclose(sampler.sample(_t(at)).numpy(), pure, **TOL)
    with pytest.raises(ValueError, match="batches of size 3"):
        sampler.sample(_t(at[:, :2]))


def test_reparam_samplers_freeze_and_reset_their_draws():
    _, tm = _models()
    at = _t(np.random.default_rng(13).uniform(size=(4, 2, 2)))
    for cls in (tsam.IndependentReparametrizationSampler, tsam.BatchReparametrizationSampler):
        sampler = cls(16, tm)
        a = sampler.sample(at, generator=torch.Generator().manual_seed(0))
        b = sampler.sample(at, generator=torch.Generator().manual_seed(999))
        assert a.shape == (4, 16, 2, 1) and torch.equal(a, b)
        sampler.reset_sampler()
        c = sampler.sample(at, generator=torch.Generator().manual_seed(999))
        assert not torch.equal(a, c)
    with pytest.raises(ValueError, match="positive"):
        tsam.BatchReparametrizationSampler(0, tm)


def test_degenerate_batch_gives_nan_not_an_exception():
    """Two equal points in a joint candidate with a negative jitter: the Cholesky fails
    for that member of the batch only, as it does in JAX."""
    _, tm = _models()
    at = _t(np.random.default_rng(14).uniform(size=(3, 2, 2)))
    at[1, 1] = at[1, 0]
    out = tsam.BatchReparametrizationSampler(4, tm).sample(at, jitter=-1e-9)
    assert bool(torch.isnan(out[1]).all()) and bool(torch.isfinite(out[[0, 2]]).all())


# -- trajectories ---------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rbf", "matern12", "matern32", "matern52"])
def test_spectral_frequencies_match_jax_given_its_draws(kind):
    jm, tm = _models(kind=kind)
    key = jax.random.PRNGKey(15)
    want = jsam.sample_spectral_frequencies(key, jm.params.kernel, 32, 2)
    k_norm, k_chi = jax.random.split(key)
    z = jax.random.normal(k_norm, (32, 2), dtype=jnp.float64)
    chi2 = None
    if kind != "rbf":
        df = jsam._MATERN_DF[kind]
        chi2 = _t(2.0 * jax.random.gamma(k_chi, df / 2.0, (32, 1), dtype=jnp.float64))
    got = tsam.spectral_frequencies_from_draws(tm.params.kernel, _t(z), chi2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    drawn = tsam.sample_spectral_frequencies(torch.Generator().manual_seed(0), tm.params.kernel, 4000, 2)
    assert drawn.shape == (4000, 2) and bool(torch.isfinite(drawn).all())
    # the median of |w·ℓ| of a t (or normal) variate is below 1 and above 0.5
    assert 0.5 < float((drawn * tm.params.kernel.lengthscales).abs().median()) < 1.01


def _jax_features(jm, key, m):
    return jsam.make_fourier_features(key, jm.params.kernel, m, 2)


def test_fourier_features_match_jax_on_the_same_state():
    jm, tm = _models()
    jf = _jax_features(jm, jax.random.PRNGKey(16), 32)
    tf = convert.fourier_features_from_numpy(jf.W, jf.b, jf.variance, device="cpu")
    x = np.random.default_rng(16).uniform(size=(7, 3, 2))
    np.testing.assert_allclose(tf(_t(x)).numpy(), jf(jnp.asarray(x)), **TOL)
    made = tsam.make_fourier_features(torch.Generator().manual_seed(0), tm.params.kernel, 500, 2)
    assert made.W.shape == (500, 2) and made.b.shape == (500,)
    assert 0.0 <= float(made.b.min()) and float(made.b.max()) < 2 * np.pi


def test_decoupled_trajectory_matches_jax_given_its_draws():
    jm, tm = _models()
    key, m, B = jax.random.PRNGKey(17), 48, 3
    want = jsam.DecoupledTrajectorySampler(jm, m).get_trajectory(key, batch_size=B)
    k_feat, k_w, k_noise = jax.random.split(key, 3)  # sampler.py:235
    jf = _jax_features(jm, k_feat, m)
    w = jax.random.normal(k_w, (B, m), dtype=jnp.float64)
    noise_eps = jax.random.normal(k_noise, (B, 16), dtype=jnp.float64)
    got = tsam.decoupled_trajectory_from_draws(
        tm.params, tm.posterior_cache, tm.dataset.observations,
        convert.fourier_features_from_numpy(jf.W, jf.b, jf.variance, device="cpu"),
        _t(w), _t(noise_eps),
    )
    np.testing.assert_allclose(got.v.numpy(), want.v, **TOL)
    x = np.random.default_rng(17).uniform(size=(9, B, 2))
    np.testing.assert_allclose(got(_t(x)).numpy(), want(jnp.asarray(x)), **TOL)
    carried = convert.decoupled_trajectory_from_numpy(
        tm.params, tm.posterior_cache, jf.W, jf.b, jf.variance, want.w, want.v, device="cpu"
    )
    np.testing.assert_allclose(carried(_t(x)).numpy(), want(jnp.asarray(x)), **TOL)


@pytest.mark.parametrize("m, route", [(48, "kernel trick"), (8, "design matrix")])
def test_rff_trajectory_matches_jax_given_its_draws(m, route):
    jm, tm = _models()
    key, B, C = jax.random.PRNGKey(18), 3, 16
    assert (C <= m) == (route == "kernel trick")
    want = jsam.RandomFourierFeatureTrajectorySampler(jm, m).get_trajectory(key, batch_size=B)
    k_feat, k_theta, k_noise = jax.random.split(key, 3)  # sampler.py:305
    jf = _jax_features(jm, k_feat, m)
    eps = jax.random.normal(k_theta, (B, m), dtype=jnp.float64)
    eps_n = jax.random.normal(k_noise, (B, C), dtype=jnp.float64)
    got = tsam.rff_trajectory_from_draws(
        tm.params, tm.posterior_cache, tm.dataset.observations,
        convert.fourier_features_from_numpy(jf.W, jf.b, jf.variance, device="cpu"),
        _t(eps), _t(eps_n) if C <= m else None,
    )
    np.testing.assert_allclose(got.theta.numpy(), want.theta, **TOL)
    x = np.random.default_rng(18).uniform(size=(9, B, 2))
    np.testing.assert_allclose(got(_t(x)).numpy(), want(jnp.asarray(x)), **TOL)
    carried = convert.rff_trajectory_from_numpy(
        want.mean_constant, jf.W, jf.b, jf.variance, want.theta, device="cpu"
    )
    np.testing.assert_allclose(carried(_t(x)).numpy(), want(jnp.asarray(x)), **TOL)


def test_trajectory_gradients_match_jax():
    jm, tm = _models()
    key = jax.random.PRNGKey(19)
    jtraj = jsam.RandomFourierFeatureTrajectorySampler(jm, 32).get_trajectory(key, batch_size=2)
    ttraj = convert.rff_trajectory_from_numpy(
        jtraj.mean_constant, jtraj.features.W, jtraj.features.b, jtraj.features.variance,
        jtraj.theta, device="cpu",
    )
    x = np.random.default_rng(19).uniform(size=(5, 2, 2))
    jg = jax.grad(lambda q: jnp.sum(jtraj(q)))(jnp.asarray(x))
    q = _t(x).requires_grad_(True)
    (tg,) = torch.autograd.grad(ttraj(q).sum(), q)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-8, atol=1e-10)


# -- Thompson samplers ----------------------------------------------------------------


@pytest.mark.parametrize("sample_min_value", [False, True])
def test_exact_thompson_sampler_matches_jax_given_its_draws(monkeypatch, sample_min_value):
    jm, tm = _models()
    key = jax.random.PRNGKey(20)
    at = np.random.default_rng(20).uniform(size=(30, 2))
    want = jts.ExactThompsonSampler(sample_min_value).sample(jm, 5, jnp.asarray(at), key=key)
    eps = _t(jax.random.normal(key, (1, 5, 30), dtype=jnp.float64))
    monkeypatch.setattr(tpost, "standard_normal", lambda generator, shape, like: eps)
    got = tts.ExactThompsonSampler(sample_min_value).sample(tm, 5, _t(at))
    assert got.shape == ((5, 1) if sample_min_value else (5, 2))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_gumbel_sampler_matches_jax_given_its_draws():
    jm, tm = _models()
    key = jax.random.PRNGKey(21)
    at = np.random.default_rng(21).uniform(size=(40, 2))
    want = jts.GumbelSampler().sample(jm, 6, jnp.asarray(at), key=key)
    u = jax.random.uniform(key, (6, 1), dtype=jnp.float64, minval=1e-12, maxval=1.0 - 1e-12)
    got = tts.gumbel_min_value_samples(*tm.predict(_t(at)), _t(u))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    drawn = tts.GumbelSampler().sample(tm, 6, _t(at), generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (6, 1) and float(drawn.max()) <= float(tm.predict(_t(at))[0].min())
    with pytest.raises(ValueError, match="sample_min_value=True"):
        tts.GumbelSampler(sample_min_value=False)


@pytest.mark.parametrize("sample_min_value", [False, True])
def test_thompson_sampler_from_trajectory(sample_min_value):
    """The sampler returns, for every draw, the candidate that minimizes the trajectory
    which the model's sampler gives from the same generator state."""
    _, tm = _models()
    at = _t(np.random.default_rng(22).uniform(size=(50, 2)))
    got = tts.ThompsonSamplerFromTrajectory(sample_min_value).sample(
        tm, 4, at, generator=torch.Generator().manual_seed(5)
    )
    traj = tm.trajectory_sampler().get_trajectory(torch.Generator().manual_seed(5), batch_size=4)
    vals = traj(at[:, None, :].expand(50, 4, 2))[..., 0]  # [N, S]
    want = vals.min(dim=0).values[:, None] if sample_min_value else at[vals.argmin(dim=0)]
    assert got.shape == ((4, 1) if sample_min_value else (4, 2))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="positive"):
        tts.ThompsonSamplerFromTrajectory().sample(tm, 0, at)
    with pytest.raises(ValueError, match="HasTrajectorySampler"):
        tts.ThompsonSamplerFromTrajectory().sample(object(), 2, at)


# -- statistical tests (no JAX) ---------------------------------------------------------


@pytest.fixture(scope="module")
def gpr_1d():
    rng = np.random.default_rng(0)
    X = rng.uniform(-1.0, 1.0, size=(12, 1))
    params = convert.gpr_params_from_numpy("rbf", 1.0, 0.4, 1e-3, 0.0, device="cpu", dtype=F64)
    return GaussianProcessRegression(params, Dataset.from_arrays(_t(X), _t(np.sin(3.0 * X))))


def _trajectory_moments(sampler, x, n_draws, seed=0):
    """Mean and variance over ``n_draws`` independent trajectories (one batch) at ``x [N, 1]``."""
    traj = sampler.get_trajectory(torch.Generator().manual_seed(seed), batch_size=n_draws)
    vals = traj(x[:, None, :].expand(x.shape[0], n_draws, 1))[..., 0]  # [N, n_draws]
    return vals.mean(dim=1).numpy(), vals.var(dim=1).numpy()


@pytest.mark.parametrize("cls", [tsam.RandomFourierFeatureTrajectorySampler,
                                 tsam.DecoupledTrajectorySampler])
def test_trajectory_moments_match_posterior(gpr_1d, cls):
    """300 draws: Monte-Carlo error plus the error of 1024 features, atol 0.15 as in
    tests/unit/test_trajectory_samplers.py."""
    x = torch.linspace(-1.0, 1.0, 15, dtype=F64)[:, None]
    emp_mean, emp_var = _trajectory_moments(cls(gpr_1d, 1024), x, 300)
    mean, var = gpr_1d.predict(x)
    np.testing.assert_allclose(emp_mean, mean[:, 0].numpy(), atol=0.15)
    np.testing.assert_allclose(emp_var, var[:, 0].numpy(), atol=0.15)


def test_batch_reparam_sampler_moments(gpr_1d):
    x = torch.tensor([[-0.5], [0.2], [0.7]], dtype=F64)
    samples = tsam.BatchReparametrizationSampler(2000, gpr_1d).sample(
        x[None], generator=torch.Generator().manual_seed(0)
    )
    s = samples.reshape(-1, 3).numpy()
    mean, cov = gpr_1d.predict_joint(x)
    np.testing.assert_allclose(s.mean(0), mean[:, 0].numpy(), atol=0.08)
    np.testing.assert_allclose(np.cov(s.T), cov[0].numpy(), atol=0.08)


def test_rff_kernel_trick_route_matches_design_matrix_route(gpr_1d):
    """The same features and data through both routes: capacity 16 <= m = 24 takes the
    kernel trick, the same data padded to capacity 32 > 24 the design matrix. With zero
    draws both give the posterior mean of the weights (push-through identity), and their
    draws have the same moments."""
    features = tsam.make_fourier_features(torch.Generator().manual_seed(3), gpr_1d.get_kernel(), 24, 1)
    padded = GaussianProcessRegression(gpr_1d.params, gpr_1d.dataset.with_capacity(32))
    zeros = lambda *shape: torch.zeros(shape, dtype=F64)  # noqa: E731
    trick = tsam.rff_trajectory_from_draws(
        gpr_1d.params, gpr_1d.posterior_cache, gpr_1d.dataset.observations, features,
        zeros(1, 24), zeros(1, 16),
    )
    design = tsam.rff_trajectory_from_draws(
        padded.params, padded.posterior_cache, padded.dataset.observations, features, zeros(1, 24)
    )
    np.testing.assert_allclose(trick.theta.numpy(), design.theta.numpy(), rtol=1e-6, atol=1e-8)
    x = torch.linspace(-1.0, 1.0, 9, dtype=F64)[:, None]
    S = 4000
    eps = torch.randn(S, 24, generator=torch.Generator().manual_seed(4), dtype=F64)
    eps_n = torch.randn(S, 16, generator=torch.Generator().manual_seed(5), dtype=F64)
    xb = x[:, None, :].expand(9, S, 1)
    a = tsam.rff_trajectory_from_draws(gpr_1d.params, gpr_1d.posterior_cache,
                                       gpr_1d.dataset.observations, features, eps, eps_n)(xb)[..., 0]
    b = tsam.rff_trajectory_from_draws(padded.params, padded.posterior_cache,
                                       padded.dataset.observations, features, eps)(xb)[..., 0]
    np.testing.assert_allclose(a.mean(1).numpy(), b.mean(1).numpy(), atol=0.02)
    np.testing.assert_allclose(a.var(1).numpy(), b.var(1).numpy(), atol=0.02)


def test_rff_trajectories_finite_at_tiny_noise_f32():
    """With a noise of 1e-7 in fp32 the weight posterior stays finite for every seed: the
    kernel-trick route conditions like the GP's own jittered Gram."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(17, 2)).astype(np.float32)
    X = np.concatenate([X, X[:4] + 1e-4])  # near-duplicates, as a BO loop gathers them
    Y = np.sum(np.square(X - 0.4), -1, keepdims=True).astype(np.float32)
    params = convert.gpr_params_from_numpy("matern52", 0.12, [0.16, 0.15], 1e-7, 0.0,
                                           device="cpu", dtype=torch.float32)
    model = GaussianProcessRegression(params, Dataset.from_arrays(_t(X), _t(Y)))
    sampler = tsam.RandomFourierFeatureTrajectorySampler(model, 500)
    x = torch.rand(64, 3, 2, generator=torch.Generator().manual_seed(5))
    for seed in range(20):
        out = sampler.get_trajectory(torch.Generator().manual_seed(seed), 3)(x)
        assert out.dtype == torch.float32 and bool(torch.isfinite(out).all()), seed


@pytest.mark.parametrize("cls", [tsam.RandomFourierFeatureTrajectorySampler,
                                 tsam.DecoupledTrajectorySampler])
def test_trajectory_batch_draws_are_independent_deterministic_functions(gpr_1d, cls):
    sampler = cls(gpr_1d, 256)
    traj = sampler.get_trajectory(torch.Generator().manual_seed(0), batch_size=3)
    x = torch.linspace(-1.0, 1.0, 7, dtype=F64)[:, None, None].expand(7, 3, 1)
    vals = traj(x)[:, :, 0]
    assert not np.allclose(vals[:, 0], vals[:, 1]) and not np.allclose(vals[:, 1], vals[:, 2])
    torch.testing.assert_close(traj(x), traj(x.clone()), rtol=0, atol=0)
    if cls is tsam.DecoupledTrajectorySampler:
        again = sampler.update_trajectory(traj, torch.Generator().manual_seed(1))
        assert again.w.shape == traj.w.shape and not torch.equal(again.w, traj.w)
        with pytest.raises(TypeError, match="DecoupledTrajectory"):
            sampler.update_trajectory(lambda x: x)

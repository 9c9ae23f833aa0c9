"""The port's Hamiltonian Monte Carlo and fully-Bayesian GP on the CPU, against the JAX
package in float64.

The packages cannot share random draws, so each test rebuilds the JAX draws from its keys
(with the splits the JAX code makes: ``_run_chains`` splits ``(k_init, k_chains)`` and
``k_chains`` into one key per chain, ``hmc_sample`` one key per transition and each into
``(k_mom, k_acc)``) and feeds them to the port's pure halves. Tolerances: HMC on a 2-D
Gaussian (samples, accept rate and step size), the log posterior with its gradient, the
mixture's moments, joint samples and MC EI values at rtol 1e-9 (the same arithmetic); the
thinned stack of ``optimize`` at rtol 1e-6 (180 gradient steps in a row amplify rounding);
the slice, two EGO steps with MC EI through ``BayesianOptimizer.optimize``, at atol 1e-6
on the query points. The analytic contracts of the JAX package's own tests at theirs.

Every JAX function is compiled whole, once per shape.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trieste_tpu as jt
from trieste_tpu import space as jsp
from trieste_tpu.acquisition import optimizer as jopt
from trieste_tpu.acquisition import rule as jrule
from trieste_tpu.acquisition.function import function as jfun
from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models.gp import mcmc as jmcmc
from trieste_tpu.models.gp import posterior as jpost
from trieste_tpu.models.gp.training import pack_params as jpack
from trieste_tpu.objectives import single_objectives as jobj
from trieste_tpu.ops import hmc as jhmc
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu_torch import BayesianOptimizer, Dataset, convert
from trieste_tpu_torch import space as tsp
from trieste_tpu_torch.acquisition import optimizer as topt
from trieste_tpu_torch.acquisition import rule as trule
from trieste_tpu_torch.acquisition.function import function as tfun
from trieste_tpu_torch.models.gp import mcmc as tmcmc
from trieste_tpu_torch.models.gp import posterior as tpost
from trieste_tpu_torch.models.gp import sampler as tsam
from trieste_tpu_torch.models.gp.training import pack_params
from trieste_tpu_torch.ops import hmc as thmc

torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-9  # the same arithmetic in both packages


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=F64)


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module", autouse=True)
def quick_jax_compiles():
    """XLA's optimizations off while this module runs: compiling dominates the JAX side's
    time, and the results agree to the same tolerances."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


# -- the JAX draws ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=1)
def _chain_draws(keys, D):
    """One chain's momenta ``[T, D]`` and uniforms ``[T]`` from its transition keys."""

    def one(k):
        k_mom, k_acc = jax.random.split(k)
        return jax.random.normal(k_mom, (D,), jnp.float64), jax.random.uniform(k_acc, dtype=jnp.float64)

    return jax.vmap(one)(keys)


def _hmc_draws(chain_keys, total, D):
    """``(momenta [T, chains, D], uniforms [T, chains])`` of the JAX chains."""
    draws = [_chain_draws(jax.random.split(key, total), D) for key in chain_keys]
    return _t(np.stack([m for m, _ in draws], 1)), _t(np.stack([u for _, u in draws], 1))


def _run_chains_draws(key, num_chains, U, total):
    """``(jitter [chains, U], momenta, uniforms)`` that the JAX ``_run_chains`` draws."""
    k_init, k_chains = jax.random.split(key)
    jitter = 0.5 * jax.random.normal(k_init, (num_chains, U), jnp.float64)
    return (_t(jitter),) + _hmc_draws(jax.random.split(k_chains, num_chains), total, U)


# -- HMC ---------------------------------------------------------------------------------------

MU = np.array([1.0, -2.0])
COV = np.array([[1.0, 0.6], [0.6, 0.8]])
PREC = np.linalg.inv(COV)


def _jax_gaussian(q):
    d = q - MU
    return -0.5 * d @ PREC @ d


def _gaussian(q):
    d = q - _t(MU)
    return -0.5 * torch.einsum("ci,ij,cj->c", d, _t(PREC), d)


def test_hmc_on_a_gaussian_matches_jax_on_the_same_draws():
    chains, warmup, samples = 3, 15, 10
    keys = jax.random.split(jax.random.PRNGKey(4), chains)
    inits = MU + 0.5 * np.asarray(jax.random.normal(jax.random.PRNGKey(5), (chains, 2), jnp.float64))
    want = jax.jit(jax.vmap(lambda k, q0: jhmc.hmc_sample(
        k, _jax_gaussian, q0, num_samples=samples, num_warmup=warmup)))(keys, jnp.asarray(inits))
    momenta, uniforms = _hmc_draws(keys, warmup + samples, 2)
    got = thmc.hmc_sample_from_draws(_gaussian, _t(inits), momenta, uniforms, num_warmup=warmup)
    _close(got.samples, want.samples)
    _close(got.accept_rate, want.accept_rate)
    _close(got.step_size, want.step_size)
    assert got.samples.shape == (chains, samples, 2) and torch.equal(got.num_nonfinite, torch.zeros(chains, dtype=torch.int64))


def test_hmc_recovers_gaussian_moments():
    """The moment check of the JAX package's HMC test, on the port's own draws."""
    g = torch.Generator().manual_seed(1234)
    inits = _t(MU) + 0.1 * torch.randn(8, 2, generator=g, dtype=F64)
    res = thmc.hmc_sample(g, _gaussian, inits, num_samples=400, num_warmup=200, num_leapfrog=16)
    samples = res.samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(samples.mean(0), MU, atol=0.1)
    np.testing.assert_allclose(np.cov(samples.T), COV, atol=0.15)
    assert float(res.accept_rate.mean()) > 0.5


def test_hmc_rejects_a_non_finite_proposal_and_keeps_its_state():
    """A log density that is NaN beyond ``q₀ = 1.5`` (as a failed Cholesky gives): every
    trajectory that leaves the region turns NaN and is rejected, the kept ``q`` stays
    finite, and the non-finite evaluations are counted."""

    def walled(q):
        return torch.where(q[:, 0] < 1.5, -0.5 * torch.sum(q**2, -1), torch.nan)

    g = torch.Generator().manual_seed(0)
    res = thmc.hmc_sample(g, walled, torch.zeros(2, 2, dtype=F64), num_samples=30, num_warmup=10,
                          initial_step_size=0.5)
    assert bool(torch.isfinite(res.samples).all()) and bool((res.samples[..., 0] < 1.5).all())
    assert int(res.num_nonfinite.sum()) > 0 and bool(torch.isfinite(res.step_size).all())
    with pytest.raises(ValueError, match="no sample"):
        thmc.hmc_sample_from_draws(walled, torch.zeros(1, 2, dtype=F64), torch.zeros(3, 1, 2, dtype=F64),
                                   torch.zeros(3, 1, dtype=F64), num_warmup=3)


# -- the model ---------------------------------------------------------------------------------


def _data(n=14, seed=0, capacity=None):
    X = np.random.default_rng(seed).uniform(size=(n, 2))
    Y = np.sum(np.square(X - 0.45), axis=-1, keepdims=True)
    return (JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y), capacity=capacity),
            Dataset.from_arrays(_t(X), _t(Y), capacity=capacity))


def _params_dict(var=1.2, ls=(0.5, 0.7), noise=1e-3, mean=0.1):
    return dict(kind="matern52", variance=var, lengthscales=list(ls), noise_variance=noise,
                mean_constant=mean)


def _jax_params(p):
    return jpost.GPRParams(kernel=jstationary(p["kind"], p["variance"], p["lengthscales"], dtype=jnp.float64),
                           noise_variance=jnp.asarray(p["noise_variance"]),
                           mean_constant=jnp.asarray(p["mean_constant"]))


def _stack_dict(dicts):
    return {k: (dicts[0][k] if k == "kind" else np.stack([np.asarray(d[k], dtype=float) for d in dicts]))
            for k in dicts[0]}


def _models(dicts, jds, tds, **kwargs):
    """A JAX and a port model whose mixtures hold the samples ``dicts``; the prior centred
    on the first."""
    jm = jmcmc.GaussianProcessRegressionMCMC(_jax_params(dicts[0]), jds, **kwargs)
    jm._params_stack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[_jax_params(d) for d in dicts])
    jm._refresh_caches()
    dataset = dict(query_points=_np(tds.query_points), observations=_np(tds.observations),
                   num_points=len(tds))
    tm = convert.gpr_mcmc_from_numpy(dicts[0], _stack_dict(dicts), dataset, device="cpu", dtype=F64)
    return jm, tm


SAMPLES = [_params_dict(), _params_dict(0.8, (0.3, 0.9), 5e-3, -0.2), _params_dict(1.7, (0.9, 0.2), 2e-3, 0.3),
           _params_dict(0.5, (0.6, 0.6), 1e-2, 0.0), _params_dict(2.2, (0.25, 0.4), 1e-4, 0.05)]


def test_log_posterior_and_its_gradient_match_jax():
    """At one ``u [U]`` and at a batch ``[3, U]`` of them."""
    jds, tds = _data()
    template = _params_dict()
    u0 = np.asarray(jpack(_jax_params(template), train_noise=True))
    u = u0 + 0.3 * np.random.default_rng(2).normal(size=(4,) + u0.shape)
    jfn = jax.jit(jax.vmap(jax.value_and_grad(lambda v: jmcmc._log_posterior(
        v, _jax_params(template), jds.query_points, jds.observations, jds.mask, 2.0))))
    want, want_grad = jfn(jnp.asarray(u))
    tparams = convert.gpr_params_from_numpy(**template, device="cpu", dtype=F64)
    for rows in (0, slice(1, 4)):
        tu = _t(u[rows]).requires_grad_(True)
        got = tmcmc._log_posterior(tu, pack_params(tparams), tparams, tds.query_points, tds.observations,
                                   tds.mask, 2.0)
        assert got.shape == tu.shape[:-1]
        (grad,) = torch.autograd.grad(got.sum(), tu)
        _close(got, want[rows])
        _close(grad, want_grad[rows])


def test_log_posterior_decomposition():
    """``log_posterior(u) = MLL(unpack(u)) − ½|(u − u0)/scale|²``, and the MLL alone at u0."""
    from trieste_tpu_torch.models.gp.training import unpack_params

    _, tds = _data()
    template = convert.gpr_params_from_numpy(**_params_dict(), device="cpu", dtype=F64)
    u0 = pack_params(template)
    delta = 0.3 * torch.arange(1.0, u0.shape[0] + 1.0, dtype=F64) / u0.shape[0]
    args = (template, tds.query_points, tds.observations, tds.mask, 1.7)
    mll = tpost.log_marginal_likelihood(unpack_params(u0 + delta, template), *args[1:4])
    _close(tmcmc._log_posterior(u0 + delta, u0, *args), mll - 0.5 * torch.sum((delta / 1.7) ** 2))
    _close(tmcmc._log_posterior(u0, u0, *args), tpost.log_marginal_likelihood(template, *args[1:4]))


@pytest.mark.parametrize("num_samples", [2, 5])
def test_mixture_predict_matches_jax(num_samples):
    jds, tds = _data()
    jm, tm = _models(SAMPLES[:num_samples], jds, tds)
    x = np.random.default_rng(5).uniform(size=(3, 4, 2))
    want_mean, want_var = jmcmc._mixture_predict(jm.params_stack, jm._caches_stack, jnp.asarray(x))
    mean, var = tm.predict(_t(x))
    assert mean.shape == var.shape == (3, 4, 1) and tm.num_hyper_samples == num_samples
    _close(mean, want_mean)
    _close(var, want_var)
    for got, want in zip(tm.predict_y(_t(x)), jm.predict_y(jnp.asarray(x))):
        _close(got, want)
    _close(tm.get_observation_noise(), jm.get_observation_noise())
    _close(tm.get_kernel().lengthscales, jm.get_kernel().lengthscales)
    _close(tm.get_kernel().variance, jm.get_kernel().variance)


def test_mixture_predict_over_chunks_of_samples_is_the_same(monkeypatch):
    _, tds = _data()
    _, tm = _models(SAMPLES, *_data())
    x = _t(np.random.default_rng(6).uniform(size=(9, 2)))
    whole = tm.predict(x)
    monkeypatch.setattr(tmcmc, "MIXTURE_CHUNK_BYTES", 2 * 9 * tds.capacity * 8)  # two samples a chunk
    for got, want in zip(tm.predict(x), whole):
        _close(got, want, rtol=1e-12)


def test_mixture_predict_law_of_total_variance():
    """The mixture against moment matching over each sample's plain GPR prediction; never
    less variance than the average component; one sample is plain GPR."""
    _, tds = _data()
    x = _t(np.random.default_rng(5).uniform(size=(9, 2)))
    _, tm = _models(SAMPLES[:2], *_data())
    preds = [tpost.predict_f_reference(p, tpost.build_cache(p, tds.query_points, tds.observations, tds.mask), x)
             for p in (convert.gpr_params_from_numpy(**d, device="cpu", dtype=F64) for d in SAMPLES[:2])]
    ms, vs = torch.stack([m for m, _ in preds]), torch.stack([v for _, v in preds])
    mean = ms.mean(0)
    mix_mean, mix_var = tm.predict(x)
    _close(mix_mean, mean, rtol=1e-6, atol=1e-9)
    _close(mix_var, (vs + ms**2).mean(0) - mean**2, rtol=1e-6, atol=1e-9)
    assert bool((mix_var >= vs.mean(0) - 1e-12).all())
    _, single = _models(SAMPLES[:1], *_data())
    for got, want in zip(single.predict(x), preds[0]):
        _close(got, want, rtol=1e-7, atol=1e-10)


def test_tight_hyper_posterior_matches_the_map_predictive():
    """Five samples a hair apart predict as the one they surround."""
    near = [dict(SAMPLES[0], variance=SAMPLES[0]["variance"] + 1e-9 * (i - 2)) for i in range(5)]
    _, tds = _data()
    _, tm = _models(near, *_data())
    p = convert.gpr_params_from_numpy(**SAMPLES[0], device="cpu", dtype=F64)
    x = _t(np.random.default_rng(11).uniform(size=(6, 2)))
    mean, var = tpost.predict_f_reference(p, tpost.build_cache(p, tds.query_points, tds.observations, tds.mask), x)
    got_mean, got_var = tm.predict(x)
    _close(got_mean, mean, rtol=1e-6, atol=1e-9)
    _close(got_var, var, rtol=1e-5, atol=1e-9)


def test_joint_samples_match_jax():
    jds, tds = _data()
    jm, tm = _models(SAMPLES, jds, tds)
    x = np.random.default_rng(8).uniform(size=(4, 2))
    key, n = jax.random.PRNGKey(6), 7
    want = jax.jit(lambda k, x: jm.sample(k, x, n))(key, jnp.asarray(x))
    k_idx, k_draw = jax.random.split(key)
    index = torch.as_tensor(np.array(jax.random.randint(k_idx, (n,), 0, len(SAMPLES))))
    eps = _t(np.stack([jax.random.normal(k, (1, 1, 4), jnp.float64) for k in jax.random.split(k_draw, n)]))
    got = tmcmc._sample_from_draws(tm.params_stack, tm.posterior_caches, _t(x), index, eps)
    assert got.shape == (n, 4, 1)
    _close(got, want)
    assert tm.sample(torch.Generator().manual_seed(0), _t(x), n).shape == (n, 4, 1)
    assert tm.sample(torch.Generator().manual_seed(0), _t(np.stack([x, x])), n).shape == (2, n, 4, 1)


def test_mc_ei_on_the_mixture_matches_jax(monkeypatch):
    """JAX's MC EI samples the mixture through ``sample_marginal_partial`` (``eps [S, 1, L]``
    over its moments), the port's through the independent reparametrization sampler over
    ``predict``: the same values on the same draws."""
    jds, tds = _data()
    jm, tm = _models(SAMPLES[:2], jds, tds)
    S, key = 50, jax.random.PRNGKey(2)
    eps = _t(jax.random.normal(key, (S, 1, 1), jnp.float64))
    monkeypatch.setattr(tsam, "standard_normal", lambda generator, shape, like: eps)
    x = np.random.default_rng(3).uniform(size=(11, 1, 2))
    fn = jfun.MonteCarloExpectedImprovement(S, key=key).prepare_acquisition_function(jm, jds)
    want = jax.jit(lambda x: fn(x))(jnp.asarray(x))
    got = tfun.MonteCarloExpectedImprovement(S).prepare_acquisition_function(tm, tds)(_t(x))
    assert got.shape == (11, 1)
    _close(got, want)


def test_trajectory_sampler_draws_under_one_retained_sample():
    _, tm = _models(SAMPLES, *_data())
    trajectory = tm.trajectory_sampler().get_trajectory(torch.Generator().manual_seed(3), batch_size=2)
    variance = trajectory.params.kernel.variance
    assert any(bool(torch.equal(variance, v)) for v in tm.params_stack.kernel.variance)
    values = trajectory(_t(np.random.default_rng(0).uniform(size=(5, 2, 2))))
    assert values.shape == (5, 2, 1) and bool(torch.isfinite(values).all())
    assert tm.reparam_sampler(8).sample(_t(np.zeros((3, 1, 2)))).shape == (3, 8, 1, 1)


def test_build_gpr_mcmc_matches_jax():
    jds, tds = _data()
    jm = jmcmc.build_gpr_mcmc(jds, jsp.Box([0.0, 0.0], [1.0, 1.0]), likelihood_variance=1e-6)
    tm = tmcmc.build_gpr_mcmc(tds, tsp.Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu"),
                              likelihood_variance=1e-6)
    assert tm.num_hyper_samples == jm.num_hyper_samples == 1 and repr(tm) == repr(jm)
    _close(tm.params_stack.kernel.lengthscales, jm.params_stack.kernel.lengthscales)
    _close(tm.params_stack.kernel.variance, jm.params_stack.kernel.variance)
    _close(tm.params_stack.noise_variance, jm.params_stack.noise_variance)
    x = np.random.default_rng(1).uniform(size=(5, 2))
    for got, want in zip(tm.predict(_t(x)), jm.predict(jnp.asarray(x))):
        _close(got, want)


def test_optimize_matches_jax_on_its_draws(monkeypatch):
    """2 chains of 5 samples after 10 warmup transitions on a capacity-16 GP, from the JAX
    model's key: the same thinned stack and predictions."""
    jds, tds = _data(n=10, capacity=16)
    jm = jmcmc.GaussianProcessRegressionMCMC(_jax_params(SAMPLES[0]), jds, num_chains=2, num_samples_per_chain=5,
                                             num_warmup=10, num_retained=4, optimize_key=jax.random.PRNGKey(2))
    sub = jax.random.split(jm._key)[1]
    U = int(jpack(_jax_params(SAMPLES[0])).shape[0])
    draws = _run_chains_draws(sub, 2, U, 15)
    monkeypatch.setattr(tmcmc, "_draw_chains", lambda generator, chains, total, u0: draws)
    want = jm.optimize(jds)
    tm = tmcmc.GaussianProcessRegressionMCMC(convert.gpr_params_from_numpy(**SAMPLES[0], device="cpu", dtype=F64),
                                             tds, num_chains=2, num_samples_per_chain=5, num_warmup=10, num_retained=4)
    got = tm.optimize(tds)
    _close(got.samples, want.samples, rtol=1e-6, atol=1e-9)
    _close(got.accept_rate, want.accept_rate, rtol=1e-6)
    _close(got.step_size, want.step_size, rtol=1e-6)
    assert tm.num_hyper_samples == jm.num_hyper_samples == 4
    for name in ("noise_variance", "mean_constant"):
        _close(getattr(tm.params_stack, name), getattr(jm.params_stack, name), rtol=1e-6, atol=1e-9)
    _close(tm.params_stack.kernel.lengthscales, jm.params_stack.kernel.lengthscales, rtol=1e-6)
    x = np.random.default_rng(7).uniform(size=(5, 2))
    for a, b in zip(tm.predict(_t(x)), jm.predict(jnp.asarray(x))):
        _close(a, b, rtol=1e-6, atol=1e-9)


def test_optimize_disperses_and_update_refreshes_the_caches():
    """The port's own draws: ``optimize`` keeps the configured number of dispersed samples,
    ``predict`` is the mixture of the stack, and ``update`` conditions on new data."""
    _, tds = _data(n=10)
    tm = tmcmc.build_gpr_mcmc(tds, tsp.Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu"), num_chains=4,
                              num_samples_per_chain=6, num_warmup=20, num_retained=8,
                              optimize_generator=torch.Generator().manual_seed(2))
    result = tm.optimize(tds)
    assert tm.num_hyper_samples == 8 and result.samples.shape[:2] == (4, 6)
    assert float(tm.params_stack.kernel.lengthscales.std()) > 1e-4
    x = _t(np.random.default_rng(9).uniform(size=(4, 2)))
    mean, var = tm.predict(x)
    for got, want in zip((mean, var), tmcmc._mixture_predict(tm.params_stack, tm.posterior_caches, x)):
        _close(got, want)
    mean_y, var_y = tm.predict_y(x)
    _close(mean_y, mean)
    assert bool((var_y > var).all())
    bigger = Dataset.from_arrays(torch.cat([tds.trimmed_query_points, x[:2]]),
                                 torch.cat([tds.trimmed_observations, torch.sum((x[:2] - 0.45) ** 2, -1, keepdim=True)]))
    tm.update(bigger)
    _, var_after = tm.predict(x)
    assert bool((var_after[:2] < var[:2]).all())


# -- the slice ---------------------------------------------------------------------------------


@pytest.fixture
def jax_pools(monkeypatch):
    """Record the uniforms of the JAX package's box samples; the port's box samples scale
    them."""
    pools = []
    sample = jsp.Box.sample

    def record(self, key, n):
        pools.append(np.asarray(jax.random.uniform(key, (n, self.dimension), dtype=jnp.float64)))
        return sample(self, key, n)

    def replay(self, generator, n):
        u = pools.pop(0)
        assert u.shape == (n, self.dimension)
        return self._scale(_t(u))

    monkeypatch.setattr(jsp.Box, "sample", record)
    monkeypatch.setattr(tsp.Box, "sample", replay)
    return pools


def test_mc_ei_on_gpr_mcmc_through_the_loop_matches_jax_over_two_steps(monkeypatch, jax_pools):
    """Two EGO steps of MC EI over ``build_gpr_mcmc`` (2 chains of 5 samples, 10 warmup) on
    ScaledBranin from 6 points at capacity 16 in both packages: the JAX run first, its HMC draws, seed
    pools and MC base draws replayed into the port's run, the port's observer holding each
    point to the JAX package's."""
    chain_draws = []
    run_chains = jmcmc._run_chains

    def recording(key, template, X, Y, mask, u0, num_chains, num_samples, num_warmup, *rest):
        chain_draws.append(_run_chains_draws(key, num_chains, u0.shape[0], num_warmup + num_samples))
        return run_chains(key, template, X, Y, mask, u0, num_chains, num_samples, num_warmup, *rest)

    monkeypatch.setattr(jmcmc, "_run_chains", recording)
    monkeypatch.setattr(tmcmc, "_draw_chains", lambda generator, chains, total, u0: chain_draws.pop(0))
    S, key = 64, jax.random.PRNGKey(8)
    eps = _t(jax.random.normal(key, (S, 1, 1), jnp.float64))
    monkeypatch.setattr(tsam, "standard_normal", lambda generator, shape, like: eps)

    X = np.random.default_rng(4).uniform(size=(6, 2))
    jspace, tspace = jsp.Box([0.0, 0.0], [1.0, 1.0]), tsp.Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu")
    jds = JDataset.from_arrays(jnp.asarray(X), jobj.scaled_branin(jnp.asarray(X)), capacity=16)
    tds = Dataset.from_arrays(_t(X), _t(jds.trimmed_observations), capacity=16)
    config = dict(likelihood_variance=1e-6, num_chains=2, num_samples_per_chain=5, num_warmup=10)
    asked = []

    def jobs(qp):
        y = jobj.scaled_branin(qp)
        asked.append((np.asarray(qp), np.asarray(y)))
        return JDataset.from_arrays(qp, y)

    def tobs(qp):
        x, y = asked.pop(0)
        np.testing.assert_allclose(qp.numpy(), x, atol=1e-6)
        return Dataset.from_arrays(_t(x), _t(y))

    jresult = jt.BayesianOptimizer(jobs, jspace).optimize(
        2, jds, jmcmc.build_gpr_mcmc(jds, jspace, optimize_key=jax.random.PRNGKey(3), **config),
        jrule.EfficientGlobalOptimization(jfun.MonteCarloExpectedImprovement(S, key=key),
                                          optimizer=jopt.generate_continuous_optimizer(200, 2)),
        key=jax.random.PRNGKey(9), track_state=False)
    assert jresult.is_ok and len(chain_draws) == 3
    want = [x for x, _ in asked]
    tresult = BayesianOptimizer(tobs, tspace).optimize(
        2, tds, tmcmc.build_gpr_mcmc(tds, tspace, **config),
        trule.EfficientGlobalOptimization(tfun.MonteCarloExpectedImprovement(S),
                                          optimizer=topt.generate_continuous_optimizer(200, 2)),
        track_state=False)
    assert tresult.is_ok, tresult.final_result
    assert not chain_draws and not asked and not jax_pools
    got = tresult.try_get_final_dataset()
    assert len(got) == 8 and got.capacity == 16
    np.testing.assert_allclose(got.trimmed_query_points[6:].numpy(), np.concatenate(want), atol=1e-6)
    tm, jm = tresult.try_get_final_model(), jresult.try_get_final_model()
    _close(tm.params_stack.kernel.lengthscales, jm.params_stack.kernel.lengthscales, rtol=1e-6)

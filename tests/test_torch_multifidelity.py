"""The port's multifidelity BO on the CPU, against the JAX package in float64.

The fidelity helpers and their errors; the linear multifidelity problems and their minima;
AR(1)'s predictions, covariance with the top fidelity and samples from given parameters
(rtol 1e-9); its fit from the JAX package's starts (``rho`` and the hyperparameters at
rtol 1e-5, each level's fit objective at 1e-9: the optima are flat); the builder; NARGP's
prediction and covariance on the JAX draws (rtol 1e-9); MUMBO's values and gradients on the
JAX minimum values, its builder on the JAX grid and Gumbel draws, ``CostWeighting`` and the
``mumbo`` form; and the slice: two EGO steps of MUMBO × CostWeighting on Linear2Fidelity
through ``BayesianOptimizer.optimize`` in both packages, the JAX run's seed pools, grids,
Gumbel draws and fit restarts replayed into the port's (query points at atol 1e-6; rho and
the final predictions at rtol 1e-4, Linear2Fidelity's linear residual making the residual
fit a ridge).

Every AR(1) fit here runs at one shape, level 0 at capacity 16 and level 1 at 8 (a nested
design of 12 and 6 points, two more points at most), so the JAX side compiles its fits once.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import Partial

import trieste_tpu as jt
from trieste_tpu import data as jdata
from trieste_tpu import space as jsp
from trieste_tpu.acquisition import optimizer as jopt
from trieste_tpu.acquisition import rule as jrule
from trieste_tpu.acquisition import sampler as jsampler
from trieste_tpu.acquisition.combination import Product as JProduct
from trieste_tpu.acquisition.function import entropy as jent
from trieste_tpu.acquisition.function import functional as jfl
from trieste_tpu.models.gp import multifidelity as jmf
from trieste_tpu.models.gp import training as jtrain
from trieste_tpu.models.gp.gpr import GaussianProcessRegression as JGPR
from trieste_tpu.models.gp import posterior as jpost
from trieste_tpu.models.gp import priors as jpriors
from trieste_tpu.models.gp.posterior import GPRParams as JParams
from trieste_tpu.objectives import multifidelity_objectives as jmo
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu_torch import BayesianOptimizer, Dataset, convert
from trieste_tpu_torch import data as tdata
from trieste_tpu_torch import space as tsp
from trieste_tpu_torch.acquisition import Product
from trieste_tpu_torch.acquisition import optimizer as topt
from trieste_tpu_torch.acquisition import rule as trule
from trieste_tpu_torch.acquisition import sampler as tsampler
from trieste_tpu_torch.acquisition.function import entropy as tent
from trieste_tpu_torch.acquisition.function import functional as tfl
from trieste_tpu_torch.models import SupportsCovarianceWithTopFidelity
from trieste_tpu_torch.models.gp import gpr as tgpr
from trieste_tpu_torch.models.gp import multifidelity as tmf
from trieste_tpu_torch.models.gp import posterior as tpost
from trieste_tpu_torch.models.gp import priors as tpriors
from trieste_tpu_torch.models.gp import training as ttrain
from trieste_tpu_torch.objectives import multifidelity_objectives as tmo
from trieste_tpu_torch.observer import OBJECTIVE

torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-9  # the same arithmetic in both packages


@pytest.fixture(scope="module", autouse=True)
def quick_jax_compiles():
    """XLA's optimizations off while this module runs: compiling dominates the JAX side's
    time, and the results agree to the same tolerances."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=F64)


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


JINPUT = jmo.Linear2Fidelity.search_space
TINPUT = tsp.Box([0.0], [1.0], dtype=F64, device="cpu")


def _fidelity_spaces(n=2):
    return jmo.Linear2Fidelity.fidelity_search_space if n == 2 else jmo._fidelity_space(n, JINPUT), \
        tmo.fidelity_space(n, TINPUT, "cpu")


def test_fidelity_helpers_and_their_errors_match_jax():
    rng = np.random.default_rng(0)
    qp = np.concatenate([rng.uniform(size=(7, 2)), rng.integers(0, 3, size=(7, 1))], -1).astype(float)
    obs = rng.normal(size=(7, 1))
    for got, want in zip(tdata.check_and_extract_fidelity_query_points(_t(qp), 2),
                         jdata.check_and_extract_fidelity_query_points(jnp.asarray(qp), 2)):
        _close(got, want, rtol=0)
    jds, tds = jdata.Dataset.from_arrays(jnp.asarray(qp), jnp.asarray(obs)), Dataset.from_arrays(_t(qp), _t(obs))
    for got, want in zip(tdata.split_dataset_by_fidelity(tds, 3), jdata.split_dataset_by_fidelity(jds, 3)):
        assert len(got) == int(want.num_points) and got.capacity == want.capacity and got.dimension == 2
        _close(got.query_points, want.query_points, rtol=0)
        _close(got.observations, want.observations, rtol=0)
    _close(tdata.add_fidelity_column(_t(qp[:, :2]), 2), jdata.add_fidelity_column(jnp.asarray(qp[:, :2]), 2), rtol=0)
    for bad, message in (([[0.5, -1.0]], "non-negative, got minimum -1.0"), ([[0.5, 0.5]], "integer values"),
                         ([[0.5, 3.0]], "3.0 exceeds the maximum fidelity 2"), ([[0.5]], "enough dimensions")):
        for check in (tdata.check_and_extract_fidelity_query_points, jdata.check_and_extract_fidelity_query_points):
            with pytest.raises(ValueError, match=message):
                check(_t(bad) if check is tdata.check_and_extract_fidelity_query_points else jnp.asarray(bad), 2)
    for split in (tdata.split_dataset_by_fidelity, jdata.split_dataset_by_fidelity):
        with pytest.raises(ValueError, match="num_fidelities must be positive"):
            split(tds if split is tdata.split_dataset_by_fidelity else jds, 0)


@pytest.mark.parametrize("n", [2, 3, 5])
def test_linear_problems_and_their_minima_match_jax(n):
    jproblem, tproblem = getattr(jmo, f"Linear{n}Fidelity"), getattr(tmo, f"Linear{n}Fidelity")
    assert tproblem.num_fidelities == n and tproblem.name == jproblem.name
    np.testing.assert_array_equal(tproblem.minimizers, jproblem.minimizers)
    np.testing.assert_array_equal(tproblem.minimum, jproblem.minimum)
    x = np.random.default_rng(n).uniform(size=(20, 1))
    for fid in range(n):
        q = np.concatenate([x, np.full_like(x, fid)], -1)
        _close(tmo.linear_multifidelity(_t(q)), jmo.linear_multifidelity(jnp.asarray(q)), rtol=1e-13)
    top = _t(np.concatenate([tproblem.minimizers, [[n - 1.0]]], -1))
    _close(tmo.linear_multifidelity(top)[0], tproblem.minimum, rtol=1e-6)
    grid = torch.linspace(0, 1, 100001, dtype=F64)[:, None]
    values = tmo.linear_multifidelity(torch.cat([grid, torch.full_like(grid, n - 1.0)], -1))
    assert float(values.min()) >= float(tproblem.minimum[0]) - 1e-6
    jspace, tspace = _fidelity_spaces(n)
    assert tspace.subspace_tags == jspace.subspace_tags and tspace.dimension == 2
    _close(tspace.get_subspace("fidelity").points, jspace.get_subspace("fidelity").points, rtol=0)


HYPER = ((1.3, [0.2], 0.1), (0.4, [0.35], -0.3), (0.2, [0.5], 0.05))


def _design(n_per_level, seed=0):
    """A nested design on the unit interval, ``n_per_level[f]`` points at fidelity ``f``."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n_per_level[0], 1))
    parts = [np.concatenate([X[:n], np.full((n, 1), float(f))], -1) for f, n in enumerate(n_per_level)]
    qp = np.concatenate(parts)
    return qp, np.array(jmo.linear_multifidelity(jnp.asarray(qp)))


def _ar1_pair(n_per_level=(12, 6), rho=(1.9, 0.7), noise=1e-4):
    """An AR(1) model in both packages from given hyperparameters, each residual level on
    made-up residuals."""
    qp, obs = _design(n_per_level)
    jlevels, tlevels = [], []
    for f, n in enumerate(n_per_level):
        rows = qp[:, -1] == f
        x, y = qp[rows, :1], obs[rows] if f == 0 else np.sin(7 * qp[rows, :1]) * 0.3
        var, ls, mean = HYPER[f]
        jlevels.append(JGPR(JParams(jstationary("matern52", var, jnp.asarray(ls), dtype=jnp.float64),
                                    jnp.asarray(noise), jnp.asarray(mean)),
                            jdata.Dataset.from_arrays(jnp.asarray(x), jnp.asarray(y))))
        tlevels.append((dict(kind="matern52", variance=var, lengthscales=ls, noise_variance=noise,
                             mean_constant=mean), dict(query_points=x, observations=y, num_points=n,
                                                       capacity=jlevels[-1].get_internal_data().capacity)))
    S = len(n_per_level)
    jm = jmf.MultifidelityAutoregressive(jlevels, rho=jnp.asarray(rho[: S - 1]))
    tm = convert.multifidelity_autoregressive_from_numpy(rho[: S - 1], tlevels, device="cpu", dtype=F64)
    return jm, tm


def _queries(S, n=11, seed=1):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(size=(n, 1)), rng.integers(0, S, size=(n, 1))], -1).astype(float)


@pytest.mark.parametrize("S", [2, 3])
def test_ar1_predictions_match_jax(S):
    jm, tm = _ar1_pair((12, 6, 4)[:S])
    assert isinstance(tm, SupportsCovarianceWithTopFidelity) and tm.num_fidelities == S
    q = _queries(S)
    for g, w in zip(tm.predict(_t(q)), jm.predict(jnp.asarray(q))):
        assert g.shape == w.shape == (11, 1)
        _close(g, w)
    _close(tm.covariance_with_top_fidelity(_t(q)), jm.covariance_with_top_fidelity(jnp.asarray(q)))
    # at the top fidelity the covariance with itself is the variance; unchecked twins agree
    top = _t(q).clone()
    top[:, -1] = S - 1
    _close(tm.covariance_with_top_fidelity(top), tm.predict(top)[1], rtol=1e-12)
    _close(tm.predict_unchecked(_t(q))[0], tm.predict(_t(q))[0], rtol=0)
    key = jax.random.PRNGKey(2)
    want = jm.sample(key, jnp.asarray(q), 3)
    eps = np.asarray(jax.random.normal(key, (3, 11, 1), jnp.float64))
    mean, var = tm.predict(_t(q))
    _close(mean[None] + torch.sqrt(var)[None] * _t(eps), want)
    assert tm.sample(torch.Generator().manual_seed(0), _t(q), 3).shape == (3, 11, 1)
    with pytest.raises(ValueError, match="exceeds the maximum fidelity"):
        tm.predict(_t([[0.5, float(S)]]))
    with pytest.raises(ValueError, match=">= 2 fidelities"):
        tmf.MultifidelityAutoregressive(tm._models[:1])


@pytest.fixture
def jax_fits(monkeypatch):
    """Record the fit restarts of the JAX package's AR(1) fits, level 0's from its GPR's
    key and each residual level's from ``PRNGKey(level)`` on its template, and make the
    port's fits start from them."""
    gpr_starts, residual_starts = [], []
    gpr_optimize, ar1_optimize = JGPR.optimize, jmf.MultifidelityAutoregressive.optimize
    randomize = jax.jit(jtrain.randomize_starts, static_argnums=(2, 3))

    def record_gpr(self, dataset):
        sub = jax.random.split(self._key)[1]
        gpr_starts.append(np.asarray(randomize(sub, self.params, self._num_kernel_samples,
                                               self._train_noise, priors=self._priors)))
        return gpr_optimize(self, dataset)

    def record_ar1(self, dataset):
        for level, model in enumerate(self._models[1:], start=1):
            residual_starts.append(np.asarray(randomize(jax.random.PRNGKey(level), model.params, 6,
                                                        model._train_noise)))
        return ar1_optimize(self, dataset)

    def replay_gpr(generator, params, X, Y, mask, *, num_starts, train_noise, max_iters, priors,
                pool_sharding):
        return ttrain.fit_gpr_from_starts(_t(gpr_starts.pop(0)), params, X, Y, mask,
                                          train_noise=train_noise, max_iters=max_iters, priors=priors,
                                          pool_sharding=pool_sharding)

    def replay_residual(generator, params, num_starts, train_noise):
        assert num_starts == 6
        return _t(residual_starts.pop(0))

    monkeypatch.setattr(JGPR, "optimize", record_gpr)
    monkeypatch.setattr(jmf.MultifidelityAutoregressive, "optimize", record_ar1)
    monkeypatch.setattr(tgpr, "fit_gpr", replay_gpr)
    monkeypatch.setattr(tmf, "randomize_starts", replay_residual)
    return gpr_starts, residual_starts


def _data_pair(qp, obs):
    return jdata.Dataset.from_arrays(jnp.asarray(qp), jnp.asarray(obs)), Dataset.from_arrays(_t(qp), _t(obs))


def _built_pair(jds, tds, S=2):
    jm = jmf.build_multifidelity_autoregressive_models(jds, S, JINPUT)
    tm = tmf.build_multifidelity_autoregressive_models(tds, S, TINPUT)
    return jm, tm


def _fit_objective(model, post, priors):
    """What a level's fit minimizes: the negative log marginal likelihood of its data, less
    the log prior density at level 0 (a MAP fit)."""
    ds = model.get_internal_data()
    lml = post.log_marginal_likelihood(model.params, ds.query_points, ds.observations, ds.mask)
    return -lml - (priors.log_prior_density(model.params.kernel, model._priors) if priors else 0.0)


def _ar1_agree(tm, jm, rtol=1e-5, levels=None):
    """``rho`` and each level's hyperparameters and data at rtol 1e-5, each level's fit
    objective at rtol 1e-9: the optima are flat (level 0's lengthscale and variance trade
    off), the two packages' L-BFGS runs stop up to a few 1e-6 apart on them, and the
    objective differs to second order in that gap. ``levels`` limits the check to the first
    levels, without ``rho``."""
    if levels is None:
        _close(tm.rho, jm.rho, rtol=rtol)
    for level, (g, w) in enumerate(zip(tm._models[:levels], jm._models[:levels])):
        _close(g.params.kernel.variance, w.params.kernel.variance, rtol=rtol)
        _close(g.params.kernel.lengthscales, w.params.kernel.lengthscales, rtol=rtol)
        _close(g.params.mean_constant, w.params.mean_constant, rtol=rtol, atol=1e-9)
        _close(g.get_internal_data().observations, w.get_internal_data().observations, rtol=rtol, atol=1e-9)
        _close(_fit_objective(g, tpost, tpriors if level == 0 else None),
               _fit_objective(w, jpost, jpriors if level == 0 else None))


def test_builder_and_ar1_fit_match_jax_from_its_starts(jax_fits):
    """The builder's levels at the fixed likelihood variance 1e-6, then the fit: level 0's
    ten MAP restarts, then ``rho`` and the residual GP from six starts. Level 1 is
    ``1.5 f_0 + 2 sin(8x)``: on Linear2Fidelity the residual is linear in ``x`` and its GP's
    optimum a ridge (variance, lengthscale and mean trade off), where the two packages stop
    at different points of equal likelihood."""
    qp, obs = _design((12, 6))
    hi = qp[:, -1] == 1
    obs[hi] = 1.5 * obs[:12][:6] + 2.0 * np.sin(8.0 * qp[hi, :1])
    jds, tds = _data_pair(qp, obs)
    jm, tm = _built_pair(jds, tds)
    for g, w in zip(tm._models, jm._models):
        _close(g.params.noise_variance, w.params.noise_variance, rtol=0)
        _close(g.params.kernel.lengthscales, w.params.kernel.lengthscales)
        _close(g._priors.var_loc, w._priors.var_loc)
        assert g.get_internal_data().capacity == w.get_internal_data().capacity
    _close(tm.rho, jm.rho, rtol=0)
    jm.optimize(jds)
    tm.optimize(tds)
    assert not any(jax_fits)
    _ar1_agree(tm, jm)
    assert abs(float(tm.rho[0]) - 1.5) < 0.2
    q = _queries(2)
    for g, w in zip(tm.predict(_t(q)), jm.predict(jnp.asarray(q))):
        _close(g, w, rtol=1e-5, atol=1e-9)
    # the port's own draw: a generator seeded by the level, the JAX layout
    starts = ttrain.randomize_starts(torch.Generator().manual_seed(1), tm._models[1].params, 6, False)
    assert starts.shape == (6, 3)


def _nargp_pair():
    """Two NARGP levels from given hyperparameters, the upper one over ``[x, f_0(x)]``."""
    qp, obs = _design((12, 6))
    lo, hi = qp[:, -1] == 0, qp[:, -1] == 1
    x_hi = np.concatenate([qp[hi, :1], obs[lo][:6]], -1)
    jlevels, tlevels = [], []
    for (x, y), (var, ls) in zip(((qp[lo, :1], obs[lo]), (x_hi, obs[hi])), ((1.3, [0.2]), (2.1, [0.3, 4.0]))):
        jlevels.append(JGPR(JParams(jstationary("matern52", var, jnp.asarray(ls), dtype=jnp.float64),
                                    jnp.asarray(1e-3), jnp.asarray(0.1)),
                            jdata.Dataset.from_arrays(jnp.asarray(x), jnp.asarray(y))))
        tlevels.append((dict(kind="matern52", variance=var, lengthscales=ls, noise_variance=1e-3,
                             mean_constant=0.1), dict(query_points=x, observations=y, num_points=len(x),
                                                      capacity=jlevels[-1].get_internal_data().capacity)))
    jm = jmf.MultifidelityNonlinearAutoregressive(jlevels, num_monte_carlo=8, key=jax.random.PRNGKey(4))
    tm = convert.multifidelity_nonlinear_autoregressive_from_numpy(tlevels, 8, device="cpu", dtype=F64)
    return jm, tm


def _nargp_eps(key, S, S_mc, N):
    """The draws of one JAX NARGP call: the model's key splits, then one key per level."""
    key, sub = jax.random.split(key)
    keys = jax.random.split(sub, S)
    return key, np.stack([np.asarray(jax.random.normal(k, (S_mc, N, 1), jnp.float64)) for k in keys])


def test_nargp_predictions_match_jax_on_its_draws(monkeypatch):
    """``predict`` and ``covariance_with_top_fidelity`` on the JAX draws; the port
    predicts each upper level over the ``S_mc·N`` rows at once."""
    jm, tm = _nargp_pair()
    q = _queries(2, n=9)
    key = jax.random.PRNGKey(4)
    draws = []
    for _ in range(2):
        key, eps = _nargp_eps(key, 2, 8, 9)
        draws.append(eps)
    monkeypatch.setattr(tmf, "standard_normal", lambda generator, shape, like: _t(draws.pop(0)))
    rows = []
    predict = tm._models[1].predict
    monkeypatch.setattr(tm._models[1], "predict", lambda x: (rows.append(x.shape), predict(x))[1])
    for g, w in zip(tm.predict(_t(q)), jm.predict(jnp.asarray(q))):
        assert g.shape == (9, 1)
        _close(g, w)
    assert rows == [(72, 2)]
    _close(tm.covariance_with_top_fidelity(_t(q)), jm.covariance_with_top_fidelity(jnp.asarray(q)))
    assert not draws
    with pytest.raises(ValueError, match="need >= 2 fidelities"):
        tmf.MultifidelityNonlinearAutoregressive(tm._models[:1])


def test_nargp_fit_augments_each_level_with_the_chain_mean(monkeypatch):
    _, tm = _nargp_pair()
    jm, _ = _nargp_pair()
    seen = []
    monkeypatch.setattr(tgpr.GaussianProcessRegression, "optimize", lambda self, ds: seen.append(ds))
    qp, obs = _design((12, 6))
    tm.optimize(Dataset.from_arrays(_t(qp), _t(obs)))
    assert [ds.dimension for ds in seen] == [1, 2] and len(seen[1]) == 6
    want, _ = jmf._chain_mean(jm._models[:1], jnp.asarray(qp[qp[:, -1] == 1, :1]))
    _close(seen[1].trimmed_query_points[:, 1:], want)


def _mumbo_fn_jax(jm, samples):
    top = jent._TopFidelityView(jm, jm.num_fidelities - 1)
    return Partial(jent._mumbo_fn, Partial(jm.predict), Partial(jm.covariance_with_top_fidelity),
                   Partial(top.predict), jnp.asarray(0.0), jnp.asarray(samples))


@pytest.mark.parametrize("S", [2, 3])
def test_mumbo_values_and_gradients_match_jax(S):
    """The minimum values lie below the top fidelity's least mean, as a Gumbel sampler's
    do: above it, ``1 − Φ(γ)`` is a difference of nearly equal numbers in both packages."""
    jm, tm = _ar1_pair((12, 6, 4)[:S])
    grid = torch.linspace(0, 1, 1001, dtype=F64)[:, None]
    least = float(tm.predict(torch.cat([grid, torch.full_like(grid, S - 1.0)], -1))[0].min())
    samples = least - np.array([[1.0], [0.5], [0.3], [0.15]])
    x = _queries(S, n=13, seed=5)[:, None, :]
    value_and_grad = jax.jit(jax.value_and_grad(lambda f, q: jnp.sum(f(q)), argnums=1))
    jfn = _mumbo_fn_jax(jm, samples)
    want, jgrad = value_and_grad(jfn, jnp.asarray(x))
    tfn = tent._mumbo_partial(tm, torch.zeros((), dtype=F64), _t(samples))
    xt = _t(x).requires_grad_(True)
    got = tfn(xt)
    assert got.shape == (13, 1) and bool((got >= 0).all())
    (grad,) = torch.autograd.grad(got.sum(), xt)
    _close(got[:, 0], jax.jit(lambda f, q: f(q))(jfn, jnp.asarray(x))[:, 0])
    _close(grad[..., :-1], jgrad[..., :-1], rtol=1e-8, atol=1e-12)


def test_cost_weighting_and_the_mumbo_form_match_jax():
    jm, tm = _ar1_pair()
    samples = np.array([[-6.8], [-6.1]])
    x = _queries(2, n=7, seed=6)[:, None, :]
    jfn, tfn = _mumbo_fn_jax(jm, samples), tent._mumbo_partial(tm, torch.zeros((), dtype=F64), _t(samples))
    costs = [1.0, 10.0]
    jcost = jent.CostWeighting(costs).prepare_acquisition_function(jm)
    tds = Dataset.from_arrays(_t(x[:, 0]), _t(np.ones((7, 1))))
    tcost = tent.CostWeighting(costs).prepare_acquisition_function(tm, tds)
    _close(tcost(_t(x)), jcost(jnp.asarray(x)), rtol=0)
    assert tent.CostWeighting(costs).update_acquisition_function(tcost, tm) is tcost
    weighted = tent.CostWeighting(costs).apply_to(tfn)(_t(x))
    _close(weighted, jax.jit(lambda f, q: f(q))(jent.CostWeighting(costs).apply_to(jfn), jnp.asarray(x)))
    _close(weighted[:, 0], tfn(_t(x))[:, 0] / np.where(x[:, 0, -1] == 0, 1.0, 10.0), rtol=1e-14)
    # the JAX form reads the model's observation noise, which AR(1) has none of: both raise
    for mumbo, m, s in ((jfl.mumbo, jm, jnp.asarray(samples)), (tfl.mumbo, tm, _t(samples))):
        with pytest.raises(AttributeError, match="get_observation_noise"):
            mumbo(m, s)


def _jax_gumbel_uniforms(key, n):
    return np.asarray(jax.random.uniform(key, (n, 1), dtype=jnp.float64, minval=1e-12, maxval=1.0 - 1e-12))


@pytest.fixture
def jax_draws(monkeypatch):
    """Record the JAX package's fidelity-space samples (MUMBO's grids and the seed pools)
    and Gumbel uniforms as it draws them; the port replays them."""
    samples, uniforms = [], []
    sample, gumbel = jsp.TaggedProductSearchSpace.sample, jsampler.GumbelSampler.sample

    def record_sample(self, key, n):
        out = sample(self, key, n)
        samples.append(np.asarray(out))
        return out

    def record_gumbel(self, model, sample_size, at, *, key=None):
        uniforms.append(_jax_gumbel_uniforms(key, sample_size))
        return gumbel(self, model, sample_size, at, key=key)

    def replay_sample(self, generator, n):
        out = samples.pop(0)
        assert out.shape == (n, self.dimension)
        return _t(out)

    def replay_uniform(generator, shape, like):
        u = uniforms.pop(0)
        assert u.shape == shape
        return _t(u)

    monkeypatch.setattr(jsp.TaggedProductSearchSpace, "sample", record_sample)
    monkeypatch.setattr(jsampler.GumbelSampler, "sample", record_gumbel)
    monkeypatch.setattr(tsp.TaggedProductSearchSpace, "sample", replay_sample)
    monkeypatch.setattr(tsampler, "uniform", replay_uniform)
    return samples, uniforms


def test_mumbo_builder_matches_jax_on_its_draws(jax_draws):
    """The grid moved to the top fidelity, the Gumbel minimum values of the top fidelity
    on it, and the function; a model without ``covariance_with_top_fidelity`` or an empty
    dataset is refused as in the JAX package."""
    jm, tm = _ar1_pair()
    jspace, tspace = _fidelity_spaces()
    qp, obs = _design((12, 6))
    jds, tds = _data_pair(qp, obs)
    jfn = jent.MUMBO(jspace, grid_size=50).prepare_acquisition_function(jm, jds)
    tfn = tent.MUMBO(tspace, grid_size=50).prepare_acquisition_function(tm, tds)
    _close(tfn.args[-1], jfn.args[-1], rtol=1e-10)  # the minimum values
    _close(tfn.args[-2], jfn.args[-2], rtol=0)  # no observation noise: 0
    x = _queries(2, n=9, seed=7)[:, None, :]
    _close(tfn(_t(x)), jax.jit(lambda f, q: f(q))(jfn, jnp.asarray(x)), rtol=1e-8)
    assert not any(jax_draws)
    with pytest.raises(ValueError, match="multifidelity model"):
        tent.MUMBO(tspace).prepare_acquisition_function(tm._models[0], tds)
    with pytest.raises(ValueError, match="non-empty dataset"):
        tent.MUMBO(tspace).prepare_acquisition_function(tm, Dataset.from_arrays(_t(qp[:0]), _t(obs[:0])))


def test_mumbo_cost_weighting_through_the_loop_matches_jax_over_two_steps(jax_draws, jax_fits):
    """Two EGO steps of ``Product(MUMBO, CostWeighting([2, 4]))`` on Linear2Fidelity from a
    nested design of 12 and 6 points, ``build_multifidelity_autoregressive_models`` fitted
    at every step, in both packages: the JAX run first, then the port's on its draws, its
    observer holding each point to the JAX package's and observing the latter."""
    qp, obs = _design((12, 6), seed=8)
    jds, tds = _data_pair(qp, obs)
    jm, tm = _built_pair(jds, tds)
    jspace, tspace = _fidelity_spaces()
    asked = []

    def jobserver(q):
        asked.append(np.asarray(q))
        return jdata.Dataset.from_arrays(q, jmo.linear_multifidelity(q))

    def tobserver(q):
        want = asked.pop(0)
        np.testing.assert_allclose(_np(q), want, atol=1e-6)
        return Dataset.from_arrays(_t(want), tmo.linear_multifidelity(_t(want)))

    jrule_ = jrule.EfficientGlobalOptimization(
        JProduct(jent.MUMBO(jspace, grid_size=200).using(OBJECTIVE),
                 jent.CostWeighting([2.0, 4.0]).using(OBJECTIVE)),
        optimizer=jopt.generate_continuous_optimizer(96, 3))
    trule_ = trule.EfficientGlobalOptimization(
        Product(tent.MUMBO(tspace, grid_size=200).using(OBJECTIVE),
                tent.CostWeighting([2.0, 4.0]).using(OBJECTIVE)),
        optimizer=topt.generate_continuous_optimizer(96, 3))
    jresult = jt.BayesianOptimizer(jobserver, jspace).optimize(
        2, jds, jm, jrule_, key=jax.random.PRNGKey(10), track_state=False)
    tresult = BayesianOptimizer(tobserver, tspace).optimize(2, tds, tm, trule_, track_state=False)
    assert jresult.is_ok and tresult.is_ok, tresult.final_result
    assert not any(jax_draws) and not any(jax_fits) and not asked
    got, want = tresult.try_get_final_dataset(), jresult.try_get_final_dataset()
    assert len(got) == int(want.num_points) == 20
    np.testing.assert_allclose(_np(got.trimmed_query_points), np.asarray(want.trimmed_query_points), atol=1e-6)
    # Linear2Fidelity's residual is linear in x: its likelihood keeps rising along a ridge
    # towards an infinite lengthscale and variance, and the two packages' fits stop at
    # different points of it; rho and what the models predict agree to 1e-4
    _close(tm.rho, jm.rho, rtol=1e-4)
    _ar1_agree(tm, jm, levels=1)
    q = _queries(2, n=9, seed=11)
    for g, w in zip(tm.predict(_t(q)), jm.predict(jnp.asarray(q))):
        _close(g, w, rtol=1e-4, atol=1e-9)

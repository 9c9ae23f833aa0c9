"""The port's sparse GP models on the CPU, against the JAX package in float64.

SGPR's bound, cache and predictions, SVGP's predictions, bound and optimal ``q`` at rtol
1e-9; both L-BFGS fits from the JAX package's starts (loss at rtol 1e-6, parameters at
1e-5); the minibatch fit for 50 Adam steps on the JAX package's indices (rtol 1e-8); each
inducing-point selector on the JAX draws (the DPP's chosen points exactly); the inducing
variables; the decoupled inducing trajectory given its draws (rtol 1e-9); the builders
with the JAX package's inducing points fed in; and the slice: two EGO steps of SGPR with
the conditional-improvement selector and two of SVGP through ``BayesianOptimizer.optimize``
in both packages, the JAX run's seed pools, initial centroids and fit restarts replayed
into the port's (query points at atol 1e-6).

The JAX side's fits are compiled once for the module: every test fits at one shape
(capacity 16, two dimensions, four inducing points, five restarts), the one the slice's
models fit at.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trieste_tpu as jt
from trieste_tpu import space as jsp
from trieste_tpu.acquisition import optimizer as jopt
from trieste_tpu.acquisition import rule as jrule
from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models.gp import builders as jbuilders
from trieste_tpu.models.gp import inducing_points as jind
from trieste_tpu.models.gp import priors as jpriors
from trieste_tpu.models.gp import sampler as jsampler
from trieste_tpu.models.gp import sparse as js
from trieste_tpu.objectives import ScaledBranin as JScaledBranin
from trieste_tpu.objectives import utils as jobj
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu_torch import BayesianOptimizer, Dataset, convert
from trieste_tpu_torch import space as tsp
from trieste_tpu_torch.acquisition import optimizer as topt
from trieste_tpu_torch.acquisition import rule as trule
from trieste_tpu_torch.models import SupportsGetInducingVariables
from trieste_tpu_torch.models.gp import builders as tbuilders
from trieste_tpu_torch.models.gp import inducing_points as tind
from trieste_tpu_torch.models.gp import sampler as tsampler
from trieste_tpu_torch.models.gp import sparse as ts
from trieste_tpu_torch.objectives import ScaledBranin, mk_observer

torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-9  # closed forms: the same arithmetic in both packages
CAP, M, R = 16, 4, 5  # the one shape every JAX fit here compiles for


@pytest.fixture(scope="module", autouse=True)
def quick_jax_compiles():
    """XLA's optimizations off while this module runs: compiling dominates the JAX side's
    time, and the results agree to the same tolerances."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=F64)


def _jit(f, *args):
    """``f(*args)`` compiled whole: JAX run op by op compiles every primitive anew."""
    return jax.jit(f)(*args)


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _data(n=10, seed=0):
    """ScaledBranin at ``n`` points, capacity 16 (the padding masked), in both packages."""
    X = np.random.default_rng(seed).uniform(size=(n, 2))
    Y = np.asarray(JScaledBranin.objective(jnp.asarray(X)))
    return (JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y), capacity=CAP),
            Dataset.from_arrays(_t(X), _t(Y), capacity=CAP))


HYPER = ("matern52", 1.3, [0.3, 0.5], 1e-3, 0.2)


def _sgpr_params(Z):
    kind, var, ls, noise, mean = HYPER
    jp = js.SGPRParams(jstationary(kind, var, jnp.asarray(ls), dtype=jnp.float64),
                       jnp.asarray(noise), jnp.asarray(mean), jnp.asarray(Z))
    return jp, convert.sgpr_params_from_numpy(*HYPER, Z, device="cpu", dtype=F64)


def _svgp_params(Z, seed=1):
    rng = np.random.default_rng(seed)
    q_mu, q_sqrt = rng.normal(size=(Z.shape[0], 1)), np.tril(rng.normal(size=(1, Z.shape[0], Z.shape[0])))
    jp, _ = _sgpr_params(Z)
    jv = js.SVGPParams(jp.kernel, jp.noise_variance, jp.mean_constant, jp.inducing_points,
                       jnp.asarray(q_mu), jnp.asarray(q_sqrt))
    return jv, convert.svgp_params_from_numpy(*HYPER, Z, q_mu, q_sqrt, device="cpu", dtype=F64)


def _priors(jp):
    jpr = jpriors.default_priors(jp.kernel, 1.0)
    return jpr, convert.priors_from_numpy(np.asarray(jpr.ls_loc), np.asarray(jpr.var_loc),
                                          np.asarray(jpr.scale), device="cpu", dtype=F64)


def _arrays(ds):
    return ds.query_points, ds.observations, ds.mask


Z0 = np.random.default_rng(2).uniform(size=(M, 2))


def test_sgpr_bound_cache_and_predictions_match_jax():
    jds, tds = _data()
    jp, tp = _sgpr_params(Z0)
    _close(ts.sgpr_elbo(tp, *_arrays(tds)), _jit(js.sgpr_elbo, jp, *_arrays(jds)))
    jc, tc = _jit(js.sgpr_build_cache, jp, *_arrays(jds)), ts.sgpr_build_cache(tp, *_arrays(tds))
    for name in ("L", "LB", "c"):
        _close(getattr(tc, name), getattr(jc, name))
    x = np.random.default_rng(3).uniform(size=(3, 4, 2))
    for got, want in zip(ts.sgpr_predict_f(tp, tc, _t(x)), _jit(js.sgpr_predict_f, jp, jc, x)):
        assert got.shape == want.shape
        _close(got, want)
    for got, want in zip(ts.sgpr_predict_joint(tp, tc, _t(x)), _jit(js.sgpr_predict_joint, jp, jc, x)):
        assert got.shape == want.shape
        _close(got, want)
    # the bound of stacked hyperparameters is the bound of each (a fit's restarts)
    u = ts.sgpr_pack(tp, True, True)
    stack = torch.stack([u, u + 0.1])
    batched = ts.sgpr_elbo(ts.sgpr_unpack(stack, tp, True, True), *_arrays(tds))
    for row in range(2):
        _close(batched[row], ts.sgpr_elbo(ts.sgpr_unpack(stack[row], tp, True, True), *_arrays(tds)))


def test_svgp_predictions_bound_and_optimal_q_match_jax():
    jds, tds = _data()
    jv, tv = _svgp_params(Z0)
    x = np.random.default_rng(4).uniform(size=(3, 4, 2))
    for got, want in zip(ts.svgp_predict_f(tv, _t(x)), _jit(js.svgp_predict_f, jv, x)):
        assert got.shape == want.shape
        _close(got, want)
    for got, want in zip(ts.svgp_predict_joint(tv, _t(x)), _jit(js.svgp_predict_joint, jv, x)):
        assert got.shape == want.shape
        _close(got, want)
    _close(ts.svgp_elbo(tv, *_arrays(tds)), _jit(js.svgp_elbo, jv, *_arrays(jds)))
    jq = _jit(js.svgp_optimal_variational, jv, *_arrays(jds))
    tq = ts.svgp_optimal_variational(tv, *_arrays(tds))
    _close(tq.q_mu, jq.q_mu)
    _close(tq.q_sqrt, jq.q_sqrt)
    _close(ts.svgp_elbo(tq, *_arrays(tds)), _jit(js.svgp_elbo, jq, *_arrays(jds)))


def _jax_starts(key, u0, n_ls, n_shift, priors):
    """The restarts the JAX package's sparse fits draw (``fit_sgpr``/``fit_svgp``)."""
    if priors is not None:
        log_var, log_ls = jpriors.sample_log_params(key, priors, R - 1, n_ls)
        rest = jnp.broadcast_to(u0[None], (R - 1, u0.shape[0]))
        rest = rest.at[:, 0].set(log_var).at[:, 1 : 1 + n_ls].set(log_ls)
        return np.asarray(jnp.concatenate([u0[None], rest]))
    shifts = jax.random.uniform(key, (R - 1, u0.shape[0]), dtype=u0.dtype, minval=-1.5, maxval=1.5)
    keep = jnp.zeros_like(u0, bool).at[:n_shift].set(True).at[1 + n_ls].set(False)
    return np.asarray(jnp.concatenate([u0[None], u0[None] + shifts * keep[None, :]]))


def _jax_sgpr_starts(key, jparams, train_noise, train_inducing, priors):
    u0 = js._sgpr_pack(jparams, train_noise, train_inducing)
    return _jax_starts(key, u0, 2, 4 + int(train_noise), priors)


def _jax_svgp_starts(jparams, train_noise, priors):
    u0 = jnp.concatenate([js._sgpr_pack(jparams, train_noise, False)])
    return _jax_starts(jax.random.PRNGKey(0), u0, 2, u0.shape[0], priors)


def _fits_agree(got, want):
    """Losses at rtol 1e-6 and parameters at 1e-5: L-BFGS runs the same steps, not
    bitwise the same arithmetic."""
    _close(got.loss, want.loss, rtol=1e-6, atol=1e-9)
    for a, b in ((got.params.kernel.variance, want.params.kernel.variance),
                 (got.params.kernel.lengthscales, want.params.kernel.lengthscales),
                 (got.params.mean_constant, want.params.mean_constant),
                 (got.params.noise_variance, want.params.noise_variance),
                 (got.params.inducing_points, want.params.inducing_points)):
        _close(a, b, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("train_inducing", [True, False])
def test_fit_sgpr_matches_jax_from_its_starts(train_inducing):
    """The model's fit configuration (MAP, noise fixed), with the inducing points trained
    or fixed, on 16 points. Several restarts reach one optimum, their losses within 1e-10
    of each other, so which of them wins is rounding: the parameters are held on the JAX
    winner's run. A run that stops at ``max_iters`` short of an optimum lands where
    rounding takes it in either package; this case's winner converges."""
    jds, tds = _data(16)
    jp, tp = _sgpr_params(Z0)
    jpr, tpr = _priors(jp)
    key = jax.random.PRNGKey(6)
    want = js._jit_sgpr_fit(key, jp, *_arrays(jds), jpr, R, False, train_inducing, 100, None)
    u0 = js._sgpr_pack(jp, False, train_inducing)
    starts = _t(_jax_starts(key, u0, 2, 4, jpr))
    fit = lambda s: ts.fit_sgpr_from_starts(  # noqa: E731
        s, tp, *_arrays(tds), train_noise=False, train_inducing=train_inducing, priors=tpr)
    _close(fit(starts).loss, want.loss, rtol=1e-6, atol=1e-9)
    best = int(np.argmin(np.asarray(want.all_losses)))
    _fits_agree(fit(starts[best : best + 1]), want)
    # the draw half: the port's own restarts have the JAX layout, with priors or without
    for priors in (tpr, None):
        mine = ts.sgpr_starts(torch.Generator().manual_seed(0), tp, R, False, train_inducing, priors)
        assert mine.shape == starts.shape
        _close(mine[0], starts[0])
        assert bool((mine[1:, 3:] == starts[0, 3:]).all())  # the noise-free tail stays


def test_fit_svgp_matches_jax_from_its_starts():
    jds, tds = _data()
    jv, tv = _svgp_params(Z0)
    jpr, tpr = _priors(jv)
    want = js._jit_svgp_fit(jv, *_arrays(jds), jpr, False, 100, R, None)
    starts = _t(_jax_svgp_starts(jv, False, jpr))
    got = ts.fit_svgp_from_starts(starts, tv, *_arrays(tds), train_noise=False, priors=tpr)
    _close(got.loss, want.loss, rtol=1e-6, atol=1e-9)
    _fits_agree(got, want)
    _close(got.params.q_mu, want.params.q_mu, rtol=1e-5, atol=1e-8)
    _close(got.params.q_sqrt, want.params.q_sqrt, rtol=1e-5, atol=1e-8)


def test_fit_svgp_minibatch_matches_jax_on_its_indices():
    """50 Adam steps on every parameter, minibatches of 4 of the 10 valid rows."""
    jds, tds = _data()
    jv, tv = _svgp_params(Z0)
    key = jax.random.PRNGKey(7)
    steps, batch = 50, 4
    want = js._jit_svgp_fit_minibatch(key, jv, *_arrays(jds), None, batch, steps, 0.05, True)
    indices = np.stack([np.asarray(jax.random.randint(k, (batch,), 0, 10))
                        for k in jax.random.split(key, steps)])
    got = ts.fit_svgp_minibatch_from_indices(torch.as_tensor(indices), tv, *_arrays(tds))
    _close(got.loss, want.loss, rtol=1e-8)
    for name in ("inducing_points", "q_mu", "q_sqrt", "noise_variance", "mean_constant"):
        _close(getattr(got.params, name), getattr(want.params, name), rtol=1e-8)
    _close(got.params.kernel.lengthscales, want.params.kernel.lengthscales, rtol=1e-8)
    drawn = ts.minibatch_indices(torch.Generator().manual_seed(0), tds.mask, batch, steps)
    assert drawn.shape == (steps, batch) and int(drawn.max()) < 10


def _sgpr_models(Z=Z0, n=10):
    jds, tds = _data(n)
    jp, tp = _sgpr_params(Z)
    return (js.SparseGaussianProcessRegression(jp, jds), jds), (ts.SparseGaussianProcessRegression(tp, tds), tds)


@pytest.fixture
def jax_pools(monkeypatch):
    """Record the uniforms of the JAX package's box samples; the port's box samples scale
    them. Returns the queue."""
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


def test_selectors_match_jax_on_its_draws(jax_pools):
    (jm, jds), (tm, tds) = _sgpr_models()
    qp = _np(tds.trimmed_query_points)
    # uniform: the JAX space sample, replayed
    jspace, tspace = jsp.Box([0.0, 0.0], [1.0, 1.0]), tsp.Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu")
    want = jind.UniformInducingPointSelector(jspace)._recalculate_inducing_points(3, jm, jds)
    np.testing.assert_array_equal(_np(tind.UniformInducingPointSelector(tspace)._recalculate_inducing_points(3, tm, tds)), want)
    # random subsample: distinct rows, or all rows and uniform padding
    for m_ in (6, 13):
        sub = jax.random.split(jax.random.PRNGKey(1))[1]
        want = jind.RandomSubSampleInducingPointSelector()._recalculate_inducing_points(m_, jm, jds)
        draws = (jax.random.choice(sub, 10, (m_,), replace=False) if m_ <= 10
                 else jax.random.uniform(sub, (m_ - 10, 2), dtype=jnp.float64))
        got = tind.random_subsample_from_draws(_t(qp), m_, torch.as_tensor(np.array(draws)))
        np.testing.assert_array_equal(_np(got), want)
    # k-means: the JAX permutation, 20 Lloyd steps
    sub = jax.random.split(jax.random.PRNGKey(2))[1]
    want = jind.KMeansInducingPointSelector()._recalculate_inducing_points(3, jm, jds)
    perm = torch.as_tensor(np.array(jax.random.permutation(sub, 10)))
    _close(tind.kmeans_from_draws(_t(qp), 3, perm, 20), want)
    # the greedy DPPs: the same points, chosen in the same order
    for jsel, tsel in ((jind.ConditionalVarianceReduction(), tind.ConditionalVarianceReduction()),
                       (jind.ConditionalImprovementReduction(), tind.ConditionalImprovementReduction())):
        want = jsel._recalculate_inducing_points(5, jm, jds)
        np.testing.assert_array_equal(_np(tsel._recalculate_inducing_points(5, tm, tds)), want)
    scores = np.random.default_rng(5).uniform(0.1, 1.0, size=10)
    want = jind.greedy_inference_dpp(6, jm.get_kernel(), jnp.asarray(scores), jds)
    np.testing.assert_array_equal(_np(tind.greedy_inference_dpp(6, tm.get_kernel(), _t(scores), tds)), want)
    _close(tind.ModelBasedImprovementQualityFunction()(tm, tds),
           jind.ModelBasedImprovementQualityFunction()(jm, jds))
    assert not jax_pools


def test_selector_draws_and_recalculation_rule():
    _, (tm, tds) = _sgpr_models()
    sel = tind.KMeansInducingPointSelector(recalc_every_model_update=False)
    first = sel.calculate_inducing_points(torch.zeros(3, 2, dtype=F64), tm, tds)
    assert first.shape == (3, 2) and sel._generator.initial_seed() == 2
    assert sel.calculate_inducing_points(first + 1.0, tm, tds).equal(first + 1.0)
    padded = tind.RandomSubSampleInducingPointSelector()._recalculate_inducing_points(12, tm, tds)
    assert padded.shape == (12, 2) and padded[:10].equal(tds.trimmed_query_points)
    assert tind.DPPInducingPointSelector()._recalculate_inducing_points(12, tm, tds).shape == (12, 2)


def test_inducing_variables_match_jax():
    (jm, _), (tm, _) = _sgpr_models()
    assert isinstance(tm, SupportsGetInducingVariables)
    for got, want in zip(tm.get_inducing_variables(), jm.get_inducing_variables()):
        if isinstance(want, bool):
            assert got is want
        else:
            assert got.shape == want.shape
            _close(got, want)
    jv, tv = _svgp_params(Z0)
    jds, tds = _data()
    got = ts.SparseVariational(tv, tds).get_inducing_variables()
    want = js.SparseVariational(jv, jds).get_inducing_variables()
    assert got[3] is want[3] is True
    for a, b in zip(got[:3], want[:3]):
        _close(a, b)


@pytest.mark.parametrize("model", ["sgpr", "svgp"])
def test_decoupled_inducing_trajectory_matches_jax_given_its_draws(model):
    if model == "sgpr":
        (jm, _), (tm, _) = _sgpr_models()
    else:
        (jv, tv), (jds, tds) = _svgp_params(Z0), _data()
        jm, tm = js.SparseVariational(jv, jds), ts.SparseVariational(tv, tds)
    key, B = jax.random.PRNGKey(8), 3
    traj = jsampler.DecoupledInducingTrajectorySampler(jm, num_features=50).get_trajectory(key, B)
    eps = jax.random.normal(jax.random.split(key, 3)[2], (B, M), jnp.float64)
    features = convert.fourier_features_from_numpy(
        np.asarray(traj.features.W), np.asarray(traj.features.b), np.asarray(traj.features.variance),
        device="cpu", dtype=F64)
    got = tsampler.decoupled_inducing_trajectory_from_draws(
        tm.params.kernel, tm.params.mean_constant, tm.get_inducing_variables(), features,
        _t(traj.w), _t(eps))
    _close(got.v, traj.v)
    x = np.random.default_rng(9).uniform(size=(20, B, 2))
    _close(got(_t(x)), _jit(lambda f, q: f(q), traj, x))
    drawn = tm.trajectory_sampler().get_trajectory(torch.Generator().manual_seed(0), B)
    assert drawn(_t(x)).shape == (20, B, 1)


def test_builders_match_jax_with_its_inducing_points(monkeypatch):
    jds, tds = _data()
    jspace = jsp.Box([0.0, 0.0], [1.0, 1.0])
    tspace = tsp.Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu")
    for jbuild, tbuild in ((jbuilders.build_sgpr, tbuilders.build_sgpr),
                           (jbuilders.build_svgp, tbuilders.build_svgp)):
        jm = jbuild(jds, jspace, num_inducing_points=M)
        Z = np.asarray(jm.params.inducing_points)
        monkeypatch.setattr(tbuilders, "_initial_inducing_points", lambda *a: _t(Z))
        tm = tbuild(tds, tspace, num_inducing_points=M)
        for name in ("noise_variance", "mean_constant", "inducing_points"):
            _close(getattr(tm.params, name), getattr(jm.params, name))
        _close(tm.params.kernel.variance, jm.params.kernel.variance)
        _close(tm.params.kernel.lengthscales, jm.params.kernel.lengthscales)
        _close(tm._priors.ls_loc, jm._priors.ls_loc)
        x = np.random.default_rng(10).uniform(size=(6, 2))
        for got, want in zip(tm.predict(_t(x)), jm.predict(jnp.asarray(x))):
            _close(got, want)
        monkeypatch.undo()
    # the port's own: min(25·D, 500) points, the k-means centroids in the data's box
    big = Dataset.from_arrays(torch.rand(60, 2, dtype=F64), torch.rand(60, 1, dtype=F64))
    model = tbuilders.build_sgpr(big, tspace)
    assert model.params.inducing_points.shape == (50, 2)
    svgp = tbuilders.build_svgp(big, tspace, minibatch_size=8)
    assert svgp.params.q_sqrt.shape == (1, 50, 50) and svgp._minibatch_size == 8


@pytest.fixture
def sparse_draws(monkeypatch, jax_pools):
    """Replay the JAX package's sparse-model draws into the port's: the seed pools
    (``jax_pools``), the builders' initial centroids (the k-means permutation of the JAX
    key) and the fit restarts, recorded from
    each JAX fit's key as it is made."""
    sgpr_starts, svgp_starts = [], []
    sgpr_optimize, svgp_optimize = js.SparseGaussianProcessRegression.optimize, js.SparseVariational.optimize

    def record_sgpr(self, dataset):
        sub = jax.random.split(self._key)[1]
        sgpr_starts.append(_jax_sgpr_starts(sub, self.params, self._train_noise,
                                            self._train_inducing, self._priors))
        return sgpr_optimize(self, dataset)

    def record_svgp(self, dataset):
        svgp_starts.append(_jax_svgp_starts(self.params, self._train_noise, self._priors))
        return svgp_optimize(self, dataset)

    def replay_sgpr(generator, params, X, Y, mask, *, num_starts, train_noise, train_inducing,
                    max_iters, priors, pool_sharding):
        return ts.fit_sgpr_from_starts(_t(sgpr_starts.pop(0)), params, X, Y, mask,
                                       train_noise=train_noise, train_inducing=train_inducing,
                                       max_iters=max_iters, priors=priors,
                                       pool_sharding=pool_sharding)

    def replay_svgp(generator, params, X, Y, mask, *, num_starts, train_noise, max_iters, priors,
                    pool_sharding):
        return ts.fit_svgp_from_starts(_t(svgp_starts.pop(0)), params, X, Y, mask,
                                       train_noise=train_noise, max_iters=max_iters, priors=priors,
                                       pool_sharding=pool_sharding)

    def initial(dataset, space, num, seed):
        qp = dataset.trimmed_query_points
        perm = jax.random.permutation(jax.random.split(jax.random.PRNGKey(seed))[1], qp.shape[0])
        return tind.kmeans_from_draws(qp, num, torch.as_tensor(np.array(perm)), 20)

    monkeypatch.setattr(js.SparseGaussianProcessRegression, "optimize", record_sgpr)
    monkeypatch.setattr(js.SparseVariational, "optimize", record_svgp)
    monkeypatch.setattr(ts, "fit_sgpr", replay_sgpr)
    monkeypatch.setattr(ts, "fit_svgp", replay_svgp)
    monkeypatch.setattr(tbuilders, "_initial_inducing_points", initial)
    return jax_pools, sgpr_starts, svgp_starts


N_SEEDS, N_RUNS = 96, 3


@pytest.mark.parametrize("name", ["sgpr", "svgp"])
def test_sparse_models_through_the_loop_match_jax_over_two_steps(sparse_draws, name):
    """Two EGO steps with EI from six ScaledBranin points in both packages, with
    ``build_sgpr`` (four inducing points placed by the conditional-improvement selector's
    greedy DPP at every update, likelihood 1e-7) or ``build_svgp`` (four inducing points,
    likelihood 1e-6): the JAX run first, then the port's on its draws, its observer holding each point
    to the JAX package's and observing the latter. The SGPR slice keeps the selector's
    points untrained: trained, they leave the fit's optimum flat to 1e-9 in the bound,
    and the two packages' fits stop 1e-5 apart on it (``test_fit_sgpr_matches_jax_from_its
    _starts`` holds the trained fit)."""
    X = np.random.default_rng(11).uniform(size=(6, 2))
    Y = np.asarray(JScaledBranin.objective(jnp.asarray(X)))
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y), capacity=CAP)
    tds = Dataset.from_arrays(_t(X), _t(Y), capacity=CAP)
    jspace = JScaledBranin.search_space
    tspace = ScaledBranin.search_space.to("cpu", F64)
    if name == "sgpr":
        jm = jbuilders.build_sgpr(jds, jspace, num_inducing_points=M, likelihood_variance=1e-7,
                                  trainable_inducing=False,
                                  inducing_point_selector=jind.ConditionalImprovementReduction())
        tm = tbuilders.build_sgpr(tds, tspace, num_inducing_points=M, likelihood_variance=1e-7,
                                  trainable_inducing=False,
                                  inducing_point_selector=tind.ConditionalImprovementReduction())
    else:
        jm = jbuilders.build_svgp(jds, jspace, num_inducing_points=M, likelihood_variance=1e-6)
        tm = tbuilders.build_svgp(tds, tspace, num_inducing_points=M, likelihood_variance=1e-6)
    _close(tm.params.inducing_points, jm.params.inducing_points)
    asked = []

    def jobserver(qp):
        asked.append(np.asarray(qp))
        return jobj.mk_observer(JScaledBranin.objective)(qp)

    def tobserver(qp):
        want = asked.pop(0)
        np.testing.assert_allclose(_np(qp), want, atol=1e-6)
        return mk_observer(ScaledBranin.objective)(_t(want))

    jresult = jt.BayesianOptimizer(jobserver, jspace).optimize(
        2, jds, jm, jrule.EfficientGlobalOptimization(optimizer=jopt.generate_continuous_optimizer(N_SEEDS, N_RUNS)),
        key=jax.random.PRNGKey(12), track_state=False)
    tresult = BayesianOptimizer(tobserver, tspace).optimize(
        2, tds, tm, trule.EfficientGlobalOptimization(optimizer=topt.generate_continuous_optimizer(N_SEEDS, N_RUNS)),
        track_state=False)
    assert jresult.is_ok and tresult.is_ok, tresult.final_result
    pools, sgpr_starts, svgp_starts = sparse_draws
    assert not pools and not sgpr_starts and not svgp_starts and not asked
    got, want = tresult.try_get_final_dataset(), jresult.try_get_final_dataset()
    assert len(got) == int(want.num_points) == 8
    np.testing.assert_allclose(_np(got.trimmed_query_points), np.asarray(want.trimmed_query_points), atol=1e-6)
    _close(tm.params.inducing_points, jm.params.inducing_points, rtol=1e-5, atol=1e-7)

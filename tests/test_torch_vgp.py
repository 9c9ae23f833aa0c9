"""The port's variational GP, its likelihoods, BALD on it and the encoded-model wrappers on
the CPU, against the JAX package in float64.

The likelihoods' log densities, expectations and predictions at rtol 1e-12 (Gauss-Hermite
against the closed forms where both exist at 1e-6, the quadrature's own error); the ELBO,
one natural-gradient step (taken, and rejected where it leaves the positive-definite cone)
and the predictions at rtol 1e-9; ``fit_vgp`` from the JAX start (parameters and loss at
rtol 1e-6: ten L-BFGS runs in a row), and its own values with a loss of each row;
``update`` then ``optimize`` at capacities 8, 16 and
32; the builder; BALD's
values and gradients at rtol 1e-9; the encoders; and the slice: two BALD EGO steps on a
circle classification problem through ``BayesianOptimizer.optimize`` in both packages,
the JAX run's seed pools replayed into the port's (query points at atol 1e-6).

Every JAX function is compiled whole, once: the fits run at capacity 8 (7 labelled points,
the slice's first two fits), 16 (its third) and 32.
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
from trieste_tpu.acquisition.function import active_learning as jal
from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models import encoders as jenc
from trieste_tpu.models.gp import likelihoods as jlik
from trieste_tpu.models.gp import vgp as jvgp
from trieste_tpu.models.gp.gpr import GaussianProcessRegression as JGPR
from trieste_tpu.models.gp.posterior import GPRParams as JGPRParams
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu_torch import BayesianOptimizer, Dataset, convert
from trieste_tpu_torch import space as tsp
from trieste_tpu_torch.acquisition import optimizer as topt
from trieste_tpu_torch.acquisition import rule as trule
from trieste_tpu_torch.acquisition.function import active_learning as tal
from trieste_tpu_torch.models import encoders as tenc
from trieste_tpu_torch.models.gp import likelihoods as tlik
from trieste_tpu_torch.models.gp import vgp as tvgp
from trieste_tpu_torch.models.gp.gpr import GaussianProcessRegression as TGPR

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


LIKELIHOODS = ("bernoulli", "gaussian", "poisson")


def _likelihoods(name):
    if name == "bernoulli":
        return jlik.BernoulliLikelihood(), tlik.BernoulliLikelihood()
    if name == "gaussian":
        return jlik.GaussianLikelihood(jnp.asarray(0.3)), tlik.GaussianLikelihood(_t(0.3))
    return jlik.PoissonLikelihood(), tlik.PoissonLikelihood()


def _labels(name, X, rng):
    """0/1 labels outside a circle, counts, or a noisy sine: ``[n, 1]``."""
    if name == "bernoulli":
        return (np.sum(X**2, axis=-1, keepdims=True) > 0.5).astype(float)
    if name == "poisson":
        return rng.poisson(np.exp(np.sin(3 * X[:, :1]))).astype(float)
    return np.sin(3 * X[:, :1]) + 0.1 * rng.normal(size=(X.shape[0], 1))


def _case(name, n=10, cap=16, seed=0, q_scale=0.3):
    """Data on [-1, 1]² at capacity ``cap`` and a random full-rank ``q`` in both packages."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, 2))
    Y = _labels(name, X, rng)
    q_mu = rng.normal(size=(cap, 1))
    q_sqrt = np.tril(q_scale * rng.normal(size=(cap, cap)), -1) + np.diag(rng.uniform(0.3, 1.0, cap))
    jl, tl = _likelihoods(name)
    jp = jvgp.VGPParams(jstationary("matern52", 1.4, jnp.asarray([0.5, 0.7]), dtype=jnp.float64),
                        jnp.asarray(0.2), jnp.asarray(q_mu), jnp.asarray(q_sqrt), jl)
    tp = convert.vgp_params_from_numpy("matern52", 1.4, [0.5, 0.7], 0.2, q_mu, q_sqrt,
                                       likelihood=name, likelihood_variance=0.3, device="cpu", dtype=F64)
    assert type(tp.likelihood) is type(tl)
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y), capacity=cap)
    tds = Dataset.from_arrays(_t(X), _t(Y), capacity=cap)
    return jp, tp, jds, tds


def _arrays(ds):
    return ds.query_points, ds.observations, ds.mask


@pytest.mark.parametrize("name", LIKELIHOODS)
def test_likelihoods_match_jax(name):
    jl, tl = _likelihoods(name)
    rng = np.random.default_rng(1)
    f, mean = rng.normal(size=(6, 1)), rng.normal(size=(6, 1))
    var = rng.uniform(0.05, 0.8, size=(6, 1))
    y = _labels(name, rng.uniform(-1, 1, size=(6, 2)), rng)
    _close(tl.log_prob(_t(f), _t(y)), jl.log_prob(jnp.asarray(f), jnp.asarray(y)), rtol=1e-12)
    got = tl.variational_expectations(_t(mean), _t(var), _t(y))
    assert got.shape == (6, 1)
    _close(got, jl.variational_expectations(jnp.asarray(mean), jnp.asarray(var), jnp.asarray(y)),
           rtol=1e-12)
    for g, w in zip(tl.predict_y(_t(mean), _t(var)), jl.predict_y(jnp.asarray(mean), jnp.asarray(var))):
        _close(g, w, rtol=1e-12)
    quadrature = tlik.gauss_hermite_expectation(tl.log_prob, _t(mean), _t(var), _t(y))
    _close(quadrature, jlik.gauss_hermite_expectation(jl.log_prob, jnp.asarray(mean), jnp.asarray(var),
                                                      jnp.asarray(y)), rtol=1e-12)
    if name != "bernoulli":  # a closed form to hold the quadrature against
        _close(quadrature, got, rtol=1e-6)
    # the probit link clips its log density into [-1e3, 0]
    if name == "bernoulli":
        assert float(tl.log_prob(_t([[-60.0]]), _t([[1.0]]))) == -1e3


@pytest.fixture(scope="module")
def jax_vgp():
    """The JAX package's VGP functions, each compiled whole."""
    return {name: jax.jit(getattr(jvgp, name), static_argnames=static)
            for name, static in (("vgp_elbo", ()), ("natural_gradient_step", ()),
                                 ("vgp_predict_f", ()))}


@pytest.mark.parametrize("name", LIKELIHOODS)
def test_elbo_and_predictions_match_jax(jax_vgp, name):
    jp, tp, jds, tds = _case(name)
    _close(tvgp.vgp_elbo(tp, *_arrays(tds)), jax_vgp["vgp_elbo"](jp, *_arrays(jds)))
    x = np.random.default_rng(2).uniform(-1, 1, size=(3, 5, 2))
    got = tvgp.vgp_predict_f(tp, tds.query_points, tds.mask, _t(x))
    want = jax_vgp["vgp_predict_f"](jp, jds.query_points, jds.mask, jnp.asarray(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, 5, 1)
        _close(g, w)


@pytest.mark.parametrize("case", ["taken", "rejected"])
def test_natural_gradient_step_matches_jax(jax_vgp, case):
    """A step of 0.5 from a random ``q``; a step of 4 from a narrow ``q`` (``S`` near
    0.01·I, where ``θ₂' ≈ (γ − 1)/2 · S⁻¹`` turns positive) leaves the cone, and both
    packages keep ``q`` as it was."""
    q_scale, gamma = (0.3, 0.5) if case == "taken" else (0.01, 4.0)
    jp, tp, jds, tds = _case("bernoulli", q_scale=q_scale)
    if case == "rejected":
        jp = jp.replace(q_sqrt=0.1 * jnp.eye(16) + jnp.tril(jp.q_sqrt, -1))
        tp = tp.replace(q_sqrt=_t(jp.q_sqrt))
    want = jax_vgp["natural_gradient_step"](jp, *_arrays(jds), gamma)
    got, ok = tvgp.natural_gradient_step_with_status(tp, *_arrays(tds), gamma)
    assert bool(ok) is (case == "taken")
    _close(got.q_mu, want.q_mu, rtol=1e-8, atol=1e-10)
    _close(got.q_sqrt, want.q_sqrt, rtol=1e-8, atol=1e-10)
    if case == "rejected":
        assert got.q_mu is not tp.q_mu and torch.equal(got.q_mu, tp.q_mu)
        assert torch.equal(got.q_sqrt, tp.q_sqrt)
    else:
        assert not torch.equal(got.q_mu, tp.q_mu)
        _close(tvgp.natural_gradient_step(tp, *_arrays(tds), gamma).q_sqrt, got.q_sqrt, rtol=0)


def _circle(n, seed):
    X = np.random.default_rng(seed).uniform(-1, 1, size=(n, 2))
    return X, (np.sum(X**2, axis=-1, keepdims=True) > 0.5).astype(float)


JBOX = jsp.Box([-1.0, -1.0], [1.0, 1.0])
TBOX = tsp.Box([-1.0, -1.0], [1.0, 1.0], dtype=F64, device="cpu")


def _classifiers(n=7, seed=3):
    X, Y = _circle(n, seed)
    jds, tds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y)), Dataset.from_arrays(_t(X), _t(Y))
    return (jvgp.build_vgp_classifier(jds, JBOX), jds), (tvgp.build_vgp_classifier(tds, TBOX), tds)


def test_builder_matches_jax():
    (jm, _), (tm, tds) = _classifiers()
    for got, want in ((tm.params.kernel.variance, jm.params.kernel.variance),
                      (tm.params.kernel.lengthscales, jm.params.kernel.lengthscales),
                      (tm.params.mean_constant, jm.params.mean_constant),
                      (tm.params.q_mu, jm.params.q_mu), (tm.params.q_sqrt, jm.params.q_sqrt),
                      (tm._priors.ls_loc, jm._priors.ls_loc), (tm._priors.var_loc, jm._priors.var_loc)):
        assert got.shape == want.shape
        _close(got, want)
    assert isinstance(tm.params.likelihood, tlik.BernoulliLikelihood)
    noise_free = tvgp.build_vgp_classifier(tds, TBOX, noise_free=True)
    assert float(noise_free.params.kernel.variance) == tvgp.CLASSIFICATION_KERNEL_VARIANCE_NOISE_FREE


def test_fit_matches_jax_from_its_start():
    """The classifier's fit (ten alternations of five natural-gradient steps and 25
    L-BFGS iterations, MAP) from the builder's start, then the fitted model's predictions,
    its probit link and its samples' moments."""
    (jm, jds), (tm, tds) = _classifiers()
    want = jm.optimize(jds)
    got = tm.optimize(tds)
    _close(got.loss, want.loss, rtol=1e-6)
    assert int(got.rejected_steps) == 0
    for a, b in ((got.params.kernel.variance, want.params.kernel.variance),
                 (got.params.kernel.lengthscales, want.params.kernel.lengthscales),
                 (got.params.q_mu, want.params.q_mu), (got.params.q_sqrt, want.params.q_sqrt)):
        _close(a, b, rtol=1e-6, atol=1e-9)
    x = np.random.default_rng(4).uniform(-1, 1, size=(9, 2))
    for g, w in zip(tm.predict_y(_t(x)), jm.predict_y(jnp.asarray(x))):
        _close(g, w, rtol=1e-6, atol=1e-9)
    mean, var = tm.predict(_t(x))
    p, _ = tm.predict_y(_t(x))
    _close(p, torch.special.ndtr(mean / torch.sqrt(1 + var)), rtol=1e-12)
    draws = tm.sample(torch.Generator().manual_seed(0), _t(x), 4000)
    assert draws.shape == (4000, 9, 1)
    _close(draws.mean(0), mean, rtol=0, atol=0.1)


def test_fit_gives_its_values_with_a_loss_of_each_row(monkeypatch):
    """The hyperparameters' loss is one function of each row, for any number of rows, as
    the L-BFGS line search's blocks need; the fit from ``build_vgp_classifier``'s start
    keeps the values it had when the loss read its first row alone (float64 on the CPU)."""
    (_, _), (tm, tds) = _classifiers()
    minimize = tvgp.minimize_lbfgs

    def checked(fn, x0, **kwargs):
        rows = torch.cat([x0, x0 + 0.1, x0 - 0.2])
        torch.testing.assert_close(fn(rows), torch.cat([fn(r[None]) for r in rows]),
                                   rtol=0, atol=0)
        return minimize(fn, x0, **kwargs)

    monkeypatch.setattr(tvgp, "minimize_lbfgs", checked)
    got = tm.optimize(tds)
    assert int(got.rejected_steps) == 0 == int(got.rejected_hyper_steps)
    close = dict(rtol=1e-12, atol=1e-15)
    _close(got.loss, 4.696636604546559, **close)
    _close(got.params.kernel.variance, 0.4079973312636676, **close)
    _close(got.params.kernel.lengthscales, [0.19882676415217346, 0.24456913826458854], **close)
    _close(got.params.q_mu[:, 0], [0.5075790216434963, -0.43130419948901244, 0.38778264455106876,
                                   -0.4219320470857129, 0.4337141577494531, -0.6480103485053887,
                                   -0.2671287828219395, 0.0], **close)
    _close(torch.diagonal(got.params.q_sqrt),
           [0.9003298696866358, 0.9026310195917714, 0.9091391185369633, 0.9021276731727007,
            0.902349008864748, 0.873429035229417, 0.9507625643136282, 0.9999997305001114],
           **close)


def test_fit_rejects_a_hyperparameter_run_that_ends_at_a_non_finite_loss(monkeypatch):
    """Where an L-BFGS run on the hyperparameters ends at a non-finite loss (in fp32 at
    capacity 1024 the Cholesky of ``K + 1e-5·I`` fails at some hyperparameters), the fit
    keeps the hyperparameters it had; the natural-gradient steps go on."""
    (_, _), (tm, tds) = _classifiers()
    start, minimize = tm.params, tvgp.minimize_lbfgs

    def diverged(fn, x0, **kwargs):
        return minimize(fn, x0, max_iters=1)._replace(
            x=x0 + 1.0, fun=torch.full((1,), torch.inf, dtype=F64))

    monkeypatch.setattr(tvgp, "minimize_lbfgs", diverged)
    result = tvgp.fit_vgp(start, *_arrays(tds), num_alternations=2, priors=tm._priors)
    assert int(result.rejected_hyper_steps) == 2 and int(result.rejected_steps) == 0
    assert torch.equal(result.params.kernel.variance, start.kernel.variance)
    assert torch.equal(result.params.kernel.lengthscales, start.kernel.lengthscales)
    assert not torch.equal(result.params.q_mu, start.q_mu) and bool(torch.isfinite(result.loss))


def test_update_then_optimize_at_growing_capacities_match_jax():
    """7 → 12 → 20 labelled points, capacity 8 → 16 → 32: at each, ``update`` keeps the
    fitted ``q``'s leading block and pads it with the prior, and ``optimize`` fits from
    there; both packages agree at every capacity (rtol 1e-6, as the fit)."""
    (jm, jds), (tm, tds) = _classifiers()
    jm.optimize(jds)
    tm.optimize(tds)
    for n in (12, 20):
        X, Y = _circle(n, 3)  # the first 7 points are the classifiers'
        jds, tds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y)), Dataset.from_arrays(_t(X), _t(Y))
        old = tm.params
        jm.update(jds)
        tm.update(tds)
        C, old_C = tds.capacity, old.q_mu.shape[0]
        assert tm.params.q_mu.shape == (C, 1) and tm.get_internal_data() is tds
        assert torch.equal(tm.params.q_mu[:old_C], old.q_mu) and not tm.params.q_mu[old_C:].any()
        assert torch.equal(tm.params.q_sqrt[:old_C, :old_C], old.q_sqrt)
        assert torch.equal(tm.params.q_sqrt[old_C:, old_C:], torch.eye(C - old_C, dtype=F64))
        _close(tm.params.q_sqrt, jm.params.q_sqrt, rtol=1e-6, atol=1e-9)
        want, got = jm.optimize(jds), tm.optimize(tds)
        _close(got.loss, want.loss, rtol=1e-6)
        _close(got.params.q_mu, want.params.q_mu, rtol=1e-6, atol=1e-9)
        _close(got.params.kernel.lengthscales, want.params.kernel.lengthscales, rtol=1e-6)
    assert tm.params.q_sqrt.shape == (32, 32)


def test_bald_on_the_vgp_matches_jax():
    """BALD's values and gradients through the port's ``predictor`` on a fitted-like
    classifier (a random ``q``)."""
    jp, tp, jds, tds = _case("bernoulli")
    jm, tm = jvgp.VariationalGaussianProcess(jp, jds), tvgp.VariationalGaussianProcess(tp, tds)
    x = np.random.default_rng(7).uniform(-1, 1, size=(12, 1, 2))
    jfn = jal.BayesianActiveLearningByDisagreement().prepare_acquisition_function(jm, jds)
    tfn = tal.BayesianActiveLearningByDisagreement().prepare_acquisition_function(tm, tds)
    want, jgrad = jax.jit(jax.value_and_grad(lambda f, q: jnp.sum(f(q)), argnums=1))(jfn, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got = tfn(xt)
    assert got.shape == (12, 1)
    (grad,) = torch.autograd.grad(got.sum(), xt)
    _close(got.sum(), want)
    _close(got[:, 0], jfn(jnp.asarray(x))[:, 0])
    _close(grad, jgrad, rtol=1e-8, atol=1e-12)


def _mixed_spaces():
    """A categorical dimension of 3 (one-hot to 3 columns) × a unit box."""
    jspace = jsp.CategoricalSearchSpace([3]) * jsp.Box([0.0], [1.0])
    tspace = tsp.CategoricalSearchSpace([3], F64, device="cpu") * tsp.Box([0.0], [1.0], dtype=F64, device="cpu")
    return jspace, tspace


def test_encoders_match_jax(monkeypatch):
    jspace, tspace = _mixed_spaces()
    jenc_fn, tenc_fn = jspace.one_hot_encoder(), tspace.one_hot_encoder()
    rng = np.random.default_rng(8)
    X = np.concatenate([rng.integers(0, 3, size=(9, 1)), rng.uniform(size=(9, 1))], axis=-1).astype(float)
    Y = np.sin(3 * X[:, 1:]) + X[:, :1]
    jds, tds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y)), Dataset.from_arrays(_t(X), _t(Y))
    jenc_ds, tenc_ds = jenc.encode_dataset(jds, jenc_fn), tenc.encode_dataset(tds, tenc_fn)
    assert tenc_ds.dimension == 4 and len(tenc_ds) == 9
    _close(tenc_ds.query_points, jenc_ds.query_points, rtol=0)
    _close(tenc_ds.observations, jenc_ds.observations, rtol=0)
    hyper = ("matern52", 1.1, [0.4, 0.6, 0.5, 0.3], 1e-3, 0.1)
    jp = JGPRParams(jstationary(hyper[0], hyper[1], jnp.asarray(hyper[2]), dtype=jnp.float64),
                    jnp.asarray(hyper[3]), jnp.asarray(hyper[4]))
    jm = jenc.EncodedTrainableProbabilisticModel(JGPR(jp, jenc_ds), jenc_fn)
    tm = tenc.EncodedTrainableProbabilisticModel(
        TGPR(convert.gpr_params_from_numpy(*hyper, device="cpu", dtype=F64), tenc_ds), tenc_fn)
    x = np.concatenate([rng.integers(0, 3, size=(5, 1)), rng.uniform(size=(5, 1))], axis=-1).astype(float)
    for method in ("predict", "predict_y", "predict_joint"):
        for g, w in zip(getattr(tm, method)(_t(x)), getattr(jm, method)(jnp.asarray(x))):
            assert g.shape == w.shape
            _close(g, w)
    # the rest is the wrapped model's, and a copy delegates too
    assert tm.get_kernel() is tm.wrapped_model.get_kernel()
    _close(tm.get_observation_noise(), jm.get_observation_noise())
    import copy

    twin = copy.deepcopy(tm)
    _close(twin.predict(_t(x))[0], tm.predict(_t(x))[0], rtol=0)
    # update and optimize see the encoded data
    seen = []
    monkeypatch.setattr(TGPR, "optimize", lambda self, ds: seen.append(ds))
    X2 = np.concatenate([X, [[2.0, 0.5]]])
    tds2 = Dataset.from_arrays(_t(X2), _t(np.concatenate([Y, [[0.0]]])))
    tm.update(tds2)
    tm.optimize(tds2)
    assert tm.wrapped_model.dataset.dimension == 4 and len(tm.wrapped_model.dataset) == 10
    _close(seen[0].query_points, tenc.encode_dataset(tds2, tenc_fn).query_points, rtol=0)


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


def test_bald_classifier_through_the_loop_matches_jax_over_two_steps(jax_pools):
    """Two EGO steps of BALD over ``build_vgp_classifier`` from 7 labelled circle points
    (``sum(x²) > 0.5`` on [-1, 1]²) in both packages: the initial fit and the first step's
    at capacity 8, the second step's at 16 after ``update`` re-pads ``q``. The JAX run
    first, then the port's on its seed pools, its observer holding each point to the JAX
    package's and labelling the latter."""
    X, Y = _circle(7, 3)
    jds, tds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y)), Dataset.from_arrays(_t(X), _t(Y))
    jm, tm = jvgp.build_vgp_classifier(jds, JBOX), tvgp.build_vgp_classifier(tds, TBOX)
    asked = []

    def label(qp):
        return (np.sum(qp**2, axis=-1, keepdims=True) > 0.5).astype(float)

    def jobserver(qp):
        asked.append(np.asarray(qp))
        return JDataset.from_arrays(qp, jnp.asarray(label(np.asarray(qp))))

    def tobserver(qp):
        want = asked.pop(0)
        np.testing.assert_allclose(_np(qp), want, atol=1e-6)
        return Dataset.from_arrays(_t(want), _t(label(want)))

    from trieste_tpu.acquisition.function.active_learning import BayesianActiveLearningByDisagreement as JBALD
    from trieste_tpu_torch.acquisition import BayesianActiveLearningByDisagreement as TBALD

    jresult = jt.BayesianOptimizer(jobserver, JBOX).optimize(
        2, jds, jm, jrule.EfficientGlobalOptimization(JBALD(), optimizer=jopt.generate_continuous_optimizer(96, 3)),
        key=jax.random.PRNGKey(9), track_state=False)
    tresult = BayesianOptimizer(tobserver, TBOX).optimize(
        2, tds, tm, trule.EfficientGlobalOptimization(TBALD(), optimizer=topt.generate_continuous_optimizer(96, 3)),
        track_state=False)
    assert jresult.is_ok and tresult.is_ok, tresult.final_result
    assert not jax_pools and not asked
    got, want = tresult.try_get_final_dataset(), jresult.try_get_final_dataset()
    assert len(got) == int(want.num_points) == 9 and got.capacity == 16
    np.testing.assert_allclose(_np(got.trimmed_query_points), np.asarray(want.trimmed_query_points), atol=1e-6)
    assert set(np.unique(_np(got.trimmed_observations))) <= {0.0, 1.0}
    _close(tm.params.q_mu, jm.params.q_mu, rtol=1e-5, atol=1e-7)
    _close(tm.params.kernel.lengthscales, jm.params.kernel.lengthscales, rtol=1e-5)

"""The port's active-learning acquisitions (predictive variance, expected feasibility,
integrated variance reduction, BALD) and their function forms on the CPU, against the JAX
package in float64 at rtol 1e-9 / atol 1e-10, then the closed-form checks of the JAX
package's own tests on the port: determinants, the Bichon and Ranjan formulas, variance
reduction against conditioning from scratch, BALD against Gauss-Hermite integration.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from trieste_tpu.acquisition.function import active_learning as jal
from trieste_tpu.acquisition.function import functional as jfl
from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models.gp import posterior as jpost
from trieste_tpu.models.gp.gpr import GaussianProcessRegression as JGPR
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu_torch import Dataset, convert
from trieste_tpu_torch.acquisition.function import active_learning as tal
from trieste_tpu_torch.acquisition.function import functional as tfl
from trieste_tpu_torch.models.gp.gpr import GaussianProcessRegression
from trieste_tpu_torch.ops.kernels import gram, stationary

torch.set_num_threads(1)

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-10)
NORM = scipy.stats.norm


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def pair():
    """The same 2-D GPR (capacity 16, partly padded) in both packages, float64."""
    X = np.random.default_rng(0).uniform(-1.0, 1.0, size=(9, 2))
    Y = np.sin(2.0 * X[:, :1]) + X[:, 1:] ** 2
    jm = JGPR(jpost.GPRParams(jstationary("rbf", 0.9, [0.5, 0.7], dtype=jnp.float64),
                              jnp.asarray(1e-2), jnp.asarray(0.1)),
              JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y)))
    tm = GaussianProcessRegression(
        convert.gpr_params_from_numpy("rbf", 0.9, [0.5, 0.7], 1e-2, 0.1, device="cpu", dtype=F64),
        Dataset.from_arrays(_t(X), _t(Y)),
    )
    return jm, tm


def _x(lead=(12,), B=1, seed=1):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=lead + (B, 2))


_APPLY = jax.jit(lambda f, x: f(x))
"""A JAX acquisition function at ``x``, compiled whole (op by op it compiles every
primitive anew, several seconds a function); a ``Partial`` is an argument, so a function
of the same structure and shapes compiles once."""


def _same(tfn, jfn, x, tol=TOL):
    got, want = tfn(_t(x)), np.asarray(_APPLY(jfn, jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)


@pytest.mark.parametrize("B", [1, 3])
def test_predictive_variance_matches_jax(pair, B):
    jm, tm = pair
    _same(tal.PredictiveVariance(1e-6).prepare_acquisition_function(tm),
          jal.PredictiveVariance(1e-6).prepare_acquisition_function(jm), _x((4,), B))
    _same(tfl.predictive_variance(tm, 1e-6), jfl.predictive_variance(jm, 1e-6), _x((4,), B))


@pytest.mark.parametrize("delta", [1, 2])
def test_expected_feasibility_matches_jax(pair, delta):
    jm, tm = pair
    for alpha in (0.5, 2.0):
        _same(tal.ExpectedFeasibility(0.3, alpha, delta).prepare_acquisition_function(tm),
              jal.ExpectedFeasibility(0.3, alpha, delta).prepare_acquisition_function(jm), _x())
    _same(tfl.bichon_ranjan_criterion(tm, 0.3, 1.0, delta),
          jfl.bichon_ranjan_criterion(jm, 0.3, 1.0, delta), _x())


@pytest.mark.parametrize("threshold", [None, 0.2, [-0.3, 0.4]])
def test_integrated_variance_reduction_matches_jax(pair, threshold):
    """Every batch of the leading dims at once (one batched Cholesky) against the JAX
    package's ``vmap`` over them."""
    jm, tm = pair
    t = np.random.default_rng(2).uniform(-1.0, 1.0, size=(30, 2))
    jfn = jal.IntegratedVarianceReduction(jnp.asarray(t), threshold).prepare_acquisition_function(jm)
    tfn = tal.IntegratedVarianceReduction(_t(t), threshold).prepare_acquisition_function(tm)
    _same(tfn, jfn, _x((2, 3), 2))
    _same(tfl.integrated_variance_reduction(tm, _t(t), threshold), jfn, _x((2, 3), 2))


def test_bald_matches_jax(pair):
    jm, tm = pair
    _same(tal.BayesianActiveLearningByDisagreement(1e-6).prepare_acquisition_function(tm),
          jal.BayesianActiveLearningByDisagreement(1e-6).prepare_acquisition_function(jm), _x())
    _same(tfl.bayesian_active_learning_by_disagreement(tm),
          jfl.bayesian_active_learning_by_disagreement(jm), _x())


def test_builders_validate_their_arguments(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="alpha must be positive"):
        tal.ExpectedFeasibility(0.0, alpha=0.0)
    with pytest.raises(ValueError, match="delta must be 1 or 2"):
        tal.ExpectedFeasibility(0.0, delta=3)

    class NoCache:
        def predict(self, x):
            return tm.predict(x)

    with pytest.raises(NotImplementedError, match="exact-GP"):
        tal.IntegratedVarianceReduction(torch.zeros(3, 2, dtype=F64)).prepare_acquisition_function(
            NoCache())
    assert repr(tal.ExpectedFeasibility(0.5, 1.0, 2)) == repr(jal.ExpectedFeasibility(0.5, 1.0, 2))


# -- closed forms on the port ----------------------------------------------------------------


class _Quadratic:
    """A prior GP with mean ``|x|²`` and a unit RBF kernel: closed-form predictions."""

    def __init__(self, noise_variance: float = 0.25):
        self._kernel = stationary("rbf", 1.0, 1.0, dtype=F64, device="cpu")
        self._noise = torch.tensor(noise_variance, dtype=F64)

    def predict(self, x):
        return torch.sum(x**2, -1, keepdim=True), torch.ones(x.shape[:-1] + (1,), dtype=F64)

    def predict_joint(self, x):
        return torch.sum(x**2, -1, keepdim=True), gram(self._kernel, x)[..., None, :, :]

    def get_observation_noise(self):
        return self._noise


def test_predictive_variance_is_the_covariance_determinant():
    model = _Quadratic()
    fn = tal.PredictiveVariance(jitter=0.0).prepare_acquisition_function(model)
    x = torch.tensor([[[0.1, 0.3], [0.6, -0.2], [-0.4, 0.5]]], dtype=F64)
    want = np.linalg.det(model.predict_joint(x)[1][0, 0].numpy())
    np.testing.assert_allclose(fn(x).numpy(), [[want]], rtol=1e-10)
    np.testing.assert_allclose(fn(x[:, :1]).numpy(), [[1.0]], rtol=1e-12)  # the prior's
    clumped = torch.tensor([[[0.0, 0.0], [0.01, 0.0]]], dtype=F64)
    spread = torch.tensor([[[0.0, 0.0], [2.0, 2.0]]], dtype=F64)
    assert float(fn(spread)) > float(fn(clumped))


@pytest.mark.parametrize("threshold", [-0.5, 0.0, 0.7])
@pytest.mark.parametrize("alpha", [0.5, 2.0])
def test_bichon_and_ranjan_match_scipy(threshold, alpha):
    model = _Quadratic()
    x = torch.tensor([[[0.3, -0.2]]], dtype=F64)
    m, v = 0.13, 1.0
    s = np.sqrt(v)
    t = (threshold - m) / s
    bichon = s * (
        alpha * (NORM.cdf(t + alpha) - NORM.cdf(t - alpha))
        - t * (2 * NORM.cdf(t) - NORM.cdf(t + alpha) - NORM.cdf(t - alpha))
        - (2 * NORM.pdf(t) - NORM.pdf(t + alpha) - NORM.pdf(t - alpha))
    )
    ranjan = v * (
        (alpha**2 - 1 - t**2) * (NORM.cdf(t + alpha) - NORM.cdf(t - alpha))
        - 2 * t * (NORM.pdf(t + alpha) - NORM.pdf(t - alpha))
        + (t + alpha) * NORM.pdf(t + alpha)
        - (t - alpha) * NORM.pdf(t - alpha)
    )
    for delta, want in ((1, bichon), (2, ranjan)):
        fn = tal.ExpectedFeasibility(threshold, alpha, delta).prepare_acquisition_function(model)
        np.testing.assert_allclose(fn(x).numpy(), [[want]], rtol=1e-10)


def test_expected_feasibility_is_largest_on_the_contour():
    fn = tal.ExpectedFeasibility(0.5, delta=1).prepare_acquisition_function(_Quadratic())
    on = torch.tensor([[[np.sqrt(0.5), 0.0]]], dtype=F64)
    assert float(fn(on)) > float(fn(torch.tensor([[[1.5, 0.0]]], dtype=F64)))


@pytest.fixture(scope="module")
def gpr_1d():
    X = np.random.default_rng(3).uniform(-2.0, 2.0, size=(7, 1))
    params = convert.gpr_params_from_numpy("rbf", 1.1, [0.7], 0.01, 0.0, device="cpu", dtype=F64)
    return GaussianProcessRegression(params, Dataset.from_arrays(_t(X), _t(np.sin(2.0 * X)))), X


def _naive_variance_reduction(model, X, xq, t):
    """The variance at ``t`` that adding ``xq`` removes, by conditioning from scratch."""
    kernel = model.params.kernel
    noise = float(model.params.noise_variance) + 1e-6

    def post_var(X):
        K = gram(kernel, _t(X)).numpy() + noise * np.eye(len(X))
        Kt = gram(kernel, _t(t), _t(X)).numpy()
        return 1.1 - np.sum(Kt * np.linalg.solve(K, Kt.T).T, axis=-1)

    return post_var(X) - post_var(np.concatenate([X, xq]))


def test_integrated_variance_reduction_matches_conditioning_from_scratch(gpr_1d):
    model, X = gpr_1d
    t = np.linspace(-2.0, 2.0, 9)[:, None]
    xq = np.array([[0.33], [-1.1]])
    got = float(tal.IntegratedVarianceReduction(_t(t)).prepare_acquisition_function(model)(
        _t(xq)[None]))
    np.testing.assert_allclose(got, np.sum(_naive_variance_reduction(model, X, xq, t)), rtol=1e-4)


def test_integrated_variance_reduction_threshold_weights(gpr_1d):
    model, _ = gpr_1d
    t = torch.linspace(-2.0, 2.0, 9, dtype=F64)[:, None]
    xq = torch.tensor([[[0.33]]], dtype=F64)
    flat = float(tal.IntegratedVarianceReduction(t).prepare_acquisition_function(model)(xq))
    weighted = float(tal.IntegratedVarianceReduction(t, 0.0).prepare_acquisition_function(model)(xq))
    wide = float(tal.IntegratedVarianceReduction(t, [-10.0, 10.0]).prepare_acquisition_function(
        model)(xq))
    assert 0.0 < weighted < NORM.pdf(0) * flat + 1e-12  # density weights under the mode's
    np.testing.assert_allclose(wide, flat, rtol=1e-6)  # an interval holding everything


def test_bald_matches_gauss_hermite_integration():
    model = _Quadratic()
    fn = tal.BayesianActiveLearningByDisagreement(jitter=1e-12).prepare_acquisition_function(model)
    x = torch.tensor([[[0.4, 0.1]]], dtype=F64)
    m, v = 0.17, 1.0
    p = NORM.cdf(m / np.sqrt(1 + v))
    marginal = -p * np.log(p) - (1 - p) * np.log(1 - p)
    nodes, weights = np.polynomial.hermite_e.hermegauss(120)
    pf = np.clip(NORM.cdf(m + np.sqrt(v) * nodes), 1e-12, 1 - 1e-12)
    conditional = np.sum(weights * (-pf * np.log(pf) - (1 - pf) * np.log(1 - pf))) / np.sqrt(2 * np.pi)
    # Houlsby et al.'s exponential approximation of the conditional entropy: 1e-2 nats
    np.testing.assert_allclose(float(fn(x)), marginal - conditional, atol=2e-2)
    assert float(fn(x)) > float(fn(torch.tensor([[[1.3, 1.3]]], dtype=F64)))  # boundary at 0

"""The plain reference against cases worked out by hand in float64, and the FLOP and
byte counts against hand counts."""
import math

import pytest
import torch

from benchmarks.harness import spec
from benchmarks.reference import gp as R

F64 = torch.float64


def hyper(variance=1.5, lengthscales=(0.5,), mean=0.25, noise=0.1, jitter=0.0):
    return R.Hyper(torch.tensor(variance, dtype=F64), torch.tensor(lengthscales, dtype=F64),
                   torch.tensor(mean, dtype=F64), noise, jitter)


def matern52_by_hand(r):
    return (1 + math.sqrt(5) * r + 5 * r * r / 3) * math.exp(-math.sqrt(5) * r)


def test_matern52_by_hand():
    h = hyper()
    a = torch.tensor([[0.1]], dtype=F64)
    b = torch.tensor([[0.4]], dtype=F64)
    k = R.kernel(a, b, h, R.FP64)
    assert float(k) == pytest.approx(1.5 * matern52_by_hand(0.3 / 0.5), rel=1e-14)


def test_two_point_posterior_and_likelihood_by_hand():
    """Two training points: the 2x2 system solved by hand."""
    h = hyper()
    X = torch.tensor([[0.0], [0.5]], dtype=F64)
    Y = torch.tensor([[1.0], [-0.5]], dtype=F64)
    k01 = 1.5 * matern52_by_hand(1.0)
    a, b = 1.5 + 0.1, k01  # K + noise I = [[a, b], [b, a]]
    det = a * a - b * b
    inv = [[a / det, -b / det], [-b / det, a / det]]
    ym = [1.0 - 0.25, -0.5 - 0.25]
    alpha = [inv[0][0] * ym[0] + inv[0][1] * ym[1], inv[1][0] * ym[0] + inv[1][1] * ym[1]]
    x = 0.2
    kx = [1.5 * matern52_by_hand(x / 0.5), 1.5 * matern52_by_hand(0.3 / 0.5)]
    mean = 0.25 + kx[0] * alpha[0] + kx[1] * alpha[1]
    var = 1.5 - sum(kx[i] * inv[i][j] * kx[j] for i in range(2) for j in range(2))
    post = R.Posterior(X, Y, h, R.FP64)
    m, v = post.marginal(torch.tensor([[x]], dtype=F64))
    assert float(m) == pytest.approx(mean, rel=1e-13)
    assert float(v) == pytest.approx(var, rel=1e-12)
    nlml = 0.5 * (ym[0] * alpha[0] + ym[1] * alpha[1] + math.log(det) + 2 * math.log(2 * math.pi))
    assert float(R.neg_log_marginal_likelihood(X, Y, h, R.FP64)) == pytest.approx(nlml, rel=1e-13)


def test_expected_improvement_by_hand():
    mean, var, eta = torch.tensor([0.3], dtype=F64), torch.tensor([0.04], dtype=F64), 0.5
    z = (eta - 0.3) / 0.2
    cdf = 0.5 * (1 + math.erf(z / math.sqrt(2)))
    pdf = math.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
    ei = R.expected_improvement(mean, var, torch.tensor(eta, dtype=F64), 1e-24)
    assert float(ei) == pytest.approx(0.2 * cdf + 0.2 * pdf, rel=1e-14)


def test_batch_mc_expected_improvement_by_hand():
    """Two points, two samples: each sample's least point below eta, averaged."""
    mean = torch.tensor([[0.0, 1.0]], dtype=F64)
    cov = torch.tensor([[[4.0, 0.0], [0.0, 1.0]]], dtype=F64)
    eps = torch.tensor([[1.0, -1.0], [-2.0, 0.5]], dtype=F64)
    # samples: point 0: 0 + 2*eps0 = [2, -2]; point 1: 1 + eps1 = [-1, 1.5]
    q = R.batch_mc_expected_improvement(mean, cov, torch.tensor(0.5, dtype=F64), eps, 0.0, R.FP64)
    assert float(q) == pytest.approx(((0.5 + 1.0) + (0.5 + 2.0)) / 2, rel=1e-14)


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 3.0 + 2**-12, -1.0 - 2**-11])
    assert R.tf32_round(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 3.0, -1.0 - 2**-10]


def test_fit_gap_is_zero_at_the_optimum_and_not_away():
    torch.manual_seed(0)
    X = torch.rand(12, 2, dtype=F64)
    Y = torch.sin(6 * X[:, :1]) + X[:, 1:]
    priors = R.Priors(0.0, torch.log(torch.tensor([0.3, 0.3], dtype=F64)), 1.0, math.log(1e3))
    h = hyper(lengthscales=(0.3, 0.3), noise=1e-2)
    u = R.fit_local(R.pack(h), X, Y, h, priors, R.FP64, max_iters=200)
    assert R.fit_gap(u, X, Y, h, priors) < 1e-12
    # a step of 0.1 in every log-parameter: the objective's rise, found again by the fit
    f = lambda v: float(R.neg_log_posterior(v, X, Y, h, priors, R.FP64))  # noqa: E731
    assert R.fit_gap(u + 0.1, X, Y, h, priors) == pytest.approx((f(u + 0.1) - f(u)) / 12,
                                                                rel=1e-6)


def test_reference_equals_the_programs_model_in_float64():
    """The same model definition: the program's exact posterior and EI in float64 on the
    CPU agree with the reference's to rounding."""
    from trieste_tpu_torch.data import Dataset
    from trieste_tpu_torch.models.gp.posterior import GPRParams, build_cache, predict_f_reference
    from trieste_tpu_torch.ops.kernels import stationary

    torch.manual_seed(1)
    X, x = torch.rand(20, 3, dtype=F64), torch.rand(50, 3, dtype=F64)
    Y = torch.cos(3 * X.sum(-1, keepdim=True))
    ls = [0.4, 0.5, 0.6]
    params = GPRParams(stationary("matern52", 0.8, ls, dtype=F64, device="cpu"),
                       torch.tensor(1e-3, dtype=F64), torch.tensor(0.1, dtype=F64))
    data = Dataset.from_arrays(X, Y)
    cache = build_cache(params, data.query_points, data.observations, data.mask,
                        with_linvt=False)
    mean, var = predict_f_reference(params, cache, x)
    h = R.Hyper(torch.tensor(0.8, dtype=F64), torch.tensor(ls, dtype=F64),
                torch.tensor(0.1, dtype=F64), 1e-3, 1e-6)  # float64's Cholesky jitter
    m, v = R.Posterior(X, Y, h, R.FP64).marginal(x)
    torch.testing.assert_close(m, mean[:, 0], rtol=1e-9, atol=1e-10)
    torch.testing.assert_close(v, var[:, 0], rtol=1e-8, atol=1e-10)


FLOPS = spec.load_module("metrics", "flops")


def test_fused_predict_counts_by_hand():
    N, n, D, P = 131072, 1000, 6, 1
    assert FLOPS.fused_predict_flops(N, n, D, P) == (
        1_572_864_000 + 262_144_000 + 131_203_072_000 + 262_144_000)
    assert FLOPS.fused_predict_bytes(N, n, D, P) == 4 * (786_432 + 6_000 + 1_000 + 500_500 + 2
                                                         + 131_072 + 131_072)
    assert FLOPS.fused_predict_least_s(N, n, D, P) == pytest.approx(133_300_224_000 / 495e12)


def test_step_counts_by_hand():
    n, D = 1000, 6
    lml = 2 * n * n * D + n**3 / 3 + 2 * n * n + 2 * n**3 / 3 + 2 * n * n * (D + 1)
    assert FLOPS.lml_value_and_grad_flops(n, D) == pytest.approx(lml)
    assert FLOPS.lml_value_and_grad_flops(n, D) == pytest.approx(1_000_000_000 + 28_000_000)
    assert FLOPS.cache_flops(n, D) == pytest.approx(12e6 + 2e9 / 3 + 2e6)
    assert FLOPS.marginal_flops(n, D) == 12_000 + 2_000 + 1_000_000 + 2_000
    B, S = 3, 2000
    assert FLOPS.joint_flops(B, 25, 2, S) == pytest.approx(
        300 + 150 + 1875 + 450 + 36 + 9 + 36_000)


@pytest.mark.parametrize("features", [64, 8])  # the capacity 16 at most m, and above it
def test_reference_trajectory_equals_the_programs_in_float64(features):
    """The family's replay of a trajectory's raw draws, and the reference's trajectory
    from them, against the program's own trajectory drawn from the same generator: the
    same function to rounding, on both of the program's routes."""
    from trieste_tpu_torch import Box, Dataset
    from trieste_tpu_torch.models.gp import build_gpr

    torch.manual_seed(3)
    X, x = torch.rand(12, 3, dtype=F64), torch.rand(40, 4, 3, dtype=F64)
    Y = torch.cos(3 * X.sum(-1, keepdim=True))
    data = Dataset.from_arrays(X, Y)
    space = Box([0.0] * 3, [1.0] * 3, dtype=F64, device="cpu")
    model = build_gpr(data, space, likelihood_variance=1e-3,
                      num_rff_features=features)
    g = torch.Generator().manual_seed(11)
    draws = spec.load_module("models", "build_gpr").trajectory_draws(model, g.get_state(), 4)
    program = model.trajectory_sampler().get_trajectory(g, batch_size=4)(x)[..., 0]
    k = model.params.kernel
    h = R.Hyper(k.variance, k.lengthscales.reshape(-1), model.params.mean_constant, 1e-3,
                1e-6)  # float64's Cholesky jitter
    reference = R.Posterior(X, Y, h, R.FP64).trajectory(draws())(x)
    assert (draws()["noise_normals"] is None) == (features < 16)
    torch.testing.assert_close(reference, program, rtol=1e-8, atol=1e-8)

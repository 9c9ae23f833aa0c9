"""The CUDA kernel of the port on the card: it builds, launches, matches its plain version
within the TPU kernel's contract, and serves the fused path of ``predict_f``.

These tests need a CUDA device and skip without one. The machine with the card has no JAX,
which ``tests/conftest.py`` imports, so run them there with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import pytest
import torch

from trieste_tpu_torch.models.gp import posterior as tpost
from trieste_tpu_torch.ops import fused_predict as fp
from trieste_tpu_torch.ops.kernels import stationary

pytestmark = pytest.mark.cuda

MEAN_TOL = dict(rtol=1e-3, atol=3e-4)
VAR_TOL = dict(rtol=5e-3, atol=3e-4)


@pytest.fixture()
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _state(kind, C, P, device, dtype=torch.float32, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.rand(C, 4, generator=g, dtype=torch.float64, device=device)
    Y = torch.cos(X @ torch.randn(4, P, generator=g, dtype=torch.float64, device=device))
    mask = torch.arange(C, device=device) < C - C // 4
    params = tpost.GPRParams(
        kernel=stationary(kind, 1.3, [0.5, 0.6, 0.7, 0.8], dtype=torch.float64, device=device),
        noise_variance=torch.tensor(1e-3, dtype=torch.float64, device=device),
        mean_constant=torch.tensor(0.1, dtype=torch.float64, device=device),
    )
    cache = tpost.build_cache(params, X * mask[:, None], Y * mask[:, None], mask)
    cast = lambda t: t.to(dtype)  # noqa: E731
    params = params.replace(
        kernel=params.kernel.replace(variance=cast(params.kernel.variance),
                                     lengthscales=cast(params.kernel.lengthscales)),
        noise_variance=cast(params.noise_variance), mean_constant=cast(params.mean_constant),
    )
    cache = cache.replace(X=cast(cache.X), L=cast(cache.L), alpha=cast(cache.alpha),
                          LinvT=cast(cache.LinvT))
    return params, cache, g


@pytest.mark.parametrize("C, P", [(100, 1), (1000, 2), (1024, 8)])
@pytest.mark.parametrize("kind", fp.KINDS)
def test_kernel_matches_plain_version(device, kind, C, P):
    params, cache, g = _state(kind, C, P, device)
    flat = torch.rand(4099, 4, generator=g, device=device)
    args = fp.operands(params, cache, flat)
    mean, var = fp.launch(*args)
    torch.cuda.synchronize()
    want_mean, want_var = fp.fused_predict_reference(args[0], *(t.double() for t in args[1:]))
    torch.testing.assert_close(mean.double(), want_mean, **MEAN_TOL)
    torch.testing.assert_close(var.double(), want_var, **VAR_TOL)


def test_predict_f_launches_the_kernel_and_grads_flow(device):
    params, cache, g = _state("matern52", 512, 1, device)
    x = torch.rand(fp.MIN_POINTS + 5, 4, generator=g, device=device, requires_grad=True)
    before = fp.launches
    mean, var = tpost.predict_f(params, cache, x)
    assert fp.launches == before + 1
    ref_mean, ref_var = tpost.predict_f_reference(params, cache, x)
    torch.testing.assert_close(mean, ref_mean, **MEAN_TOL)
    torch.testing.assert_close(var, ref_var, **VAR_TOL)
    (g_fused,) = torch.autograd.grad(mean.sum() + var.sqrt().sum(), x)
    (g_ref,) = torch.autograd.grad(ref_mean.sum() + ref_var.sqrt().sum(), x)
    # both backwards are the exact path's, but grad(sqrt(v)) weights the cotangent by
    # 1/sqrt(v) of each forward, two fp32 computations of a variance that is small near
    # the data: the tolerance of tests/unit/test_fused_predict.py:82 for the same reason
    torch.testing.assert_close(g_fused, g_ref, rtol=1e-2, atol=1e-3)


def test_gram_refuses_tf32_matmuls(device):
    kernel = stationary("rbf", 1.0, [0.5], dtype=torch.float32, device=device)
    x = torch.rand(16, 1, device=device)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            kernel(x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert kernel(x).shape == (16, 16)


def test_launch_rejects_what_the_kernel_does_not_take(device):
    params, cache, g = _state("rbf", 64, 1, device)
    args = fp.operands(params, cache, torch.rand(100, 4, generator=g, device=device))
    with pytest.raises(ValueError, match="float32"):
        fp.launch(args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        fp.launch(args[0], args[1], args[2], args[3], args[4].T, args[5])
    with pytest.raises(ValueError, match="shape mismatch"):
        fp.launch(args[0], args[1][:, :3].contiguous(), *args[2:])

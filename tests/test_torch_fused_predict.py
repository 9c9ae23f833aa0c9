"""The port's fused-prediction module on the CPU: its plain version against the JAX
package's exact reference (float64) and against the JAX Pallas kernel run in interpret mode
(float32, the kernel's precision contract), and the dispatch and fallback rules of
``tests/unit/test_fused_predict.py`` that need no mesh. The CUDA kernel itself runs only on
the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models.gp import posterior as jpost
from trieste_tpu.ops import fused_predict as jfp
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu_torch.convert import gpr_params_from_numpy
from trieste_tpu_torch.models.gp import posterior as tpost
from trieste_tpu_torch.models.gp.gpr import GaussianProcessRegression, _linvt_ok
from trieste_tpu_torch.data import Dataset
from trieste_tpu_torch.ops import fused_predict as tfp

torch.set_num_threads(1)

MEAN_TOL = dict(rtol=1e-3, atol=3e-4)  # the TPU kernel's contract
VAR_TOL = dict(rtol=5e-3, atol=3e-4)
LS = [0.4, 0.6, 0.5]


@pytest.fixture()
def cpu_plain(monkeypatch):
    """Route CPU tensors through the fused path's plain version at small pool sizes."""
    monkeypatch.setattr(tfp, "CPU_PLAIN", True)
    monkeypatch.setattr(tfp, "MIN_POINTS", 8)


@pytest.fixture()
def interpreted_pallas(monkeypatch):
    monkeypatch.setattr(jfp, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jfp, "MIN_POINTS", 8)


def _data(n=37, d=3, p=2, capacity=None, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    Y = np.stack([np.sum((X - 0.3) ** 2, -1), np.sum(X, -1), np.cos(3 * X[:, 0])] * 3, -1)[:, :p]
    cap = capacity or 1 << max(3, (n - 1).bit_length())
    Xp, Yp = np.zeros((cap, d)), np.zeros((cap, p))
    Xp[:n], Yp[:n] = X, Y
    return Xp, Yp, n


def _torch_state(kind, dtype, p=2, noise=1e-3, capacity=None, seed=0):
    Xp, Yp, n = _data(p=p, capacity=capacity, seed=seed)
    params = gpr_params_from_numpy(kind, 1.7, LS, noise, 0.25, device="cpu", dtype=dtype)
    ds = Dataset.from_arrays(torch.as_tensor(Xp[:n], dtype=dtype), torch.as_tensor(Yp[:n], dtype=dtype),
                             capacity=Xp.shape[0])
    cache = tpost.build_cache(params, ds.query_points, ds.observations, ds.mask)
    return params, cache


def _jax_state(kind, dtype, p=2, noise=1e-3, seed=0):
    Xp, Yp, n = _data(p=p, seed=seed)
    ds = JDataset.from_arrays(jnp.asarray(Xp[:n], dtype), jnp.asarray(Yp[:n], dtype), capacity=Xp.shape[0])
    params = jpost.GPRParams(
        kernel=jstationary(kind, 1.7, LS, dtype=dtype),
        noise_variance=jnp.asarray(noise, dtype),
        mean_constant=jnp.asarray(0.25, dtype),
    )
    return params, jpost.build_cache(params, ds.query_points, ds.observations, ds.mask)


def _queries(n, d=3, seed=7):
    return np.random.default_rng(seed).uniform(size=(n, d))


@pytest.mark.parametrize("P", [1, 2, 8])
@pytest.mark.parametrize("kind", tfp.KINDS)
def test_plain_version_matches_jax_reference_f64(kind, P):
    params, cache = _torch_state(kind, torch.float64, p=P)
    jparams, jcache = _jax_state(kind, jnp.float64, p=P)
    x = _queries(130)
    mean, var = tfp.fused_predict_reference(*tfp.operands(params, cache, torch.as_tensor(x)))
    jmean, jvar = jpost._predict_f_flat_reference(jparams, jcache, jnp.asarray(x))
    np.testing.assert_allclose(mean.numpy(), jmean, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar)[:, 0], rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("kind", tfp.KINDS)
def test_plain_version_matches_jax_kernel_f32(interpreted_pallas, cpu_plain, kind):
    params, cache = _torch_state(kind, torch.float32)
    jparams, jcache = _jax_state(kind, jnp.float32)
    x = _queries(130)
    assert jfp.can_fuse(jparams, jcache, jnp.asarray(x, jnp.float32))
    jmean, jvar = jfp.fused_predict_f(jparams, jcache, jnp.asarray(x, jnp.float32))
    flat = torch.as_tensor(x, dtype=torch.float32)
    assert tfp.can_fuse(params, cache, flat)
    mean, var = tfp.fused_predict_f(params, cache, flat)
    np.testing.assert_allclose(mean.numpy(), jmean, **MEAN_TOL)
    np.testing.assert_allclose(var.numpy(), jvar, **VAR_TOL)


@pytest.mark.parametrize("kind", tfp.KINDS)
def test_fused_matches_reference(cpu_plain, kind):
    params, cache = _torch_state(kind, torch.float32)
    x = torch.as_tensor(_queries(130), dtype=torch.float32)
    assert tfp.can_fuse(params, cache, x)
    mean_f, var_f = tfp.fused_predict_f(params, cache, x)
    mean_r, var_r = tpost.predict_f_reference(params, cache, x)
    np.testing.assert_allclose(mean_f.numpy(), mean_r.numpy(), **MEAN_TOL)
    np.testing.assert_allclose(var_f.numpy(), var_r.numpy(), **VAR_TOL)


def test_dispatch_uses_fused_and_grads_flow(cpu_plain, monkeypatch):
    params, cache = _torch_state("matern52", torch.float32, p=1)
    calls = []
    orig = tfp.fused_predict_f
    monkeypatch.setattr(tfp, "fused_predict_f", lambda *a: calls.append(1) or orig(*a))
    x = torch.as_tensor(_queries(64, seed=3), dtype=torch.float32)
    mean, var = tpost.predict_f(params, cache, x)
    assert calls == [1]
    mean_r, var_r = tpost.predict_f_reference(params, cache, x)
    np.testing.assert_allclose(mean.detach().numpy(), mean_r.numpy(), **MEAN_TOL)
    np.testing.assert_allclose(var.detach().numpy(), var_r.numpy(), **VAR_TOL)

    # the backward is the exact path's, whatever served the forward
    def grad(predict):
        q = x.clone().requires_grad_(True)
        m, v = predict(params, cache, q)
        (g,) = torch.autograd.grad(m.sum() + torch.sqrt(v).sum(), q)
        return g.numpy()

    np.testing.assert_allclose(grad(tpost.predict_f), grad(tpost.predict_f_reference), rtol=1e-3, atol=1e-4)
    assert len(calls) == 2


def test_predict_f_gradients_match_jax_f64():
    """Gradients through the autograd function, with respect to the queries and the
    hyperparameters, equal JAX's through its custom VJP."""
    params, cache = _torch_state("matern32", torch.float64, p=2)
    jparams, jcache = _jax_state("matern32", jnp.float64, p=2)
    x = _queries(9, seed=11)

    def jloss(q, ls):
        p = jparams.replace(kernel=jparams.kernel.replace(lengthscales=ls))
        m, v = jpost.predict_f(p, jcache, q)
        return jnp.sum(m * m) + jnp.sum(jnp.sqrt(v))

    jgx, jgls = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jparams.kernel.lengthscales)
    q = torch.as_tensor(x).requires_grad_(True)
    ls = params.kernel.lengthscales.clone().requires_grad_(True)
    p = params.replace(kernel=params.kernel.replace(lengthscales=ls))
    m, v = tpost.predict_f(p, cache, q)
    gx, gls = torch.autograd.grad(torch.sum(m * m) + torch.sum(torch.sqrt(v)), (q, ls))
    np.testing.assert_allclose(gx.numpy(), jgx, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(gls.numpy(), jgls, rtol=1e-9, atol=1e-12)


def test_small_pools_f64_and_large_states_fall_back(cpu_plain):
    params, cache = _torch_state("rbf", torch.float32)
    x = torch.zeros(4096, 3)
    assert tfp.can_fuse(params, cache, x)  # positive control: each negative has its cause
    assert not tfp.can_fuse(params, cache, torch.zeros(4, 3))
    assert not tfp.can_fuse(params, cache, x.double())
    assert not tfp.can_fuse(params, cache.replace(LinvT=None), x)
    big = tfp.MAX_TRAIN + 1
    cache_big = cache.replace(
        X=torch.zeros(big, 3), mask=torch.zeros(big, dtype=torch.bool), L=torch.eye(big),
        alpha=torch.zeros(big, 2), LinvT=torch.eye(big),
    )
    assert not tfp.can_fuse(params, cache_big, x)
    wide = cache.replace(alpha=torch.zeros(cache.X.shape[0], tfp.MAX_OUTPUTS + 1))
    assert not tfp.can_fuse(params, wide, x)


def test_cpu_tensors_need_the_flag(monkeypatch):
    """Without the test flag a CPU tensor never takes the fused path: the gate's device
    rule is "on CUDA"."""
    monkeypatch.setattr(tfp, "MIN_POINTS", 8)
    params, cache = _torch_state("rbf", torch.float32)
    assert not tfp.can_fuse(params, cache, torch.zeros(4096, 3))


def test_low_noise_conditioning_falls_back(cpu_plain):
    params, cache = _torch_state("rbf", torch.float32)
    x = torch.zeros(4096, 3)
    assert tfp.can_fuse(params, cache, x)  # noise 1e-3 / signal 1.7 is fine
    low = params.replace(noise_variance=torch.tensor(1e-7))
    assert not tfp.can_fuse(low, cache, x)


def test_batched_state_falls_back(cpu_plain):
    """Hyperparameters with a batch axis (one per restart) never reach the kernel."""
    params, cache = _torch_state("rbf", torch.float32, p=1)
    x = torch.zeros(4096, 3)
    k = params.kernel
    batched = params.replace(kernel=k.replace(variance=k.variance.expand(2)))
    assert not tfp.can_fuse(batched, cache, x)
    stacked = cache.replace(X=cache.X.expand(2, -1, -1))
    assert not tfp.can_fuse(params, stacked, x)
    assert not tfp.can_fuse(params, cache, x.expand(2, -1, -1))


def test_padding_independence(cpu_plain):
    """The training capacity's padding does not change the fused results."""
    x = torch.as_tensor(_queries(33, d=3, seed=9), dtype=torch.float32)
    outs = [tfp.fused_predict_f(*_torch_state("matern32", torch.float32, capacity=cap), x)
            for cap in (64, 256)]
    np.testing.assert_allclose(outs[0][0].numpy(), outs[1][0].numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(outs[0][1].numpy(), outs[1][1].numpy(), rtol=1e-3, atol=1e-6)


def test_tiny_noise_models_skip_linvt():
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.uniform(size=(16, 2)), dtype=torch.float32)
    ds = Dataset.from_arrays(X, X.sum(-1, keepdim=True))

    def mk(noise):
        return gpr_params_from_numpy("rbf", 1.0, [0.5, 0.5], noise, 0.0, device="cpu",
                                     dtype=torch.float32)

    tiny = GaussianProcessRegression(mk(1e-7), ds)
    assert tiny.posterior_cache.LinvT is None
    mean, var = tiny.predict(X[:4])
    assert bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())
    assert GaussianProcessRegression(mk(1e-2), ds).posterior_cache.LinvT is not None
    assert not _linvt_ok(mk(1e-7)) and _linvt_ok(mk(1e-2))


def test_cached_linvt_is_zero_on_padding():
    _, cache = _torch_state("matern52", torch.float64, capacity=64)
    n = int(cache.mask.sum())
    assert torch.all(cache.LinvT[n:] == 0) and torch.all(cache.LinvT[:, n:] == 0)
    assert torch.all(cache.alpha[n:] == 0)
    assert cache.LinvT.is_contiguous()


def test_no_fallback_off_the_cpu():
    """The kernel's launcher takes CUDA tensors only, and the wrapper serves no other
    device with the plain version."""
    params, cache = _torch_state("rbf", torch.float32)
    args = tfp.operands(params, cache, torch.zeros(64, 3))
    with pytest.raises(ValueError, match="CUDA"):
        tfp.launch(*args)
    with pytest.raises(ValueError, match="unknown kernel kind"):
        tfp.launch("cosine", *args[1:])
    meta = lambda t: t.to("meta")  # noqa: E731
    meta_params = params.replace(
        kernel=params.kernel.replace(variance=meta(params.kernel.variance),
                                     lengthscales=meta(params.kernel.lengthscales)),
        mean_constant=meta(params.mean_constant),
    )
    meta_cache = cache.replace(X=meta(cache.X), mask=meta(cache.mask), alpha=meta(cache.alpha),
                               LinvT=meta(cache.LinvT))
    with pytest.raises(ValueError, match="no fused prediction"):
        tfp.fused_predict_f(meta_params, meta_cache, torch.zeros(64, 3, device="meta"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(tfp, "_BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tfp.build()
    assert not (tmp_path / "kernels").exists()

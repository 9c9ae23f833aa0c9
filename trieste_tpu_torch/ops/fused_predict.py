"""Fused exact-GP marginal prediction: a CUDA kernel for Hopper and its plain version.

Counterpart of :mod:`trieste_tpu.ops.fused_predict`. The seed-scoring phase of the
continuous acquisition optimizer predicts over ``max(5000, 1000·D)`` candidates (or more)
per BO step; the unfused path writes the ``[N, C]`` cross-covariance to device memory and
reads it back for the mean matmul and the triangular solve. The kernel in
``csrc/fused_predict.cu`` fuses, per block of candidate rows,

    r² = Σ_d (x_d/ℓ_d − X_d/ℓ_d)²,   K = σ²·k(r),   mean = K·α + m,
    v = K·L⁻ᵀ,   var = max(σ² − Σ_j v², 1e-24),

with the precomputed masked triangular inverse ``LinvT`` of the posterior cache, so the
cross-covariance never leaves the chip. Everything is fp32 FMA: at least as accurate as
the TPU kernel's 3-pass bf16 contract (mean rtol 1e-3 / atol 3e-4, variance rtol 5e-3 /
atol 3e-4). Padded training slots are inert because ``alpha`` and ``LinvT`` are zero
there (:func:`trieste_tpu_torch.models.gp.posterior.build_cache` keeps that invariant).

The kernel is built on first use with ``nvcc`` into ``build/kernels/`` beside the
package, keyed by a hash of its source and flags, and bound through ``ctypes``. A CUDA
tensor either launches it or raises; :func:`fused_predict_reference`, the plain torch
version of the same function, serves CPU tensors and the tests. The kernel is
forward-only: :func:`trieste_tpu_torch.models.gp.posterior.predict_f` takes gradients
through the exact reference math.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Tuple

import torch

from .kernels import KINDS, _stationary_fn

CPU_PLAIN = False
"""Let :func:`can_fuse` accept CPU tensors, which :func:`fused_predict_f` then serves with
the plain version (the role of ``FORCE_INTERPRET`` in the JAX package); tests set it."""

MIN_POINTS = 2048
"""Below this many query points the fused path is not taken (as in the JAX package: it
also keeps the kernel out of the small L-BFGS batches, whose gradients need the exact
path anyway)."""

MAX_TRAIN = 1024
"""Largest training capacity the kernel takes: its ``K[32, C]`` block must fit the
227 KB of shared memory a block can use, and the JAX package gates at the same size."""

MAX_OUTPUTS = 8
"""Largest number of outputs ``P``: the kernel unrolls its mean reduction over them."""

launches = 0
"""Number of kernel launches made by :func:`launch` in this process."""

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fused_predict.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found under {home}/bin or on PATH")
    return found


def library_path() -> Path:
    """Where the built kernel library lives: keyed by the source and the flags."""
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_NVCC_FLAGS).encode())
    return _BUILD_DIR / f"fused_predict_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/fused_predict.cu`` unless this source is built already; raise on
    any compiler failure."""
    target = library_path()
    if target.exists():
        return target
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc, *_NVCC_FLAGS, "-o", tmp, str(_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, target)  # atomic: concurrent builders each publish a whole file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return target


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.fused_predict_launch.argtypes = (
                [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            )
            lib.fused_predict_launch.restype = ctypes.c_int
            lib.fused_predict_error_string.argtypes = [ctypes.c_int]
            lib.fused_predict_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def fused_predict_reference(
    kind: str,
    xs: torch.Tensor,
    A: torch.Tensor,
    alpha: torch.Tensor,
    LinvT: torch.Tensor,
    scal: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel, in the dtype it is given: ``xs [N, D]``,
    ``A [C, D]``, ``alpha [C, P]``, ``LinvT [C, C]``, ``scal [2]`` (signal variance, mean
    constant) ``-> (mean [N, P], var [N])``."""
    r2 = torch.zeros(xs.shape[0], A.shape[0], dtype=xs.dtype, device=xs.device)
    for d in range(xs.shape[1]):  # one [N, C] buffer at a time, not an [N, C, D] one
        r2 += torch.square(xs[:, d : d + 1] - A[:, d])
    K = scal[0] * _stationary_fn(kind, r2)
    mean = K @ alpha + scal[1]
    v = K @ LinvT
    var = torch.clamp_min(scal[0] - torch.sum(v * v, dim=-1), 1e-24)
    return mean, var


def launch(
    kind: str,
    xs: torch.Tensor,
    A: torch.Tensor,
    alpha: torch.Tensor,
    LinvT: torch.Tensor,
    scal: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel on the current stream; same contract as
    :func:`fused_predict_reference` for fp32 CUDA tensors. Raises on anything else."""
    global launches
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}")
    named = {"xs": xs, "A": A, "alpha": alpha, "LinvT": LinvT, "scal": scal}
    for name, t in named.items():
        if not t.is_cuda or t.device != xs.device:
            raise ValueError(f"{name} must be a CUDA tensor on {xs.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xs.ndim != 2 or A.ndim != 2 or alpha.ndim != 2 or LinvT.ndim != 2:
        raise ValueError("xs, A, alpha and LinvT must be rank 2")
    N, D = xs.shape
    C, P = alpha.shape
    if A.shape != (C, D) or LinvT.shape != (C, C) or scal.shape != (2,):
        raise ValueError(
            f"shape mismatch: xs {tuple(xs.shape)}, A {tuple(A.shape)}, alpha "
            f"{tuple(alpha.shape)}, LinvT {tuple(LinvT.shape)}, scal {tuple(scal.shape)}"
        )
    if not 1 <= C <= MAX_TRAIN or not 1 <= P <= MAX_OUTPUTS or N >= 2**31:
        raise ValueError(f"unsupported sizes N={N}, C={C}, D={D}, P={P}")
    lib = library()
    mean = torch.empty((N, P), dtype=torch.float32, device=xs.device)
    var = torch.empty((N,), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = lib.fused_predict_launch(
            KINDS.index(kind), xs.data_ptr(), A.data_ptr(), alpha.data_ptr(),
            LinvT.data_ptr(), scal.data_ptr(), mean.data_ptr(), var.data_ptr(),
            N, C, D, P, stream,
        )
    if err != 0:
        msg = lib.fused_predict_error_string(err).decode()
        raise RuntimeError(f"fused_predict kernel launch failed: {msg} ({err})")
    launches += 1
    return mean, var


def can_fuse(params, cache, flat: torch.Tensor) -> bool:
    """The JAX package's gate (``trieste_tpu/ops/fused_predict.py:can_fuse``): stationary
    kernel, ``LinvT`` present, fp32, unbatched 2-D operands, ``P <= 8``, at least
    :data:`MIN_POINTS` queries, capacity at most :data:`MAX_TRAIN` and a noise/signal
    ratio of at least 1e-5; then the query tensor must lie on a CUDA device (or
    :data:`CPU_PLAIN` must be set)."""
    kernel = params.kernel
    if kernel.kind not in KINDS or cache.LinvT is None:
        return False
    if flat.dtype != torch.float32 or cache.X.dtype != torch.float32:
        return False
    if flat.ndim != 2 or cache.X.ndim != 2 or cache.alpha.ndim != 2:
        return False
    if cache.alpha.shape[-1] > MAX_OUTPUTS:
        return False
    if kernel.variance.ndim != 0 or kernel.lengthscales.ndim > 1:
        return False
    if flat.shape[0] < MIN_POINTS or cache.X.shape[0] > MAX_TRAIN:
        return False
    # the variance contract is absolute: below this ratio the true variance near the
    # data is smaller than the error (one device-to-host read per large pool)
    if float(params.noise_variance) / max(float(kernel.variance), 1e-30) < 1e-5:
        return False
    return flat.is_cuda or CPU_PLAIN


def operands(params, cache, flat: torch.Tensor):
    """The kernel's operands for a posterior, in its dtype: ``(kind, xs, A, alpha, LinvT,
    scal)``. Padded training rows of ``A`` are zeroed like those of ``alpha``."""
    ls = params.kernel.lengthscales.expand(flat.shape[-1])
    A = (cache.X * cache.mask.to(cache.X.dtype)[:, None]) / ls
    scal = torch.stack([params.kernel.variance, params.mean_constant])
    return (
        params.kernel.kind, (flat / ls).contiguous(), A.contiguous(),
        cache.alpha.contiguous(), cache.LinvT.contiguous(), scal,
    )


def fused_predict_f(params, cache, flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flat [N, D] -> (mean [N, P], var [N, P])``: the kernel for CUDA tensors, the plain
    version for CPU tensors. Call only where :func:`can_fuse` holds."""
    args = operands(params, cache, flat)
    if flat.is_cuda:
        mean, var = launch(*args)
    elif flat.device.type == "cpu":
        mean, var = fused_predict_reference(*args)
    else:
        raise ValueError(f"no fused prediction for device {flat.device}")
    return mean, var[:, None].expand(mean.shape)

"""Stationary GP covariance kernels (counterpart of :mod:`trieste_tpu.ops.kernels`).

A :class:`Stationary` holds tensors with optional leading batch dims: ``variance [...]``
and ``lengthscales [..., D]`` (ARD) or ``[..., 1]`` (isotropic). A batch of kernel
hyperparameters, such as the restarts of a multi-start fit, is a leading axis that
:func:`gram` broadcasts over.

The Gram assembly uses the ``|a|² + |b|² − 2a·b`` expansion, so its cost is one matmul,
which must run in full fp32 on the card: kernel matrices feed Cholesky factorizations,
and TF32 keeps only 10 mantissa bits. :func:`gram` therefore raises on fp32 CUDA tensors
while ``torch.backends.cuda.matmul.allow_tf32`` is set; PyTorch's default leaves it off.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch

from ..utils.misc import default_float

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)

RBF = "rbf"
MATERN12 = "matern12"
MATERN32 = "matern32"
MATERN52 = "matern52"
KINDS = (RBF, MATERN12, MATERN32, MATERN52)


@dataclass(frozen=True)
class Stationary:
    """A stationary kernel ``variance * k(r)`` with ARD lengthscales."""

    variance: torch.Tensor
    lengthscales: torch.Tensor
    kind: str = RBF

    def __call__(self, a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
        return gram(self, a, b)

    def diag(self, a: torch.Tensor) -> torch.Tensor:
        return self.variance.expand(a.shape[:-1])

    def replace(self, **changes) -> "Stationary":
        return dataclasses.replace(self, **changes)


def stationary(
    kind: str,
    variance: float = 1.0,
    lengthscales: Union[float, Sequence[float], torch.Tensor] = 1.0,
    dtype: Optional[torch.dtype] = None,
    device: Union[str, torch.device] = "cuda",
) -> Stationary:
    """Construct a stationary kernel; a scalar lengthscale becomes shape ``[1]``."""
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}; choose from {KINDS}")
    dtype = dtype or default_float()
    return Stationary(
        variance=torch.as_tensor(variance, dtype=dtype, device=device),
        lengthscales=torch.atleast_1d(torch.as_tensor(lengthscales, dtype=dtype, device=device)),
        kind=kind,
    )


def scaled_squared_distance(
    a: torch.Tensor, b: torch.Tensor, lengthscales: torch.Tensor
) -> torch.Tensor:
    """``[..., N, M]`` pairwise squared distances of ``a/ℓ`` and ``b/ℓ``."""
    ls = lengthscales.unsqueeze(-2)
    a = a / ls
    b = b / ls
    a2 = torch.sum(torch.square(a), dim=-1)
    b2 = torch.sum(torch.square(b), dim=-1)
    ab = a @ b.transpose(-1, -2)
    r2 = a2[..., :, None] + b2[..., None, :] - 2.0 * ab
    return torch.clamp_min(r2, 0.0)


def _stationary_fn(kind: str, r2: torch.Tensor) -> torch.Tensor:
    if kind == RBF:
        return torch.exp(-0.5 * r2)
    # Matérn kernels need r; the guard keeps the gradient finite at r == 0
    r = torch.sqrt(torch.clamp_min(r2, 1e-36))
    if kind == MATERN12:
        return torch.exp(-r)
    if kind == MATERN32:
        z = _SQRT3 * r
        return (1.0 + z) * torch.exp(-z)
    if kind == MATERN52:
        z = _SQRT5 * r
        return (1.0 + z + z * z / 3.0) * torch.exp(-z)
    raise ValueError(f"unknown kernel kind {kind!r}")


def gram(kernel: Stationary, a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel matrix ``K(a, b)`` of shape ``[..., N, M]`` (``b=None`` means ``K(a, a)``)."""
    b = a if b is None else b
    if a.is_cuda and a.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the Gram needs full fp32 matmuls: set torch.backends.cuda.matmul.allow_tf32 = False"
        )
    r2 = scaled_squared_distance(a, b, kernel.lengthscales)
    return kernel.variance[..., None, None] * _stationary_fn(kernel.kind, r2)

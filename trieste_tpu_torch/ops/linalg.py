"""Masked GP linear algebra (counterpart of :mod:`trieste_tpu.ops.linalg`).

GP math works on fixed-capacity padded buffers, so every Gram routine is mask-aware:
padded rows and columns are replaced by the identity, which makes the Cholesky factor,
the log-determinant and the solves of the padded system exactly those of the trimmed one.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.misc import jitter_for


def masked_gram(K: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Replace padded rows/cols of a ``[..., N, N]`` Gram matrix by the identity."""
    m = mask.to(K.dtype)
    outer = m[..., :, None] * m[..., None, :]
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return K * outer + eye * (1.0 - m[..., :, None])


def masked_cholesky(
    K: torch.Tensor, mask: Optional[torch.Tensor] = None, jitter: Optional[float] = None
) -> torch.Tensor:
    """Cholesky of ``K + jitter*I`` with padded rows/cols as identity (the jitter goes on
    valid rows only).

    A matrix that is not positive definite gives a lower triangle of NaNs, as JAX's
    Cholesky does, instead of raising: an L-BFGS restart that wanders there then loses (its loss
    becomes ``+inf``) without stopping the others."""
    j = jitter_for(K.dtype) if jitter is None else jitter
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    if mask is None:
        Kj = K + j * eye
    else:
        Kj = masked_gram(K + j * eye * mask.to(K.dtype)[..., :, None], mask)
    L, info = torch.linalg.cholesky_ex(Kj)
    return torch.where((info != 0)[..., None, None], torch.nan, L).tril()


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L x = b`` for lower-triangular ``L``."""
    return torch.linalg.solve_triangular(L, b, upper=False)


def solve_upper(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``Lᵀ x = b`` for lower-triangular ``L``."""
    return torch.linalg.solve_triangular(L.transpose(-1, -2), b, upper=True)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``(L Lᵀ) x = b``."""
    return solve_upper(L, solve_lower(L, b))

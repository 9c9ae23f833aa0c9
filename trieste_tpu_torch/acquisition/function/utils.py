"""Acquisition-function numerics: the Genz multivariate-normal CDF (counterpart of
:mod:`trieste_tpu.acquisition.function.utils`).

Genz's (1992) sequential-conditioning estimator with quasi-Monte-Carlo points: a loop
over the (small) dimension ``Q``, every QMC sample and every candidate set at once, and
differentiable, for gradient-based maximization of the analytic batch EI.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ...ops.linalg import nan_cholesky
from ...ops.qmc import sobol_sample
from ...utils.misc import jitter_for

_EPS = 1e-6


def _safe_ndtri(p: torch.Tensor) -> torch.Tensor:
    return torch.special.ndtri(torch.clamp(p, _EPS, 1.0 - _EPS))


def mvn_cdf(
    x: torch.Tensor,  # [..., Q] upper limits
    mean: torch.Tensor,  # [..., Q]
    cov: torch.Tensor,  # [..., Q, Q]
    qmc_points: torch.Tensor,  # [S, >= Q-1] uniforms in (0, 1)
) -> torch.Tensor:
    """``P(X <= x)`` for ``X ~ N(mean, cov)`` by the Genz algorithm, shape ``[...]``.

    Differentiable in ``x``, ``mean`` and ``cov``; the accuracy improves with the number
    of QMC points (64 to 256 suffice for acquisition purposes)."""
    Q = x.shape[-1]
    if Q == 1:
        std = torch.sqrt(torch.clamp_min(cov[..., 0, 0], 1e-24))
        return torch.special.ndtr((x[..., 0] - mean[..., 0]) / std)
    b = x - mean
    eye = torch.eye(Q, dtype=cov.dtype, device=cov.device)
    L = nan_cholesky(cov + jitter_for(cov.dtype) * eye)  # [..., Q, Q]
    w = torch.clamp(qmc_points, _EPS, 1.0 - _EPS)
    w = w.reshape(w.shape[:1] + (1,) * (b.ndim - 1) + w.shape[1:])  # [S, 1..., Q-1]
    # sequential conditioning: e_i = Phi((b_i - sum_{j<i} L_ij y_j) / L_ii), one leading
    # axis for the QMC samples
    ys: list = []
    f = torch.ones((qmc_points.shape[0],) + b.shape[:-1], dtype=b.dtype, device=b.device)
    for i in range(Q):
        partial_dot = sum((L[..., i, j] * ys[j] for j in range(i)), torch.zeros_like(f))
        e = torch.special.ndtr((b[..., i] - partial_dot) / torch.clamp_min(L[..., i, i], 1e-24))
        if i < Q - 1:
            ys.append(_safe_ndtri(w[..., i] * e))
        f = f * e
    return torch.clamp(torch.mean(f, dim=0), 0.0, 1.0)


def make_mvn_cdf(
    num_qmc_samples: int = 128,
    dimension: int = 2,
    dtype: Optional[torch.dtype] = None,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """A frozen QMC point set ``[S, max(dimension - 1, 1)]`` for :func:`mvn_cdf`."""
    return sobol_sample(num_qmc_samples, max(dimension - 1, 1), skip=1, dtype=dtype, device=device)


class MultivariateNormalCDF:
    """Object form of :func:`mvn_cdf` with its own QMC point set."""

    def __init__(
        self,
        sample_size: int,
        dim: int,
        dtype: Optional[torch.dtype] = None,
        num_sobol_skip: int = 0,
        device: Union[str, torch.device] = "cuda",
    ):
        if sample_size <= 0:
            raise ValueError(f"sample_size must be positive, got {sample_size}")
        if dim <= 0:
            raise ValueError(f"dim must be positive, got {dim}")
        self._qmc_points = sobol_sample(
            sample_size, max(dim - 1, 1), skip=num_sobol_skip + 1, dtype=dtype, device=device
        )

    def __call__(self, x: torch.Tensor, mean: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
        return mvn_cdf(x, mean, cov, self._qmc_points)

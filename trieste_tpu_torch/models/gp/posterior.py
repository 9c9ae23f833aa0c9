"""Exact-GP posterior numerics (counterpart of :mod:`trieste_tpu.models.gp.posterior`):
log marginal likelihood, the posterior cache, and marginal predictions.

Everything works on fixed-capacity padded buffers with a validity mask (see
:mod:`trieste_tpu_torch.ops.linalg`). :func:`log_marginal_likelihood` also takes
hyperparameters with a leading batch axis (one per restart of a multi-start fit).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ...ops import fused_predict
from ...ops.kernels import Stationary, gram
from ...ops.linalg import cho_solve, masked_cholesky, solve_lower
from ...utils.misc import flatten_leading_dims


@dataclass(frozen=True)
class GPRParams:
    """Exact-GPR hyperparameters: kernel, Gaussian likelihood and constant mean."""

    kernel: Stationary
    noise_variance: torch.Tensor  # scalar (or [...] batched)
    mean_constant: torch.Tensor  # scalar (or [...] batched)

    def replace(self, **changes) -> "GPRParams":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class GPRCache:
    """Everything needed for O(N·C) predictions after an O(C³) factorization.

    ``L`` is the masked Cholesky of ``K(X,X) + σ²I`` (identity on padded rows);
    ``alpha = (LLᵀ)⁻¹ (Y − m)`` has zero padded rows. ``LinvT = (L⁻¹)ᵀ``, zero on padded
    rows and columns, feeds the fused prediction kernel; ``None`` disables that path.
    """

    X: torch.Tensor  # [C, D]
    mask: torch.Tensor  # [C] bool
    L: torch.Tensor  # [C, C]
    alpha: torch.Tensor  # [C, P]
    LinvT: Optional[torch.Tensor] = None  # [C, C], contiguous

    def replace(self, **changes) -> "GPRCache":
        return dataclasses.replace(self, **changes)


def _noisy_cholesky(params: GPRParams, X: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    K = gram(params.kernel, X)
    eye = torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
    return masked_cholesky(K + params.noise_variance[..., None, None] * eye, mask)


def build_cache(
    params: GPRParams, X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor, *,
    with_linvt: bool = True,
) -> GPRCache:
    """Factorize the training covariance. ``with_linvt=False`` skips the O(C³) triangular
    inverse that only the fused prediction kernel uses."""
    m = mask.to(X.dtype)
    L = _noisy_cholesky(params, X, mask)
    ym = (Y - params.mean_constant) * m[:, None]
    alpha = cho_solve(L, ym)
    if not with_linvt:
        return GPRCache(X=X, mask=mask, L=L, alpha=alpha, LinvT=None)
    # the padded block of L is the identity, so zeroing its rows and columns removes the
    # padded contribution exactly: padded slots stay inert in the fused kernel
    eye = torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
    Linv = solve_lower(L, eye) * (m[:, None] * m[None, :])
    return GPRCache(X=X, mask=mask, L=L, alpha=alpha, LinvT=Linv.T.contiguous())


def log_marginal_likelihood(
    params: GPRParams, X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Exact GPR log marginal likelihood of the valid rows, ``[...]`` for hyperparameters
    with leading batch dims ``[...]``."""
    m = mask.to(X.dtype)
    n = torch.sum(m)
    num_outputs = Y.shape[-1]
    L = _noisy_cholesky(params, X, mask)
    ym = (Y - params.mean_constant[..., None, None]) * m[:, None]
    alpha = cho_solve(L, ym)
    quad = torch.sum(ym * alpha, dim=(-2, -1))
    # padded diagonal entries of L are exactly 1 and contribute log 1 = 0
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    const = n * num_outputs * math.log(2.0 * math.pi)
    return -0.5 * (quad + num_outputs * logdet + const)


def _masked_cross_cov(params: GPRParams, cache: GPRCache, x: torch.Tensor) -> torch.Tensor:
    """``K(x, X)`` with padded training columns zeroed, ``[N, C]``."""
    Kxn = gram(params.kernel, x, cache.X)
    return Kxn * cache.mask.to(Kxn.dtype)[None, :]


def _predict_f_flat_reference(
    params: GPRParams, cache: GPRCache, flat: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact marginal posterior over flattened queries: ``[N, D] -> ([N, P], [N, P])``."""
    Kxn = _masked_cross_cov(params, cache, flat)  # [N, C]
    mean = Kxn @ cache.alpha + params.mean_constant  # [N, P]
    v = solve_lower(cache.L, Kxn.T)  # [C, N]
    var = params.kernel.diag(flat) - torch.sum(torch.square(v), dim=0)
    var = torch.clamp_min(var, 1e-24)
    return mean, var[:, None].expand(mean.shape)


def _predict_f_flat_impl(
    params: GPRParams, cache: GPRCache, flat: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel for large candidate pools, the exact path otherwise."""
    if fused_predict.can_fuse(params, cache, flat):
        return fused_predict.fused_predict_f(params, cache, flat)
    return _predict_f_flat_reference(params, cache, flat)


class _PredictFFlat(torch.autograd.Function):
    """Forward as :func:`_predict_f_flat_impl`; backward the VJP of the exact reference,
    recomputed (the fused kernel is forward-only)."""

    @staticmethod
    def forward(ctx, kind, mask, LinvT, flat, variance, lengthscales, noise, mean_constant,
                X, L, alpha):
        params, cache = _unpack(kind, mask, LinvT, variance, lengthscales, noise,
                                mean_constant, X, L, alpha)
        ctx.kind = kind
        ctx.save_for_backward(mask, flat, variance, lengthscales, noise, mean_constant, X, L,
                              alpha)
        return _predict_f_flat_impl(params, cache, flat)

    @staticmethod
    def backward(ctx, grad_mean, grad_var):
        mask, *tensors = ctx.saved_tensors
        wanted = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(w) for t, w in zip(tensors, wanted)]
            flat, variance, lengthscales, noise, mean_constant, X, L, alpha = inputs
            params, cache = _unpack(ctx.kind, mask, None, variance, lengthscales, noise,
                                    mean_constant, X, L, alpha)
            outputs = _predict_f_flat_reference(params, cache, flat)
            sources = [t for t, w in zip(inputs, wanted) if w]
            grads = iter(torch.autograd.grad(outputs, sources, (grad_mean, grad_var),
                                             allow_unused=True))
        return (None, None, None) + tuple(next(grads) if w else None for w in wanted)


def _unpack(kind, mask, LinvT, variance, lengthscales, noise, mean_constant, X, L, alpha):
    kernel = Stationary(variance=variance, lengthscales=lengthscales, kind=kind)
    params = GPRParams(kernel=kernel, noise_variance=noise, mean_constant=mean_constant)
    return params, GPRCache(X=X, mask=mask, L=L, alpha=alpha, LinvT=LinvT)


def predict_f(
    params: GPRParams, cache: GPRCache, query_points: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Marginal posterior: ``[..., D] -> mean [..., P], var [..., P]``."""
    flat, unflatten = flatten_leading_dims(query_points, output_dims=2)
    k = params.kernel
    mean, var = _PredictFFlat.apply(
        k.kind, cache.mask, cache.LinvT, flat, k.variance, k.lengthscales,
        params.noise_variance, params.mean_constant, cache.X, cache.L, cache.alpha,
    )
    return unflatten(mean), unflatten(var)


def predict_f_reference(
    params: GPRParams, cache: GPRCache, query_points: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`predict_f` without the fused dispatch."""
    flat, unflatten = flatten_leading_dims(query_points, output_dims=2)
    mean, var = _predict_f_flat_reference(params, cache, flat)
    return unflatten(mean), unflatten(var)


def predict_y(
    params: GPRParams, cache: GPRCache, query_points: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    mean, var = predict_f(params, cache, query_points)
    return mean, var + params.noise_variance

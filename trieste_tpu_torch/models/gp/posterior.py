"""Exact-GP posterior numerics (counterpart of :mod:`trieste_tpu.models.gp.posterior`):
log marginal likelihood, the posterior cache, marginal and joint predictions, joint
samples, and closed-form conditioning on extra data.

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
from ...ops.linalg import cho_solve, masked_cholesky, nan_cholesky, solve_lower
from ...utils.misc import flatten_leading_dims, jitter_for, standard_normal


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
    inverse that only the fused prediction kernel uses; it also takes hyperparameters with
    leading batch dims ``[...]``, and gives ``L [..., C, C]`` and ``alpha [..., C, P]``."""
    m = mask.to(X.dtype)
    L = _noisy_cholesky(params, X, mask)
    ym = (Y - params.mean_constant[..., None, None]) * m[:, None]
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


class _PredictFFlat(torch.autograd.Function):
    """Forward by the fused kernel; backward the VJP of the exact reference, recomputed
    (the kernel is forward-only)."""

    @staticmethod
    def forward(ctx, kind, mask, LinvT, flat, variance, lengthscales, noise, mean_constant,
                X, L, alpha):
        params, cache = _unpack(kind, mask, LinvT, variance, lengthscales, noise,
                                mean_constant, X, L, alpha)
        ctx.kind = kind
        ctx.save_for_backward(mask, flat, variance, lengthscales, noise, mean_constant, X, L,
                              alpha)
        return fused_predict.fused_predict_f(params, cache, flat)

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
    """Marginal posterior: ``[..., D] -> mean [..., P], var [..., P]``: the fused kernel
    for large candidate pools, the exact path (differentiated as it runs) otherwise."""
    flat, unflatten = flatten_leading_dims(query_points, output_dims=2)
    if not fused_predict.can_fuse(params, cache, flat):
        mean, var = _predict_f_flat_reference(params, cache, flat)
        return unflatten(mean), unflatten(var)
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


def predict_joint(
    params: GPRParams, cache: GPRCache, query_points: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint posterior over a batch: ``[..., B, D] -> mean [..., B, P], cov [..., P, B, B]``.
    All leading dims share one cross-covariance and one triangular solve. Never fused."""
    lead, B = query_points.shape[:-2], query_points.shape[-2]
    flat = query_points.reshape(-1, query_points.shape[-1])  # [R*B, D]
    Kxn = _masked_cross_cov(params, cache, flat)  # [R*B, C]
    mean = Kxn @ cache.alpha + params.mean_constant  # [R*B, P]
    v = solve_lower(cache.L, Kxn.T).T.reshape(-1, B, Kxn.shape[-1])  # [R, B, C]
    cov = gram(params.kernel, query_points.reshape(-1, B, flat.shape[-1])) - v @ v.transpose(-1, -2)
    P = mean.shape[-1]
    return mean.reshape(lead + (B, P)), cov.reshape(lead + (1, B, B)).expand(lead + (P, B, B))


def _joint_samples(
    mean: torch.Tensor, cov: torch.Tensor, eps: torch.Tensor, jitter: Optional[float] = None
) -> torch.Tensor:
    """``mean [..., B, P] + chol(cov + jitter I) eps`` for ``cov [..., P, B, B]`` and
    ``eps [..., P, S, B]``, as ``[..., S, B, P]``; the jitter defaults to the dtype's."""
    jitter = jitter_for(cov.dtype) if jitter is None else jitter
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    Lc = nan_cholesky(cov + jitter * eye)
    samp = torch.einsum("...pij,...psj->...psi", Lc, eps)  # [..., P, S, B]
    return torch.movedim(samp, -3, -1) + mean[..., None, :, :]


def _draw_joint_eps(
    generator: Optional[torch.Generator], cov_shape: Tuple[int, ...], num_samples: int,
    like: torch.Tensor,
) -> torch.Tensor:
    return standard_normal(generator, tuple(cov_shape[:-2]) + (num_samples, cov_shape[-1]), like)


def _in_float64(params: GPRParams, cache: GPRCache) -> Tuple[GPRParams, GPRCache]:
    kernel = params.kernel.replace(variance=params.kernel.variance.double(),
                                   lengthscales=params.kernel.lengthscales.double())
    params = GPRParams(kernel, params.noise_variance.double(), params.mean_constant.double())
    return params, GPRCache(X=cache.X.double(), mask=cache.mask, L=cache.L.double(),
                            alpha=cache.alpha.double())


def sample_joint_from_eps(
    params: GPRParams, cache: GPRCache, query_points: torch.Tensor, eps: torch.Tensor
) -> torch.Tensor:
    """Joint posterior samples ``[..., S, B, P]`` at ``[..., B, D]`` from standard-normal
    base draws ``eps [..., P, S, B]``.

    The joint covariance is assembled and factorized in float64 whatever the inputs'
    dtype, and the samples are returned in it: over a thousand nearby candidates (exact
    Thompson sampling) the float32 covariance has eigenvalues below −1e-5 from rounding
    alone, beyond its jitter, and no Cholesky factor."""
    dtype = query_points.dtype
    params64, cache64 = _in_float64(params, cache)
    mean, cov = predict_joint(params64, cache64, query_points.double())
    return _joint_samples(mean, cov, eps.double(), jitter_for(dtype)).to(dtype)


def sample_joint(
    generator: Optional[torch.Generator],
    params: GPRParams,
    cache: GPRCache,
    query_points: torch.Tensor,
    num_samples: int,
) -> torch.Tensor:
    """Joint posterior samples ``[..., S, B, P]`` at ``[..., B, D]``, base draws from
    ``generator``."""
    B, P = query_points.shape[-2], cache.alpha.shape[-1]
    cov_shape = query_points.shape[:-2] + (P, B, B)
    eps = _draw_joint_eps(generator, cov_shape, num_samples, query_points)
    return sample_joint_from_eps(params, cache, query_points, eps)


def covariance_between_points(
    params: GPRParams, cache: GPRCache, x1: torch.Tensor, x2: torch.Tensor
) -> torch.Tensor:
    """Posterior covariance between two point sets, ``K12 − K1n (Knn+σ²I)⁻¹ Kn2``:
    ``x1 [..., N1, D]``, ``x2 [N2, D]`` give ``[..., N1, N2]``."""
    flat1 = x1.reshape(-1, x1.shape[-1])
    flat2 = x2.reshape(-1, x2.shape[-1])
    v1 = solve_lower(cache.L, _masked_cross_cov(params, cache, flat1).T)  # [C, N1]
    v2 = solve_lower(cache.L, _masked_cross_cov(params, cache, flat2).T)  # [C, N2]
    cov = gram(params.kernel, flat1, flat2) - v1.T @ v2
    return cov.reshape(x1.shape[:-1] + x2.shape[:-2] + (x2.shape[-2],))


def cho_solve_batched(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``(LLᵀ)⁻¹ b`` for ``L [..., M, M]`` and ``b [..., M, K]``."""
    return cho_solve(L, b)


def _mean_and_whitened(
    params: GPRParams, cache: GPRCache, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The posterior mean ``[..., N, P]`` at ``x [..., N, D]`` and ``v = L⁻¹ K(X, x)``
    as ``[..., N, C]``, the factor of the posterior covariance ``K(a, b) − v_aᵀ v_b``."""
    flat = x.reshape(-1, x.shape[-1])
    Kxn = _masked_cross_cov(params, cache, flat)  # [N, C]
    mean = Kxn @ cache.alpha + params.mean_constant
    v = solve_lower(cache.L, Kxn.T).T
    return mean.reshape(x.shape[:-1] + (-1,)), v.reshape(x.shape[:-1] + (-1,))


def conditional_predict_joint(
    params: GPRParams,
    cache: GPRCache,
    query_points: torch.Tensor,
    extra_X: torch.Tensor,
    extra_Y: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint prediction conditioned on extra observations (fantasizing).

    ``extra_X [..., M, D]``, ``extra_Y [..., M, P]`` and ``query_points [B, D]`` or
    ``[..., B, D]`` give mean ``[..., B, P]`` and cov ``[..., P, B, B]``. The joint
    posterior over (extra ∪ query) is block-updated; the training system is not
    refactorized. Leading dims broadcast.
    """
    M = extra_X.shape[-2]
    lead = torch.broadcast_shapes(extra_X.shape[:-2], query_points.shape[:-2])
    z = torch.cat(
        [extra_X.expand(lead + extra_X.shape[-2:]),
         query_points.expand(lead + query_points.shape[-2:])], dim=-2,
    )  # [..., M+B, D]
    mean_z, cov_z = predict_joint(params, cache, z)  # [..., M+B, P], [..., P, M+B, M+B]
    mean_e, mean_q = mean_z[..., :M, :], mean_z[..., M:, :]
    cov_ee, cov_eq, cov_qq = cov_z[..., :M, :M], cov_z[..., :M, M:], cov_z[..., M:, M:]
    eye = torch.eye(M, dtype=cov_z.dtype, device=cov_z.device)
    Le = nan_cholesky(cov_ee + (params.noise_variance + jitter_for(cov_z.dtype)) * eye)
    resid = (extra_Y - mean_e).transpose(-1, -2)[..., None]  # [..., P, M, 1]
    cov_qe = cov_eq.transpose(-1, -2)
    shift = (cov_qe @ cho_solve_batched(Le, resid))[..., 0]  # [..., P, B]
    mean_new = mean_q + shift.transpose(-1, -2)
    cov_new = cov_qq - cov_qe @ cho_solve_batched(Le, cov_eq)
    return mean_new, cov_new


def conditional_predict_f(
    params: GPRParams,
    cache: GPRCache,
    query_points: torch.Tensor,
    extra_X: torch.Tensor,
    extra_Y: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Marginal version of :func:`conditional_predict_joint`: two ``[..., B, P]``.

    The ``[B, B]`` block is never formed, so memory is O(B·(C + M)): the exact marginal
    at the queries, their posterior covariance with the extra points ``[..., M, B]`` and
    one triangular solve against the Cholesky factor ``Le`` of the extra points' noisy
    covariance give ``mean + cov_qe Le⁻ᵀ Le⁻¹ r`` and ``var − |Le⁻¹ cov_eq|²``. Never
    fused: near an extra point the conditioned variance is below the fused kernel's
    absolute variance error."""
    M = extra_X.shape[-2]
    mean_q, vq = _mean_and_whitened(params, cache, query_points)  # [..., B, P], [..., B, C]
    var_q = params.kernel.variance - torch.sum(torch.square(vq), dim=-1)  # [..., B]
    mean_e, ve = _mean_and_whitened(params, cache, extra_X)  # [..., M, P], [..., M, C]
    cov_ee = gram(params.kernel, extra_X) - ve @ ve.transpose(-1, -2)
    cov_eq = gram(params.kernel, extra_X, query_points) - ve @ vq.transpose(-1, -2)
    del vq
    eye = torch.eye(M, dtype=cov_ee.dtype, device=cov_ee.device)
    Le = nan_cholesky(cov_ee + (params.noise_variance + jitter_for(cov_ee.dtype)) * eye)
    A = solve_lower(Le, cov_eq)  # [..., M, B]
    mean = mean_q + A.transpose(-1, -2) @ solve_lower(Le, extra_Y - mean_e)
    var = var_q - torch.sum(torch.square(A), dim=-2)
    return mean, var[..., None].expand(mean.shape)


def conditional_predict_y(
    params: GPRParams,
    cache: GPRCache,
    query_points: torch.Tensor,
    extra_X: torch.Tensor,
    extra_Y: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    mean, var = conditional_predict_f(params, cache, query_points, extra_X, extra_Y)
    return mean, var + params.noise_variance


def conditional_predict_f_sample_from_eps(
    params: GPRParams,
    cache: GPRCache,
    query_points: torch.Tensor,
    extra_X: torch.Tensor,
    extra_Y: torch.Tensor,
    eps: torch.Tensor,
) -> torch.Tensor:
    """Joint samples ``[..., S, B, P]`` from the conditioned posterior, from base draws
    ``eps [..., P, S, B]``."""
    mean, cov = conditional_predict_joint(params, cache, query_points, extra_X, extra_Y)
    return _joint_samples(mean, cov, eps)


def conditional_predict_f_sample(
    generator: Optional[torch.Generator],
    params: GPRParams,
    cache: GPRCache,
    query_points: torch.Tensor,
    extra_X: torch.Tensor,
    extra_Y: torch.Tensor,
    num_samples: int,
) -> torch.Tensor:
    """Joint samples from the conditioned posterior, base draws from ``generator``."""
    mean, cov = conditional_predict_joint(params, cache, query_points, extra_X, extra_Y)
    return _joint_samples(mean, cov, _draw_joint_eps(generator, cov.shape, num_samples, cov))

"""Sparse GP models (counterpart of :mod:`trieste_tpu.models.gp.sparse`): SGPR with
Titsias's collapsed bound and the whitened SVGP, as functions of padded, masked buffers.

* :class:`SparseGaussianProcessRegression`: the optimal ``q(u)`` is analytic, so the fit
  is multi-start L-BFGS over the hyperparameters (and, by default, the inducing points).
* :class:`SparseVariational`: an explicit whitened ``q(v) = N(q_mu, q_sqrt q_sqrtᵀ)``.
  With a Gaussian likelihood the optimal ``q`` given the hyperparameters is closed form,
  so :func:`fit_svgp` optimizes the hyperparameters through that map and sets ``q`` once;
  :func:`fit_svgp_minibatch` trains everything with Adam on minibatches instead.

Both cost O(n·M²) in the data size ``n``: neither reaches the fused prediction kernel,
which serves only the exact GP. The ELBOs, the caches and the SVGP predictions also take
hyperparameters with a leading batch axis (one per restart of a multi-start fit).
Every function that draws is split into the draw and a pure ``*_from_*`` half.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ...data import Dataset
from ...ops.kernels import Stationary, gram
from ...ops.linalg import cho_solve, nan_cholesky, solve_lower, solve_upper
from ...parallel import Mesh, current_pool_sharding, round_to_mesh
from ...utils.misc import flatten_leading_dims, generator_for, jitter_for
from ..interfaces import ReparametrizationSampler, TrajectorySampler
from .posterior import _draw_joint_eps, _joint_samples
from .priors import GPPriors, log_prior_density, sample_log_params, squeeze_kernel
from .training import MIN_VARIANCE, NOISE_FLOOR, minimize_restarts

RESTART_SHIFT = 1.5
"""Without priors, a restart shifts each log hyperparameter uniformly within ±1.5."""


def _eye(M: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(M, dtype=like.dtype, device=like.device)


def _per_matrix(t: torch.Tensor) -> torch.Tensor:
    """A scalar hyperparameter ``[...]`` broadcast against ``[..., rows, cols]``."""
    return t[..., None, None]


@dataclass(frozen=True)
class SGPRParams:
    """SGPR hyperparameters: kernel, noise, constant mean and inducing points ``[M, D]``."""

    kernel: Stationary
    noise_variance: torch.Tensor
    mean_constant: torch.Tensor
    inducing_points: torch.Tensor

    def replace(self, **changes) -> "SGPRParams":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class SGPRCache:
    """The factors of O(N·M) predictions: ``L = chol(Kuu)``, ``LB = chol(I + AAᵀ)`` and
    ``c = LB⁻¹ A (y − m) / σ``."""

    X: torch.Tensor
    mask: torch.Tensor
    L: torch.Tensor  # [M, M]
    LB: torch.Tensor  # [M, M]
    c: torch.Tensor  # [M, P]


def _sgpr_factors(params: SGPRParams, X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor):
    Z = params.inducing_points
    M = Z.shape[-2]
    m = mask.to(X.dtype)
    sigma = torch.sqrt(torch.clamp_min(params.noise_variance, NOISE_FLOOR))
    Kuu = gram(params.kernel, Z) + jitter_for(X.dtype) * _eye(M, X)
    Kuf = gram(params.kernel, Z, X) * m  # padded columns zeroed
    L = nan_cholesky(Kuu)
    A = solve_lower(L, Kuf) / _per_matrix(sigma)  # [..., M, C]
    AAT = A @ A.transpose(-1, -2)
    LB = nan_cholesky(AAT + _eye(M, X))
    ym = (Y - _per_matrix(params.mean_constant)) * m[:, None]  # [..., C, P]
    c = solve_lower(LB, A @ ym / _per_matrix(sigma))  # [..., M, P]
    return m, sigma, L, AAT, LB, ym, c


def sgpr_elbo(
    params: SGPRParams, X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Titsias's collapsed evidence lower bound over the valid rows, ``[...]``."""
    m, sigma, L, AAT, LB, ym, c = _sgpr_factors(params, X, Y, mask)
    n, P = torch.sum(m), Y.shape[-1]
    sigma2 = sigma**2
    bound = -0.5 * n * P * torch.log(2.0 * math.pi * sigma2)
    bound = bound - P * torch.sum(torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)), dim=-1)
    bound = bound - 0.5 * torch.sum(torch.square(ym), dim=(-2, -1)) / sigma2
    bound = bound + 0.5 * torch.sum(torch.square(c), dim=(-2, -1))
    kdiag_sum = torch.sum(params.kernel.variance[..., None] * m, dim=-1)
    trace = torch.diagonal(AAT, dim1=-2, dim2=-1).sum(-1)
    return bound - 0.5 * P * (kdiag_sum / sigma2 - trace)


def sgpr_build_cache(
    params: SGPRParams, X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor
) -> SGPRCache:
    _, _, L, _, LB, _, c = _sgpr_factors(params, X, Y, mask)
    return SGPRCache(X=X, mask=mask, L=L, LB=LB, c=c)


def _sgpr_whitened(params: SGPRParams, cache: SGPRCache, x: torch.Tensor):
    """``L⁻¹ Kux`` and ``LB⁻¹ L⁻¹ Kux`` for ``x [..., N, D]``, each ``[..., M, N]``."""
    tmp1 = solve_lower(cache.L, gram(params.kernel, params.inducing_points, x))
    return tmp1, solve_lower(cache.LB, tmp1)


def sgpr_predict_f(
    params: SGPRParams, cache: SGPRCache, query_points: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Marginal posterior: ``[..., D] -> mean [..., P], var [..., P]``."""
    flat, unflatten = flatten_leading_dims(query_points, output_dims=2)
    tmp1, tmp2 = _sgpr_whitened(params, cache, flat)
    mean = tmp2.T @ cache.c + params.mean_constant  # [N, P]
    var = (
        params.kernel.diag(flat)
        - torch.sum(torch.square(tmp1), dim=0)
        + torch.sum(torch.square(tmp2), dim=0)
    )
    var = torch.clamp_min(var, 1e-24)[:, None].expand(mean.shape)
    return unflatten(mean), unflatten(var)


def sgpr_predict_joint(
    params: SGPRParams, cache: SGPRCache, query_points: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint posterior over a batch: ``[..., B, D] -> mean [..., B, P], cov [..., P, B, B]``,
    all leading dims at once."""
    lead, (B, D) = query_points.shape[:-2], query_points.shape[-2:]
    flat = query_points.reshape(-1, B, D)
    tmp1, tmp2 = _sgpr_whitened(params, cache, flat)  # [F, M, B]
    mean = tmp2.transpose(-1, -2) @ cache.c + params.mean_constant  # [F, B, P]
    cov = (
        gram(params.kernel, flat)
        - tmp1.transpose(-1, -2) @ tmp1
        + tmp2.transpose(-1, -2) @ tmp2
    )
    P = mean.shape[-1]
    return mean.reshape(lead + (B, P)), cov.reshape(lead + (1, B, B)).expand(lead + (P, B, B))


# -- SGPR training ---------------------------------------------------------------------


def _log_hyper(kernel: Stationary, mean_constant: torch.Tensor, noise, train_noise: bool):
    parts = [
        torch.log(torch.clamp_min(torch.atleast_1d(kernel.variance), MIN_VARIANCE)),
        torch.log(torch.clamp_min(kernel.lengthscales, MIN_VARIANCE)),
        torch.atleast_1d(mean_constant),
    ]
    if train_noise:
        parts.append(torch.log(torch.clamp_min(torch.atleast_1d(noise) - NOISE_FLOOR, MIN_VARIANCE)))
    return parts


def _unpack_hyper(u: torch.Tensor, template, train_noise: bool) -> dict:
    """The kernel, noise and mean of ``u [..., n]`` (the layout of :func:`_log_hyper`)."""
    n_ls = template.kernel.lengthscales.shape[-1]
    noise = NOISE_FLOOR + torch.exp(u[..., 2 + n_ls]) if train_noise else template.noise_variance
    return dict(
        kernel=template.kernel.replace(
            variance=torch.exp(u[..., 0]), lengthscales=torch.exp(u[..., 1 : 1 + n_ls])
        ),
        noise_variance=noise,
        mean_constant=u[..., 1 + n_ls],
    )


def sgpr_pack(params: SGPRParams, train_noise: bool, train_inducing: bool) -> torch.Tensor:
    """``[log σ², log ℓ..., m, (log(noise − floor)), (Z flattened)]``."""
    parts = _log_hyper(params.kernel, params.mean_constant, params.noise_variance, train_noise)
    if train_inducing:
        parts.append(params.inducing_points.reshape(-1))
    return torch.cat(parts)


def sgpr_unpack(
    u: torch.Tensor, template: SGPRParams, train_noise: bool, train_inducing: bool
) -> SGPRParams:
    """Inverse of :func:`sgpr_pack`, batched over the leading dims of ``u``."""
    hyper = _unpack_hyper(u, template, train_noise)
    Z = template.inducing_points
    if train_inducing:
        start = 2 + template.kernel.lengthscales.shape[-1] + int(train_noise)
        Z = u[..., start:].reshape(u.shape[:-1] + Z.shape)
    return SGPRParams(inducing_points=Z, **hyper)


def _random_starts(
    generator: Optional[torch.Generator],
    u0: torch.Tensor,
    n_ls: int,
    n_shift: int,
    num_starts: int,
    priors: Optional[GPPriors],
) -> torch.Tensor:
    """``[R, n]``: ``u0`` and ``R − 1`` restarts. With priors the kernel entries come from
    the priors; without, the first ``n_shift`` entries but the mean are shifted
    uniformly within ±:data:`RESTART_SHIFT`."""
    rest = u0.expand(num_starts - 1, u0.shape[0]).clone()
    if priors is not None:
        log_var, log_ls = sample_log_params(generator, priors, num_starts - 1, n_ls)
        rest[:, 0] = log_var
        rest[:, 1 : 1 + n_ls] = log_ls
    else:
        generator = generator_for(generator, u0.device)
        u = torch.rand(rest.shape, generator=generator, dtype=u0.dtype, device=u0.device)
        shifts = (2.0 * u - 1.0) * RESTART_SHIFT
        shifts[:, n_shift:] = 0.0
        shifts[:, 1 + n_ls] = 0.0  # the mean constant
        rest = rest + shifts
    return torch.cat([u0[None], rest])


class SGPRTrainingResult(NamedTuple):
    params: SGPRParams
    loss: torch.Tensor
    all_losses: torch.Tensor


def sgpr_starts(
    generator: Optional[torch.Generator],
    params: SGPRParams,
    num_starts: int,
    train_noise: bool = True,
    train_inducing: bool = True,
    priors: Optional[GPPriors] = None,
) -> torch.Tensor:
    """The ``[R, n]`` starting vectors of :func:`fit_sgpr`."""
    n_ls = params.kernel.lengthscales.shape[-1]
    u0 = sgpr_pack(params, train_noise, train_inducing)
    return _random_starts(generator, u0, n_ls, 2 + n_ls + int(train_noise), num_starts, priors)


def fit_sgpr_from_starts(
    starts: torch.Tensor,
    params: SGPRParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    mask: torch.Tensor,
    *,
    train_noise: bool = True,
    train_inducing: bool = True,
    max_iters: int = 100,
    priors: Optional[GPPriors] = None,
    pool_sharding: Optional[Mesh] = None,
) -> SGPRTrainingResult:
    """Lockstep L-BFGS from every row of ``starts`` on the negative collapsed bound (the
    negative log posterior with ``priors``); the best final loss wins. ``pool_sharding``
    shards the rows over its mesh (:func:`~.training.minimize_restarts`)."""

    def loss_fn(u: torch.Tensor) -> torch.Tensor:
        p = sgpr_unpack(u, params, train_noise, train_inducing)
        return -sgpr_elbo(p, X, Y, mask) - log_prior_density(p.kernel, priors)

    best_x, best_loss, losses = minimize_restarts(
        loss_fn, starts, max_iters=max_iters, pool_sharding=pool_sharding
    )
    best_params = sgpr_unpack(best_x, params, train_noise, train_inducing)
    best_params = best_params.replace(kernel=squeeze_kernel(best_params.kernel, priors))
    return SGPRTrainingResult(params=best_params, loss=best_loss, all_losses=losses)


def fit_sgpr(
    generator: Optional[torch.Generator],
    params: SGPRParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    mask: torch.Tensor,
    *,
    num_starts: int = 5,
    train_noise: bool = True,
    train_inducing: bool = True,
    max_iters: int = 100,
    priors: Optional[GPPriors] = None,
    pool_sharding: Optional[Mesh] = None,
) -> SGPRTrainingResult:
    """Multi-start MAP (maximum-bound without priors) fit of an SGPR, restarts drawn from
    ``generator``; ``pool_sharding`` shards them over its mesh."""
    starts = sgpr_starts(generator, params, num_starts, train_noise, train_inducing, priors)
    return fit_sgpr_from_starts(
        starts, params, X, Y, mask, train_noise=train_noise, train_inducing=train_inducing,
        max_iters=max_iters, priors=priors, pool_sharding=pool_sharding,
    )


def _joint_sample(
    generator: Optional[torch.Generator],
    predict_joint: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    query_points: torch.Tensor,
    num_samples: int,
) -> torch.Tensor:
    """Joint samples ``[..., S, B, P]`` of a model's ``predict_joint`` at ``[..., B, D]``,
    factorized in the model's dtype."""
    mean, cov = predict_joint(query_points)
    eps = _draw_joint_eps(generator, cov.shape, num_samples, cov)
    return _joint_samples(mean, cov, eps)


class _SparseModel:
    """What the two sparse models share: the data, the selector and the accessors."""

    _params: object
    _dataset: Dataset

    @property
    def params(self):
        return self._params

    def get_kernel(self) -> Stationary:
        return self._params.kernel

    def get_observation_noise(self) -> torch.Tensor:
        return self._params.noise_variance

    def get_internal_data(self) -> Dataset:
        return self._dataset

    def predict_y(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, var = self.predict(query_points)
        return mean, var + self._params.noise_variance

    def sample(
        self, generator: Optional[torch.Generator], query_points: torch.Tensor, num_samples: int
    ) -> torch.Tensor:
        """Joint posterior samples ``[..., S, B, P]`` at ``[..., B, D]``."""
        return _joint_sample(generator, self.predict_joint, query_points, num_samples)

    def _select_inducing_points(self, dataset: Dataset) -> None:
        """Set the data and, with a selector, place the inducing points for it (the
        selector sees the model as it was before this update)."""
        self._dataset = dataset
        if self._selector is not None:
            Z = self._selector.calculate_inducing_points(
                self._params.inducing_points, self, dataset
            )
            self._params = self._params.replace(inducing_points=Z)

    def trajectory_sampler(self) -> TrajectorySampler:
        from .sampler import DecoupledInducingTrajectorySampler

        return DecoupledInducingTrajectorySampler(self)

    def reparam_sampler(self, num_samples: int) -> ReparametrizationSampler:
        from .sampler import BatchReparametrizationSampler

        return BatchReparametrizationSampler(num_samples, self)

    def log(self, dataset: Optional[Dataset] = None) -> None:
        """Nothing is logged, as in the JAX package."""


class SparseGaussianProcessRegression(_SparseModel):
    """SGPR: ``TrainableProbabilisticModel``, ``SupportsPredictJoint``, ``SupportsPredictY``,
    ``SupportsGetKernel`` / ``ObservationNoise`` / ``InternalData``,
    ``SupportsGetInducingVariables``, ``HasTrajectorySampler`` and ``HasReparamSampler``."""

    def __init__(
        self,
        params: SGPRParams,
        dataset: Dataset,
        *,
        inducing_point_selector: Optional[object] = None,
        num_starts: int = 5,
        train_noise: bool = True,
        train_inducing: bool = True,
        max_optimize_iters: int = 100,
        optimize_generator: Optional[torch.Generator] = None,
        priors: Optional[GPPriors] = None,
    ):
        self._params = params
        self._dataset = dataset
        self._selector = inducing_point_selector
        self._num_starts = num_starts
        self._train_noise = train_noise
        self._train_inducing = train_inducing
        self._max_iters = max_optimize_iters
        self._priors = priors
        if optimize_generator is None:
            optimize_generator = torch.Generator(device=dataset.device).manual_seed(0)
        self._generator = optimize_generator
        self._refresh()

    def _refresh(self) -> None:
        ds = self._dataset
        self._cache = sgpr_build_cache(self._params, ds.query_points, ds.observations, ds.mask)

    @property
    def posterior_cache(self) -> SGPRCache:
        return self._cache

    def get_inducing_variables(
        self,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, bool]:
        """``(Z, q_mu, q_sqrt [1, M, M], whiten=False)`` of the optimal ``q(u)``:
        mean ``L LB⁻ᵀ c``, covariance ``L B⁻¹ Lᵀ``."""
        L, LB = self._cache.L, self._cache.LB
        q_mu = L @ solve_upper(LB, self._cache.c)
        q_cov = L @ cho_solve(LB, _eye(LB.shape[0], LB)) @ L.T
        q_sqrt = nan_cholesky(q_cov + jitter_for(q_cov.dtype) * _eye(q_cov.shape[0], q_cov))
        return self._params.inducing_points, q_mu, q_sqrt[None], False

    def predict(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return sgpr_predict_f(self._params, self._cache, query_points)

    def predict_joint(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return sgpr_predict_joint(self._params, self._cache, query_points)

    def update(self, dataset: Dataset) -> None:
        self._select_inducing_points(dataset)
        self._refresh()

    def optimize(self, dataset: Dataset) -> SGPRTrainingResult:
        result = fit_sgpr(  # under a global mesh the restarts are rounded and sharded
            self._generator, self._params, dataset.query_points, dataset.observations,
            dataset.mask, num_starts=round_to_mesh(self._num_starts),
            train_noise=self._train_noise, train_inducing=self._train_inducing,
            max_iters=self._max_iters, priors=self._priors,
            pool_sharding=current_pool_sharding(),
        )
        self._params = result.params
        self._dataset = dataset
        self._refresh()
        return result

    def __repr__(self) -> str:
        return (
            f"SparseGaussianProcessRegression(M={self._params.inducing_points.shape[0]}, "
            f"n={len(self._dataset)})"
        )


# ---------------------------------------------------------------------------------------
# SVGP
# ---------------------------------------------------------------------------------------


@dataclass(frozen=True)
class SVGPParams:
    """Whitened SVGP parameters: the hyperparameters, the inducing points ``[M, D]`` and
    ``q(v)``: ``q_mu [M, P]``, lower-triangular ``q_sqrt [P, M, M]``."""

    kernel: Stationary
    noise_variance: torch.Tensor
    mean_constant: torch.Tensor
    inducing_points: torch.Tensor
    q_mu: torch.Tensor
    q_sqrt: torch.Tensor

    def replace(self, **changes) -> "SVGPParams":
        return dataclasses.replace(self, **changes)


def _whitened_cross(params: SVGPParams, x: torch.Tensor) -> torch.Tensor:
    """``A = L⁻¹ Kux`` with ``L = chol(Kuu + jitter)``, ``[..., M, N]`` for ``x [N, D]``
    (or ``[F, N, D]``)."""
    Z = params.inducing_points
    L = nan_cholesky(gram(params.kernel, Z) + jitter_for(x.dtype) * _eye(Z.shape[-2], x))
    if x.ndim == 3:  # a batch of joint queries: one L for all
        L = L[..., None, :, :]
    return solve_lower(L, gram(params.kernel, Z, x))


def svgp_predict_f(
    params: SVGPParams, query_points: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mean = Aᵀ q_mu + m``, ``var = k(x, x) − ‖A‖² + ‖q_sqrtᵀ A‖²`` per output, with
    ``A = L⁻¹ Kux``: ``[..., D] -> [..., P]`` twice."""
    flat, unflatten = flatten_leading_dims(query_points, output_dims=2)
    A = _whitened_cross(params, flat)  # [..., M, N]
    mean = A.transpose(-1, -2) @ params.q_mu + _per_matrix(params.mean_constant)  # [..., N, P]
    SA = torch.einsum("...pmk,...mn->...pkn", params.q_sqrt, A)
    var = (
        params.kernel.variance[..., None, None]
        - torch.sum(torch.square(A), dim=-2)[..., None, :]
        + torch.sum(torch.square(SA), dim=-2)
    )  # [..., P, N]
    var = torch.clamp_min(var.transpose(-1, -2), 1e-24)
    if mean.ndim == 2:
        return unflatten(mean), unflatten(var)
    return mean, var  # batched hyperparameters over flat queries


def svgp_predict_joint(
    params: SVGPParams, query_points: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint posterior over a batch: ``[..., B, D] -> mean [..., B, P], cov [..., P, B, B]``."""
    lead, (B, D) = query_points.shape[:-2], query_points.shape[-2:]
    flat = query_points.reshape(-1, B, D)
    A = _whitened_cross(params, flat)  # [F, M, B]
    mean = A.transpose(-1, -2) @ params.q_mu + params.mean_constant  # [F, B, P]
    SA = torch.einsum("pmk,fmn->fpkn", params.q_sqrt, A)
    cov = (
        (gram(params.kernel, flat) - A.transpose(-1, -2) @ A)[:, None]
        + SA.transpose(-1, -2) @ SA
    )  # [F, P, B, B]
    P = mean.shape[-1]
    return mean.reshape(lead + (B, P)), cov.reshape(lead + (P, B, B))


def _svgp_kl(q_mu: torch.Tensor, q_sqrt: torch.Tensor) -> torch.Tensor:
    """``KL[q(v) || N(0, I)]`` summed over the outputs, ``[...]``."""
    P, M = q_sqrt.shape[-3], q_sqrt.shape[-2]
    diag = torch.diagonal(q_sqrt, dim1=-2, dim2=-1)
    return 0.5 * (
        torch.sum(torch.square(q_mu), dim=(-2, -1))
        + torch.sum(torch.square(q_sqrt), dim=(-3, -2, -1))
        - M * P
        - 2.0 * torch.sum(torch.log(torch.clamp_min(torch.abs(diag), 1e-24)), dim=(-2, -1))
    )


def _gaussian_log_lik(Y, mean, var, noise_variance) -> torch.Tensor:
    sigma2 = _per_matrix(torch.clamp_min(noise_variance, NOISE_FLOOR))
    return -0.5 * torch.log(2.0 * math.pi * sigma2) - 0.5 * (torch.square(Y - mean) + var) / sigma2


def svgp_elbo(
    params: SVGPParams, X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """The full-batch ELBO with a Gaussian likelihood over the valid rows, ``[...]``."""
    m = mask.to(X.dtype)
    mean, var = svgp_predict_f(params, X)
    lik = _gaussian_log_lik(Y, mean, var, params.noise_variance)
    return torch.sum(lik * m[:, None], dim=(-2, -1)) - _svgp_kl(params.q_mu, params.q_sqrt)


def svgp_optimal_variational(
    params: SVGPParams, X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor
) -> SVGPParams:
    """The optimal whitened ``q(v)`` given the hyperparameters: covariance
    ``(I + AAᵀ/σ²)⁻¹`` and mean that times ``A (y − m) / σ²``."""
    Z = params.inducing_points
    M = Z.shape[-2]
    m = mask.to(X.dtype)
    sigma2 = _per_matrix(torch.clamp_min(params.noise_variance, NOISE_FLOOR))
    L = nan_cholesky(gram(params.kernel, Z) + jitter_for(X.dtype) * _eye(M, X))
    A = solve_lower(L, gram(params.kernel, Z, X) * m)  # [..., M, C]
    LBm = nan_cholesky(_eye(M, X) + A @ A.transpose(-1, -2) / sigma2)
    ym = (Y - _per_matrix(params.mean_constant)) * m[:, None]
    q_mu = cho_solve(LBm, A @ ym / sigma2)  # [..., M, P]
    Binv = cho_solve(LBm, _eye(M, X).expand(LBm.shape))
    q_cov_sqrt = nan_cholesky(Binv + jitter_for(X.dtype) * _eye(M, X))
    P = Y.shape[-1]
    q_sqrt = q_cov_sqrt[..., None, :, :].expand(q_cov_sqrt.shape[:-2] + (P, M, M))
    return params.replace(q_mu=q_mu, q_sqrt=q_sqrt)


class SVGPTrainingResult(NamedTuple):
    params: SVGPParams
    loss: torch.Tensor


def svgp_starts(
    generator: Optional[torch.Generator],
    params: SVGPParams,
    num_starts: int,
    train_noise: bool = True,
    priors: Optional[GPPriors] = None,
) -> torch.Tensor:
    """The ``[R, n]`` starting vectors of :func:`fit_svgp`."""
    n_ls = params.kernel.lengthscales.shape[-1]
    u0 = torch.cat(_log_hyper(params.kernel, params.mean_constant, params.noise_variance, train_noise))
    return _random_starts(generator, u0, n_ls, u0.shape[0], num_starts, priors)


def fit_svgp_from_starts(
    starts: torch.Tensor,
    params: SVGPParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    mask: torch.Tensor,
    *,
    train_noise: bool = True,
    max_iters: int = 100,
    priors: Optional[GPPriors] = None,
    pool_sharding: Optional[Mesh] = None,
) -> SVGPTrainingResult:
    """Lockstep L-BFGS over the hyperparameters from every row of ``starts``, each loss
    the negative ELBO at the optimal ``q`` for those hyperparameters (with a Gaussian
    likelihood, the collapsed bound); then ``q`` is set once for the winner.
    ``pool_sharding`` shards the rows over its mesh."""

    def loss_fn(u: torch.Tensor) -> torch.Tensor:
        p = params.replace(**_unpack_hyper(u, params, train_noise))
        p = svgp_optimal_variational(p, X, Y, mask)
        return -svgp_elbo(p, X, Y, mask) - log_prior_density(p.kernel, priors)

    best_x, _, _ = minimize_restarts(loss_fn, starts, max_iters=max_iters,
                                     pool_sharding=pool_sharding)
    p = params.replace(**_unpack_hyper(best_x, params, train_noise))
    p = svgp_optimal_variational(p.replace(kernel=squeeze_kernel(p.kernel, priors)), X, Y, mask)
    return SVGPTrainingResult(params=p, loss=-svgp_elbo(p, X, Y, mask))


def fit_svgp(
    generator: Optional[torch.Generator],
    params: SVGPParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    mask: torch.Tensor,
    *,
    train_noise: bool = True,
    max_iters: int = 100,
    num_starts: int = 5,
    priors: Optional[GPPriors] = None,
    pool_sharding: Optional[Mesh] = None,
) -> SVGPTrainingResult:
    """Multi-start fit of the hyperparameters through the optimal-``q`` map, restarts
    drawn from ``generator``; ``pool_sharding`` shards them over its mesh."""
    starts = svgp_starts(generator, params, num_starts, train_noise, priors)
    return fit_svgp_from_starts(
        starts, params, X, Y, mask, train_noise=train_noise, max_iters=max_iters, priors=priors,
        pool_sharding=pool_sharding,
    )


def minibatch_indices(
    generator: Optional[torch.Generator], mask: torch.Tensor, batch_size: int, num_steps: int
) -> torch.Tensor:
    """``[num_steps, batch_size]`` row indices drawn with replacement from the valid rows
    (front-packed, as a dataset keeps them)."""
    n = max(int(mask.sum()), 1)
    generator = generator_for(generator, mask.device)
    return torch.randint(0, n, (num_steps, batch_size), generator=generator, device=mask.device)


def fit_svgp_minibatch_from_indices(
    indices: torch.Tensor,
    params: SVGPParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    mask: torch.Tensor,
    *,
    learning_rate: float = 0.05,
    train_noise: bool = True,
    priors: Optional[GPPriors] = None,
) -> SVGPTrainingResult:
    """Adam on every SVGP parameter at once (the hyperparameters in log space, ``q_sqrt``
    through its lower triangle), one step per row of ``indices [steps, batch]``, each on
    the minibatch's ELBO with the likelihood scaled by ``n / batch``. PyTorch's Adam
    takes optax's step (``eps`` outside the square root)."""
    batch_size = indices.shape[1]
    n = max(int(mask.sum()), 1)
    ls_shape = params.kernel.lengthscales.shape
    leaves = {
        "log_kvar": torch.log(torch.clamp_min(params.kernel.variance, MIN_VARIANCE)),
        "log_ls": torch.log(torch.clamp_min(params.kernel.lengthscales, MIN_VARIANCE)),
        "mean_constant": params.mean_constant,
        "inducing_points": params.inducing_points,
        "q_mu": params.q_mu,
        "q_sqrt_raw": params.q_sqrt,
    }
    if train_noise:
        leaves["log_noise"] = torch.log(
            torch.clamp_min(params.noise_variance - NOISE_FLOOR, MIN_VARIANCE)
        )
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in leaves.items()}

    def to_params() -> SVGPParams:
        noise = NOISE_FLOOR + torch.exp(leaves["log_noise"]) if train_noise else params.noise_variance
        return params.replace(
            kernel=params.kernel.replace(
                variance=torch.exp(leaves["log_kvar"]),
                lengthscales=torch.exp(leaves["log_ls"]).reshape(ls_shape),
            ),
            noise_variance=noise,
            mean_constant=leaves["mean_constant"],
            inducing_points=leaves["inducing_points"],
            q_mu=leaves["q_mu"],
            q_sqrt=torch.tril(leaves["q_sqrt_raw"]),
        )

    opt = torch.optim.Adam(list(leaves.values()), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    for idx in indices:
        p = to_params()
        mean, var = svgp_predict_f(p, X[idx])
        lik = _gaussian_log_lik(Y[idx], mean, var, p.noise_variance)
        loss = _svgp_kl(p.q_mu, p.q_sqrt) - torch.sum(lik) * (n / batch_size)
        loss = loss - log_prior_density(p.kernel, priors)
        opt.zero_grad()
        loss.backward()
        opt.step()
    with torch.no_grad():
        leaves = {k: v.detach() for k, v in leaves.items()}
        p = to_params()
        return SVGPTrainingResult(params=p, loss=-svgp_elbo(p, X, Y, mask))


def fit_svgp_minibatch(
    generator: Optional[torch.Generator],
    params: SVGPParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    mask: torch.Tensor,
    *,
    batch_size: int = 100,
    max_iters: int = 500,
    learning_rate: float = 0.05,
    train_noise: bool = True,
    priors: Optional[GPPriors] = None,
) -> SVGPTrainingResult:
    """:func:`fit_svgp_minibatch_from_indices` on minibatches drawn from ``generator``."""
    indices = minibatch_indices(generator, mask, batch_size, max_iters)
    return fit_svgp_minibatch_from_indices(
        indices, params, X, Y, mask, learning_rate=learning_rate, train_noise=train_noise,
        priors=priors,
    )


class SparseVariational(_SparseModel):
    """SVGP with the capabilities of :class:`SparseGaussianProcessRegression`.

    ``minibatch_size`` switches :meth:`optimize` from the multi-start L-BFGS of
    :func:`fit_svgp` to Adam on minibatches (:func:`fit_svgp_minibatch`), for large data.
    The L-BFGS restarts come from a generator seeded 0 anew on every fit, as the JAX
    package draws them from ``PRNGKey(0)`` each time."""

    def __init__(
        self,
        params: SVGPParams,
        dataset: Dataset,
        *,
        inducing_point_selector: Optional[object] = None,
        train_noise: bool = True,
        max_optimize_iters: int = 100,
        optimize_generator: Optional[torch.Generator] = None,
        priors: Optional[GPPriors] = None,
        minibatch_size: Optional[int] = None,
        minibatch_iters: int = 500,
        learning_rate: float = 0.05,
    ):
        self._params = params
        self._dataset = dataset
        self._selector = inducing_point_selector
        self._train_noise = train_noise
        self._max_iters = max_optimize_iters
        self._priors = priors
        self._minibatch_size = minibatch_size
        self._minibatch_iters = minibatch_iters
        self._learning_rate = learning_rate
        if optimize_generator is None:
            optimize_generator = torch.Generator(device=dataset.device).manual_seed(0)
        self._generator = optimize_generator

    def get_inducing_variables(
        self,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, bool]:
        """``(Z, q_mu, q_sqrt, whiten=True)``."""
        p = self._params
        return p.inducing_points, p.q_mu, p.q_sqrt, True

    def predict(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return svgp_predict_f(self._params, query_points)

    def predict_joint(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return svgp_predict_joint(self._params, query_points)

    def update(self, dataset: Dataset) -> None:
        self._select_inducing_points(dataset)

    def optimize(self, dataset: Dataset) -> SVGPTrainingResult:
        X, Y, mask = dataset.query_points, dataset.observations, dataset.mask
        if self._minibatch_size is not None:
            result = fit_svgp_minibatch(
                self._generator, self._params, X, Y, mask, batch_size=self._minibatch_size,
                max_iters=self._minibatch_iters, learning_rate=self._learning_rate,
                train_noise=self._train_noise, priors=self._priors,
            )
        else:
            restarts = torch.Generator(device=dataset.device).manual_seed(0)
            result = fit_svgp(  # under a global mesh 5 restarts are rounded and sharded
                restarts, self._params, X, Y, mask, train_noise=self._train_noise,
                max_iters=self._max_iters, num_starts=round_to_mesh(5), priors=self._priors,
                pool_sharding=current_pool_sharding(),
            )
        self._params = result.params
        self._dataset = dataset
        return result

    def __repr__(self) -> str:
        return f"SparseVariational(M={self._params.inducing_points.shape[0]})"

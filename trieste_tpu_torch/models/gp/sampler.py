"""Posterior samplers for exact GPs (counterpart of :mod:`trieste_tpu.models.gp.sampler`).

* :class:`IndependentReparametrizationSampler` and :class:`BatchReparametrizationSampler`:
  reparametrization-trick samplers whose base normal draws are frozen at first use, so an
  acquisition surface stays one deterministic function over an optimizer's evaluations.
  Under a global mesh a single batch (``at [B, D]``) shards the sample axis: each rank
  computes its block of the samples and the blocks are gathered.
* :class:`RandomFourierFeatureTrajectorySampler` and :class:`DecoupledTrajectorySampler`:
  function-draw ("trajectory") samplers. The decoupled sampler implements Matheron's rule:
  a random-Fourier prior draw updated pathwise through the cached training Cholesky.
* :class:`DecoupledInducingTrajectorySampler`: Matheron's rule through the inducing
  variables of a sparse model (SGPR or SVGP).

Trajectories carry one independent draw per batch column ``b`` of their ``[N, B, D]``
input. Every function that draws is split in two: a small one that takes the base
variables from a ``torch.Generator`` on the data's device, and a pure function of those
variables (``*_from_draws``, the dataclasses), which a caller can feed its own draws.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ...ops.kernels import MATERN12, MATERN32, MATERN52, RBF, Stationary, gram
from ...ops.linalg import cho_solve, masked_cholesky, nan_cholesky
from ...parallel import Mesh, gather_rows, local_slice, replicated_inputs, sharding_mesh
from ...utils.misc import generator_for, jitter_for, standard_normal
from ..interfaces import (
    ReparametrizationSampler,
    TrajectoryFunction,
    TrajectoryFunctionClass,
    TrajectorySampler,
)
from .posterior import GPRCache, GPRParams

_MATERN_DF = {MATERN12: 1, MATERN32: 3, MATERN52: 5}


def batch_reparam_sample(
    mean: torch.Tensor, cov: torch.Tensor, eps: torch.Tensor, jitter: Optional[float] = None
) -> torch.Tensor:
    """``mean [..., B, L] + chol(cov [..., L, B, B] + jitter I) eps [L, B, S]`` as
    ``[..., S, B, L]``. A covariance that is not positive definite gives NaNs."""
    jitter = jitter_for(cov.dtype) if jitter is None else jitter
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    draws = nan_cholesky(cov + jitter * eye) @ eps  # [..., L, B, S]
    return mean[..., None, :, :] + draws.permute(*range(draws.ndim - 3), -1, -2, -3)


def _padded_block(eps: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the frozen draws' sample axis ``axis``, zero-padded to a
    multiple of the mesh size (the padded samples are cut after the gather)."""
    S = eps.shape[axis]
    padded = -(-S // mesh.size) * mesh.size
    pad = [0, 0] * (eps.ndim - 1 - axis) + [0, padded - S]
    return torch.nn.functional.pad(eps, pad).narrow(axis, local_slice(padded, mesh).start,
                                                    padded // mesh.size)


class IndependentReparametrizationSampler(ReparametrizationSampler):
    """Marginal reparametrization sampler: ``f = mean + sqrt(var) * eps`` with frozen
    ``eps [S, 1, L]``."""

    def sample(
        self, at: torch.Tensor, *, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        mean, var = self._model.predict(at[..., None, :, :])  # [..., 1, B, L]
        if self._eps is None:
            self._eps = standard_normal(generator, (self._sample_size, 1, mean.shape[-1]), mean)
        mesh = sharding_mesh() if at.ndim == 2 else None
        if mesh is None:
            return mean + torch.sqrt(var) * self._eps  # [..., S, B, L]
        eps = _padded_block(self._eps, 0, mesh)  # a single batch: shard the sample axis
        mean, var = replicated_inputs(mesh, mean, var)
        return gather_rows(mean + torch.sqrt(var) * eps, mesh)[: self._sample_size]


class BatchReparametrizationSampler(ReparametrizationSampler):
    """Joint-over-batch reparametrization sampler: ``f = mean + L_cov eps`` with frozen
    ``eps [L, B, S]``. ``jitter`` defaults to the dtype's Cholesky jitter."""

    def sample(
        self,
        at: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        jitter: Optional[float] = None,
    ) -> torch.Tensor:
        batch_size = at.shape[-2]
        mean, cov = self._model.predict_joint(at)  # [..., B, L], [..., L, B, B]
        if self._eps is not None and self._eps.shape[-2] != batch_size:
            raise ValueError(
                f"this sampler is initialized for batches of size {self._eps.shape[-2]}, "
                f"got {batch_size}"
            )
        if self._eps is None:
            self._eps = standard_normal(
                generator, (mean.shape[-1], batch_size, self._sample_size), mean
            )
        mesh = sharding_mesh() if at.ndim == 2 else None
        if mesh is None:
            return batch_reparam_sample(mean, cov, self._eps, jitter)
        eps = _padded_block(self._eps, 2, mesh)  # a single batch: shard the sample axis
        mean, cov = replicated_inputs(mesh, mean, cov)
        return gather_rows(batch_reparam_sample(mean, cov, eps, jitter), mesh)[: self._sample_size]


def spectral_frequencies_from_draws(
    kernel: Stationary, z: torch.Tensor, chi2: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``[m, D]`` frequencies of the kernel's spectral density from ``z [m, D]`` standard
    normals: Gaussian for RBF; for Matérn-ν a multivariate t with ``2ν`` degrees of
    freedom, ``z * sqrt(df / chi2)`` with ``chi2 [m, 1]`` chi-square variates."""
    w = z if kernel.kind == RBF else z * torch.sqrt(_MATERN_DF[kernel.kind] / chi2)
    return w / kernel.lengthscales


def sample_spectral_frequencies(
    generator: Optional[torch.Generator], kernel: Stationary, num_features: int, dimension: int
) -> torch.Tensor:
    """Sample ``[m, D]`` frequencies from the kernel's spectral density. The chi-square
    variate of the Matérn kernels is drawn as a sum of ``df`` (1, 3 or 5) squared standard
    normals, which needs nothing beyond ``torch.randn`` with a generator."""
    ls = kernel.lengthscales
    generator = generator_for(generator, ls.device)
    z = standard_normal(generator, (num_features, dimension), ls)
    chi2 = None
    if kernel.kind != RBF:
        normals = standard_normal(generator, (num_features, _MATERN_DF[kernel.kind]), ls)
        chi2 = torch.sum(torch.square(normals), dim=-1, keepdim=True)
    return spectral_frequencies_from_draws(kernel, z, chi2)


@dataclass(frozen=True)
class FourierFeatures:
    """Random Fourier feature map ``phi(x) = sqrt(2 sigma^2 / m) cos(x W^T + b)``."""

    W: torch.Tensor  # [m, D]
    b: torch.Tensor  # [m]
    variance: torch.Tensor  # kernel signal variance (scalar)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        m = self.W.shape[0]
        return torch.sqrt(2.0 * self.variance / m) * torch.cos(x @ self.W.T + self.b)


def make_fourier_features(
    generator: Optional[torch.Generator], kernel: Stationary, num_features: int, dimension: int
) -> FourierFeatures:
    generator = generator_for(generator, kernel.lengthscales.device)
    W = sample_spectral_frequencies(generator, kernel, num_features, dimension)
    b = 2.0 * math.pi * torch.rand(
        (num_features,), generator=generator, dtype=W.dtype, device=W.device
    )
    return FourierFeatures(W=W, b=b, variance=kernel.variance)


@dataclass(frozen=True)
class DecoupledTrajectory(TrajectoryFunctionClass):
    """A Matheron-rule posterior function draw, one independent draw per batch column.

    ``f_b(x) = mean + phi(x) w_b + k(x, X) v_b`` where ``w_b ~ N(0, I_m)`` and
    ``v_b = (K + sigma^2 I)^{-1} (y - phi(X) w_b - eps_b)``, ``eps_b ~ N(0, sigma^2 I)``.
    """

    params: GPRParams
    cache: GPRCache
    features: FourierFeatures
    w: torch.Tensor  # [B, m] prior weights
    v: torch.Tensor  # [B, C] pathwise-update weights

    def __call__(self, x: torch.Tensor) -> torch.Tensor:  # [N, B, D] -> [N, B, 1]
        prior = torch.einsum("nbm,bm->nb", self.features(x), self.w)
        kxn = gram(self.params.kernel, x, self.cache.X)  # [N, B, C]
        kxn = kxn * self.cache.mask.to(kxn.dtype)
        update = torch.einsum("nbc,bc->nb", kxn, self.v)
        return (self.params.mean_constant + prior + update)[..., None]


def decoupled_trajectory_from_draws(
    params: GPRParams,
    cache: GPRCache,
    observations: torch.Tensor,
    features: FourierFeatures,
    w: torch.Tensor,
    noise_eps: torch.Tensor,
) -> DecoupledTrajectory:
    """The trajectory of prior weights ``w [B, m]`` and standard-normal observation-noise
    draws ``noise_eps [B, C]``, for padded ``observations [C, 1]``."""
    mask = cache.mask.to(w.dtype)
    prior_at_X = w @ features(cache.X).T  # [B, C]
    noise = torch.sqrt(params.noise_variance) * noise_eps
    y_centered = observations[:, 0] - params.mean_constant  # single-output trajectories
    resid = (y_centered[None, :] - prior_at_X - noise) * mask
    v = cho_solve(cache.L, resid.T).T  # [B, C]
    return DecoupledTrajectory(params=params, cache=cache, features=features, w=w, v=v)


class DecoupledTrajectorySampler(TrajectorySampler):
    """Builds :class:`DecoupledTrajectory` draws from a GPR model."""

    def __init__(self, model, num_features: int = 1000):
        super().__init__(model)
        self._num_features = num_features

    def get_trajectory(
        self, generator: Optional[torch.Generator], batch_size: int = 1
    ) -> TrajectoryFunction:
        params: GPRParams = self._model.params
        cache: GPRCache = self._model.posterior_cache
        C, D = cache.X.shape
        generator = generator_for(generator, cache.X.device)
        features = make_fourier_features(generator, params.kernel, self._num_features, D)
        w = standard_normal(generator, (batch_size, self._num_features), cache.X)
        noise_eps = standard_normal(generator, (batch_size, C), cache.X)
        observations = self._model.get_internal_data().observations
        return decoupled_trajectory_from_draws(params, cache, observations, features, w, noise_eps)

    def update_trajectory(
        self, trajectory: TrajectoryFunction, generator: Optional[torch.Generator] = None
    ) -> TrajectoryFunction:
        """Rebuild against the model's current state, with fresh randomness."""
        if not isinstance(trajectory, DecoupledTrajectory):
            raise TypeError(f"expected a DecoupledTrajectory, got {type(trajectory).__name__}")
        return self.get_trajectory(generator, trajectory.w.shape[0])


@dataclass(frozen=True)
class RFFTrajectory(TrajectoryFunctionClass):
    """A weight-space posterior draw ``f_b(x) = mean + phi(x) theta_b``."""

    mean_constant: torch.Tensor
    features: FourierFeatures
    theta: torch.Tensor  # [B, m]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:  # [N, B, D] -> [N, B, 1]
        phi = self.features(x)  # [N, B, m]
        return (self.mean_constant + torch.einsum("nbm,bm->nb", phi, self.theta))[..., None]


def rff_trajectory_from_draws(
    params: GPRParams,
    cache: GPRCache,
    observations: torch.Tensor,
    features: FourierFeatures,
    eps: torch.Tensor,
    eps_n: Optional[torch.Tensor] = None,
) -> RFFTrajectory:
    """The weight-space posterior draw of standard-normal ``eps [B, m]`` (and, on the
    kernel-trick route, ``eps_n [B, C]``), for padded ``observations [C, 1]``.

    Two routes. With the capacity ``C`` at most the feature count ``m`` (the usual regime)
    the C×C system ``ΦΦᵀ + σ²I`` is factorized, which conditions like the GP's own jittered
    Gram, and the draw uses the weight-space Matheron identity
    ``θ = ε + Φᵀ (ΦΦᵀ + σ²I)⁻¹ (y − Φε − ε_n)``, ``ε_n ~ N(0, σ²I)``. Otherwise the m×m
    normal equations ``ΦᵀΦ + σ²I`` are factorized; their conditioning is about ``‖Φ‖²/σ²``,
    which a tiny noise in fp32 does not survive. Both give the same posterior mean and
    covariance by the push-through and Woodbury identities.
    """
    C, m = cache.X.shape[0], features.W.shape[0]
    mask = cache.mask.to(cache.X.dtype)
    phi_X = features(cache.X) * mask[:, None]  # [C, m]
    y = (observations[:, 0] - params.mean_constant) * mask  # [C]
    sigma2 = params.noise_variance
    if C <= m:
        eye = torch.eye(C, dtype=phi_X.dtype, device=phi_X.device)
        L_B = masked_cholesky(phi_X @ phi_X.T + sigma2 * eye, cache.mask)  # padding inert
        resid = (y[None, :] - eps @ phi_X.T - torch.sqrt(sigma2) * eps_n) * mask[None, :]
        theta = eps + cho_solve(L_B, resid.T).T @ phi_X  # [B, m]
    else:
        eye = torch.eye(m, dtype=phi_X.dtype, device=phi_X.device)
        L_A = nan_cholesky(phi_X.T @ phi_X + (sigma2 + jitter_for(phi_X.dtype)) * eye)
        theta_mean = cho_solve(L_A, (phi_X.T @ y)[:, None])[:, 0]  # [m]
        spread = torch.linalg.solve_triangular(L_A.T, eps.T, upper=True).T
        theta = theta_mean[None, :] + torch.sqrt(sigma2) * spread
    return RFFTrajectory(mean_constant=params.mean_constant, features=features, theta=theta)


class RandomFourierFeatureTrajectorySampler(TrajectorySampler):
    """Weight-space trajectory sampler: the exact Bayesian linear-model posterior over
    the RFF weights (see :func:`rff_trajectory_from_draws` for its two routes)."""

    def __init__(self, model, num_features: int = 1000):
        super().__init__(model)
        self._num_features = num_features

    def get_trajectory(
        self, generator: Optional[torch.Generator], batch_size: int = 1
    ) -> TrajectoryFunction:
        params: GPRParams = self._model.params
        cache: GPRCache = self._model.posterior_cache
        C, D = cache.X.shape
        m = self._num_features
        generator = generator_for(generator, cache.X.device)
        features = make_fourier_features(generator, params.kernel, m, D)
        eps = standard_normal(generator, (batch_size, m), cache.X)
        eps_n = standard_normal(generator, (batch_size, C), cache.X) if C <= m else None
        observations = self._model.get_internal_data().observations
        return rff_trajectory_from_draws(params, cache, observations, features, eps, eps_n)


@dataclass(frozen=True)
class DecoupledInducingTrajectory(TrajectoryFunctionClass):
    """A Matheron-rule draw through inducing variables, one per batch column:
    ``f_b(x) = mean + phi(x) w_b + k(x, Z) v_b`` with ``v_b = Kuu⁻¹ (u_b − phi(Z) w_b)``
    and ``u_b ~ q(u)``."""

    mean_constant: torch.Tensor
    kernel: Stationary
    Z: torch.Tensor  # [M, D]
    L_uu: torch.Tensor  # chol(Kuu + 1e-6 I) [M, M]
    features: FourierFeatures
    w: torch.Tensor  # [B, m]
    v: torch.Tensor  # [B, M]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:  # [N, B, D] -> [N, B, 1]
        prior = torch.einsum("nbm,bm->nb", self.features(x), self.w)
        update = torch.einsum("nbk,bk->nb", gram(self.kernel, x, self.Z), self.v)
        return (self.mean_constant + prior + update)[..., None]


def decoupled_inducing_trajectory_from_draws(
    kernel: Stationary,
    mean_constant: torch.Tensor,
    inducing_variables: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, bool],
    features: FourierFeatures,
    w: torch.Tensor,
    eps: torch.Tensor,
) -> DecoupledInducingTrajectory:
    """The trajectory of prior weights ``w [B, m]`` and standard normals ``eps [B, M]``
    that draw ``u_b`` from ``q(u)`` (its first output), given a model's
    ``(Z, q_mu, q_sqrt, whiten)``."""
    Z, q_mu, q_sqrt, whiten = inducing_variables
    M = Z.shape[0]
    L_uu = nan_cholesky(gram(kernel, Z) + 1e-6 * torch.eye(M, dtype=Z.dtype, device=Z.device))
    v_sample = q_mu[:, 0][None, :] + eps @ q_sqrt[0].T  # [B, M]
    u_sample = v_sample @ L_uu.T if whiten else v_sample
    resid = u_sample - w @ features(Z).T  # [B, M]
    v = cho_solve(L_uu, resid.T).T
    return DecoupledInducingTrajectory(
        mean_constant=mean_constant, kernel=kernel, Z=Z, L_uu=L_uu, features=features, w=w, v=v
    )


class DecoupledInducingTrajectorySampler(TrajectorySampler):
    """Decoupled trajectories of a model that exposes ``get_inducing_variables`` (SGPR,
    SVGP)."""

    def __init__(self, model, num_features: int = 1000):
        super().__init__(model)
        self._num_features = num_features

    def get_trajectory(
        self, generator: Optional[torch.Generator], batch_size: int = 1
    ) -> TrajectoryFunction:
        params = self._model.params
        inducing = self._model.get_inducing_variables()
        Z = inducing[0]
        generator = generator_for(generator, Z.device)
        features = make_fourier_features(generator, params.kernel, self._num_features, Z.shape[1])
        w = standard_normal(generator, (batch_size, self._num_features), Z)
        eps = standard_normal(generator, (batch_size, Z.shape[0]), Z)
        return decoupled_inducing_trajectory_from_draws(
            params.kernel, params.mean_constant, inducing, features, w, eps
        )

"""Variational GP for non-conjugate likelihoods (counterpart of
:mod:`trieste_tpu.models.gp.vgp`).

A whitened full-rank variational posterior over the latent function at the training
inputs, ``f = mean + L v`` with ``L = chol(K)`` over the padded, masked inputs,
``q(v) = N(q_mu, q_sqrt q_sqrtᵀ)`` and the prior ``N(0, I)``: an SVGP whose inducing
points are the training inputs. The likelihood
(:mod:`~trieste_tpu_torch.models.gp.likelihoods`) defaults to the probit-Bernoulli of a
classifier. Training alternates natural-gradient steps on ``(q_mu, q_sqrt)`` with L-BFGS
steps on the hyperparameters.

The model predicts in the whitened form, O(N·C²) per call: it never reaches the fused
prediction kernel, which serves the exact GP only.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import torch

from ...data import Dataset
from ...ops.kernels import Stationary, gram
from ...ops.lbfgs import minimize_lbfgs
from ...ops.linalg import cho_solve, masked_cholesky, nan_cholesky, solve_lower
from ...space import SearchSpace
from ...utils.misc import flatten_leading_dims, standard_normal
from .likelihoods import BernoulliLikelihood
from .priors import GPPriors, default_priors, log_prior_density
from .training import MIN_VARIANCE

CLASSIFICATION_KERNEL_VARIANCE_NOISE_FREE = 100.0
"""The classifier's kernel variance where the labels are noise-free."""

CLASSIFICATION_KERNEL_VARIANCE = 1.0
"""The classifier's kernel variance."""


@dataclass(frozen=True)
class VGPParams:
    kernel: Stationary
    mean_constant: torch.Tensor
    q_mu: torch.Tensor  # [C, 1] whitened mean
    q_sqrt: torch.Tensor  # [C, C] whitened lower-triangular square root
    likelihood: object = field(default_factory=BernoulliLikelihood)

    def replace(self, **changes) -> "VGPParams":
        return dataclasses.replace(self, **changes)


def vgp_variational_expectations(
    mean: torch.Tensor, var: torch.Tensor, Y: torch.Tensor, likelihood=None
) -> torch.Tensor:
    """``E_{N(f | mean, var)}[log p(y | f)]`` for ``likelihood`` (default probit-Bernoulli),
    ``[C, 1]``."""
    likelihood = likelihood if likelihood is not None else BernoulliLikelihood()
    return likelihood.variational_expectations(mean, torch.clamp_min(var, 1e-24), Y)


def _latent_moments(
    params: VGPParams, L: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The marginal moments of ``q(f)`` at the training inputs, ``[C]`` each."""
    m = mask.to(L.dtype)
    f_mean = (L @ params.q_mu)[:, 0] + params.mean_constant
    f_var = torch.sum(torch.square(L @ params.q_sqrt), dim=-1)
    return f_mean * m + (1 - m) * params.mean_constant, torch.clamp_min(f_var, 1e-24)


def vgp_elbo(
    params: VGPParams, X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """The whitened ELBO: the masked expected log likelihood minus KL[q(v) || N(0, I)]."""
    m = mask.to(X.dtype)
    L = masked_cholesky(gram(params.kernel, X), mask)
    f_mean, f_var = _latent_moments(params, L, mask)
    ve = vgp_variational_expectations(f_mean[:, None], f_var[:, None], Y, params.likelihood)
    lik = torch.sum(ve[:, 0] * m)
    diag = torch.diagonal(params.q_sqrt)
    # the KL over the valid block; padded rows sit at the prior by construction
    kl = 0.5 * (
        torch.sum(torch.square(params.q_mu[:, 0]) * m)
        + torch.sum(torch.square(params.q_sqrt) * (m[:, None] * m[None, :]))
        - torch.sum(m)
        - 2.0 * torch.sum(torch.log(torch.clamp_min(torch.abs(diag), 1e-24)) * m)
    )
    return lik - kl


def natural_gradient_step_with_status(
    params: VGPParams, X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor, gamma: float = 0.5
) -> Tuple[VGPParams, torch.Tensor]:
    """:func:`natural_gradient_step` and whether it was taken, a boolean tensor on the
    data's device (no host read)."""
    C = params.q_mu.shape[0]
    eye = torch.eye(C, dtype=X.dtype, device=X.device)
    S = params.q_sqrt @ params.q_sqrt.T + 1e-10 * eye
    mvec = params.q_mu[:, 0].detach().requires_grad_(True)
    S_leaf = S.detach().requires_grad_(True)
    with torch.enable_grad():
        q_sqrt = nan_cholesky(0.5 * (S_leaf + S_leaf.T) + 1e-10 * eye)
        elbo = vgp_elbo(params.replace(q_mu=mvec[:, None], q_sqrt=q_sqrt), X, Y, mask)
        dL_dm, dL_dS = torch.autograd.grad(elbo, (mvec, S_leaf))
    mvec = mvec.detach()
    dL_dS = 0.5 * (dL_dS + dL_dS.T)
    S_inv = cho_solve(nan_cholesky(S), eye)
    theta1 = S_inv @ mvec + gamma * (dL_dm - 2.0 * dL_dS @ mvec)
    theta2 = -0.5 * S_inv + gamma * dL_dS
    # back to moments, S' = -θ₂'⁻¹/2, where θ₂' is still negative definite
    neg2 = -2.0 * theta2
    L2 = nan_cholesky(0.5 * (neg2 + neg2.T) + 1e-8 * eye)
    ok = torch.all(torch.isfinite(torch.diagonal(L2)))
    S_new = cho_solve(L2, eye)
    q_mu = (S_new @ theta1)[:, None]
    q_sqrt_new = nan_cholesky(0.5 * (S_new + S_new.T) + 1e-10 * eye)
    return params.replace(
        q_mu=torch.where(ok, q_mu, params.q_mu),
        q_sqrt=torch.where(ok, q_sqrt_new, params.q_sqrt),
    ), ok


def natural_gradient_step(
    params: VGPParams, X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor, gamma: float = 0.5
) -> VGPParams:
    """One natural-gradient ascent step on ``(q_mu, q_sqrt)`` in expectation parameters.

    With ``η₁ = m``, ``η₂ = S + m mᵀ`` and the natural parameters ``θ₁ = S⁻¹m``,
    ``θ₂ = −S⁻¹/2``, the step is ``θ += gamma · dL/dη``, where ``dL/dη₁ = dL/dm − 2 (dL/dS) m``
    and ``dL/dη₂ = dL/dS``. A step that leaves the positive-definite cone (its Cholesky
    fails) is rejected and the parameters stay as they were."""
    return natural_gradient_step_with_status(params, X, Y, mask, gamma)[0]


def vgp_predict_f(
    params: VGPParams, X: torch.Tensor, mask: torch.Tensor, query_points: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latent predictions ``[..., D] -> mean [..., 1], var [..., 1]`` (the SVGP form with
    the training inputs as inducing points)."""
    flat, unflatten = flatten_leading_dims(query_points, output_dims=2)
    L = masked_cholesky(gram(params.kernel, X), mask)
    Kxn = gram(params.kernel, flat, X) * mask.to(flat.dtype)[None, :]  # [N, C]
    A = solve_lower(L, Kxn.T)  # [C, N]
    mean = A.T @ params.q_mu + params.mean_constant  # [N, 1]
    SA = params.q_sqrt.T @ A  # [C, N]
    var = (
        params.kernel.diag(flat)
        - torch.sum(torch.square(A), dim=0)
        + torch.sum(torch.square(SA), dim=0)
    )
    var = torch.clamp_min(var, 1e-24)[:, None]
    return unflatten(mean), unflatten(var.expand(mean.shape))


class VGPTrainingResult(NamedTuple):
    params: VGPParams
    loss: torch.Tensor
    rejected_steps: torch.Tensor  # natural-gradient steps rejected in the fit, on the device
    rejected_hyper_steps: torch.Tensor  # hyperparameter runs that ended at a non-finite loss


def _hyper_pack(p: VGPParams, train_lik_var: bool) -> torch.Tensor:
    """``[log σ², log ℓ..., (log noise)]``."""
    parts = [
        torch.log(torch.clamp_min(torch.atleast_1d(p.kernel.variance), MIN_VARIANCE)),
        torch.log(torch.clamp_min(p.kernel.lengthscales, MIN_VARIANCE)),
    ]
    if train_lik_var:
        parts.append(torch.log(torch.clamp_min(torch.atleast_1d(p.likelihood.variance), MIN_VARIANCE)))
    return torch.cat(parts)


def _hyper_where(ok: torch.Tensor, new: VGPParams, old: VGPParams, train_lik_var: bool) -> VGPParams:
    """``new``'s hyperparameters where ``ok``, else ``old``'s, decided on the device."""
    kernel = old.kernel.replace(
        variance=torch.where(ok, new.kernel.variance, old.kernel.variance),
        lengthscales=torch.where(ok, new.kernel.lengthscales, old.kernel.lengthscales),
    )
    p = old.replace(kernel=kernel)
    if train_lik_var:
        p = p.replace(likelihood=p.likelihood.replace(
            variance=torch.where(ok, new.likelihood.variance, old.likelihood.variance)))
    return p


def _hyper_unpack(u: torch.Tensor, p: VGPParams, train_lik_var: bool) -> VGPParams:
    n_ls = p.kernel.lengthscales.shape[-1]
    p = p.replace(kernel=p.kernel.replace(variance=torch.exp(u[0]),
                                          lengthscales=torch.exp(u[1 : 1 + n_ls])))
    if train_lik_var:
        p = p.replace(likelihood=p.likelihood.replace(variance=torch.exp(u[1 + n_ls])))
    return p


def fit_vgp(
    params: VGPParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    mask: torch.Tensor,
    *,
    num_alternations: int = 10,
    num_natgrad_steps: int = 5,
    gamma: float = 0.5,
    max_hyper_iters: int = 25,
    priors: Optional[GPPriors] = None,
) -> VGPTrainingResult:
    """Alternate ``num_natgrad_steps`` natural-gradient steps with an L-BFGS run on the
    hyperparameters (MAP with ``priors``), ``num_alternations`` times, and end with
    natural-gradient steps. A Gaussian likelihood's variance joins the hyperparameters.

    Each L-BFGS run after the first starts where the last one ended, in log space: in fp32
    at capacity 1024 the Cholesky of ``K + 1e-5·I`` fails at some hyperparameters, and the
    JAX package's round trip ``log(exp(u))`` between runs can land there. A run that ends at
    a non-finite loss is rejected and the hyperparameters stay as they were, where the JAX
    package takes them. Both kinds of rejection are counted on the device."""
    train_lik_var = hasattr(params.likelihood, "variance")
    rejected = torch.zeros((), dtype=torch.int64, device=X.device)
    rejected_hyper = torch.zeros((), dtype=torch.int64, device=X.device)

    def natural_steps(p: VGPParams) -> VGPParams:
        nonlocal rejected
        for _ in range(num_natgrad_steps):
            p, ok = natural_gradient_step_with_status(p, X, Y, mask, gamma)
            rejected = rejected + (~ok).to(torch.int64)
        return p

    p, u = params, _hyper_pack(params, train_lik_var)
    for _ in range(num_alternations):
        p = natural_steps(p)

        def loss_fn(u: torch.Tensor, p=p) -> torch.Tensor:  # [k, n] -> [k], row by row
            def loss(row: torch.Tensor) -> torch.Tensor:
                p_u = _hyper_unpack(row, p, train_lik_var)
                return -vgp_elbo(p_u, X, Y, mask) - log_prior_density(p_u.kernel, priors)

            return torch.stack([loss(row) for row in u])

        res = minimize_lbfgs(loss_fn, u[None], max_iters=max_hyper_iters)
        finite = torch.isfinite(res.fun[0])
        rejected_hyper = rejected_hyper + (~finite).to(torch.int64)
        u = torch.where(finite, res.x[0].detach(), u)
        p = _hyper_where(finite, _hyper_unpack(u, p, train_lik_var), p, train_lik_var)
    p = natural_steps(p)
    with torch.no_grad():
        loss = -vgp_elbo(p, X, Y, mask)
    return VGPTrainingResult(params=p, loss=loss, rejected_steps=rejected,
                             rejected_hyper_steps=rejected_hyper)


class VariationalGaussianProcess:
    """A VGP over any likelihood of :mod:`.likelihoods`; the default probit-Bernoulli makes
    it a classifier. ``TrainableProbabilisticModel``, ``SupportsPredictY``,
    ``SupportsGetKernel`` and ``SupportsGetInternalData``.

    ``predict`` gives the latent moments; ``predict_y`` maps them through the likelihood
    (for Bernoulli the probit integral ``Φ(mean / sqrt(1 + var))``)."""

    def __init__(
        self,
        params: VGPParams,
        dataset: Dataset,
        *,
        num_alternations: int = 10,
        priors: Optional[GPPriors] = None,
    ):
        self._params = params
        self._dataset = dataset
        self._num_alternations = num_alternations
        self._priors = priors

    @property
    def params(self) -> VGPParams:
        return self._params

    def get_kernel(self) -> Stationary:
        return self._params.kernel

    def get_internal_data(self) -> Dataset:
        return self._dataset

    def predict(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        ds = self._dataset
        return vgp_predict_f(self._params, ds.query_points, ds.mask, query_points)

    def predict_y(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, var = self.predict(query_points)
        return self._params.likelihood.predict_y(mean, var)

    def sample(
        self, generator: Optional[torch.Generator], query_points: torch.Tensor, num_samples: int
    ) -> torch.Tensor:
        """Independent samples of the latent marginals, ``[S, ..., 1]``."""
        mean, var = self.predict(query_points)
        eps = standard_normal(generator, (num_samples,) + tuple(mean.shape), mean)
        return mean[None] + torch.sqrt(var)[None] * eps

    def update(self, dataset: Dataset) -> None:
        """Set the data; at a new capacity ``q_mu`` and ``q_sqrt`` keep their leading block
        and are padded with the prior (zeros and the identity)."""
        C, old_C = dataset.capacity, self._params.q_mu.shape[0]
        if C != old_C:
            n = min(old_C, C)
            like = self._params.q_mu
            q_mu = like.new_zeros((C, 1))
            q_mu[:n] = like[:n]
            q_sqrt = torch.eye(C, dtype=like.dtype, device=like.device)
            q_sqrt[:n, :n] = self._params.q_sqrt[:n, :n]
            self._params = self._params.replace(q_mu=q_mu, q_sqrt=q_sqrt)
        self._dataset = dataset

    def optimize(self, dataset: Dataset) -> VGPTrainingResult:
        result = fit_vgp(
            self._params, dataset.query_points, dataset.observations, dataset.mask,
            num_alternations=self._num_alternations, priors=self._priors,
        )
        self._params = result.params
        self._dataset = dataset
        return result

    def log(self, dataset: Optional[Dataset] = None) -> None:
        """Nothing is logged, as in the JAX package."""

    def __repr__(self) -> str:
        return f"VariationalGaussianProcess(n={len(self._dataset)})"


def build_vgp_classifier(
    dataset: Dataset,
    search_space: SearchSpace,
    *,
    kernel_kind: str = "matern52",
    noise_free: bool = False,
) -> VariationalGaussianProcess:
    """A probit-Bernoulli VGP classifier: kernel variance
    :data:`CLASSIFICATION_KERNEL_VARIANCE` (``..._NOISE_FREE`` for noise-free labels),
    lengthscales ``0.2 · extent · √D``, LogNormal priors at those, ``q_mu = 0`` and
    ``q_sqrt = I``."""
    from ...ops.kernels import stationary

    dtype, device = dataset.query_points.dtype, dataset.device
    extent = (search_space.upper - search_space.lower).to(dtype=dtype, device=device)
    variance = CLASSIFICATION_KERNEL_VARIANCE_NOISE_FREE if noise_free else CLASSIFICATION_KERNEL_VARIANCE
    kernel = stationary(kernel_kind, variance=variance,
                        lengthscales=0.2 * extent * math.sqrt(search_space.dimension),
                        dtype=dtype, device=device)
    C = dataset.capacity
    params = VGPParams(
        kernel=kernel,
        mean_constant=torch.zeros((), dtype=dtype, device=device),
        q_mu=torch.zeros((C, 1), dtype=dtype, device=device),
        q_sqrt=torch.eye(C, dtype=dtype, device=device),
    )
    return VariationalGaussianProcess(params, dataset, priors=default_priors(kernel))

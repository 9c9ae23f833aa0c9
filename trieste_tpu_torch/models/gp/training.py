"""GP hyperparameter training by multi-start L-BFGS (counterpart of
:mod:`trieste_tpu.models.gp.training`).

All restarts are optimized to convergence at once, as one batch of lockstep L-BFGS runs
(:mod:`trieste_tpu_torch.ops.lbfgs`) over a batched log marginal likelihood, and the best
final loss wins. Positive hyperparameters are trained in log space; the observation noise
keeps a small floor. With ``priors`` the fit is MAP: restarts are drawn from the priors,
the loss carries the log prior density, and the winner is squeezed into a wide window
around the prior locs.

:func:`randomize_starts` and :func:`fit_gpr_from_starts` split :func:`fit_gpr` so that a
caller (a test) can hand in its own starts.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...ops.lbfgs import minimize_lbfgs
from .posterior import GPRParams, log_marginal_likelihood
from .priors import GPPriors, log_prior_density, sample_log_params, squeeze_kernel

NOISE_FLOOR = 1e-8
MIN_VARIANCE = 1e-12
LN10 = 2.302585092994046


class GPRTrainingResult(NamedTuple):
    params: GPRParams
    loss: torch.Tensor  # best negative log marginal likelihood (or log posterior)
    all_losses: torch.Tensor  # [R] per-restart final losses


def pack_params(params: GPRParams, train_noise: bool = True) -> torch.Tensor:
    """Flatten the trainable hyperparameters into an unconstrained vector
    ``[log σ², log ℓ..., m, (log(noise − floor))]``."""
    k = params.kernel
    parts = [
        torch.log(torch.clamp_min(torch.atleast_1d(k.variance), MIN_VARIANCE)),
        torch.log(torch.clamp_min(k.lengthscales, MIN_VARIANCE)),
        torch.atleast_1d(params.mean_constant),
    ]
    if train_noise:
        parts.append(
            torch.log(torch.clamp_min(torch.atleast_1d(params.noise_variance) - NOISE_FLOOR, MIN_VARIANCE))
        )
    return torch.cat(parts)


def unpack_params(u: torch.Tensor, template: GPRParams, train_noise: bool = True) -> GPRParams:
    """Inverse of :func:`pack_params`; ``u [..., P]`` gives hyperparameters batched over
    ``[...]``."""
    n_ls = template.kernel.lengthscales.shape[-1]
    noise = NOISE_FLOOR + torch.exp(u[..., 2 + n_ls]) if train_noise else template.noise_variance
    return GPRParams(
        kernel=template.kernel.replace(
            variance=torch.exp(u[..., 0]), lengthscales=torch.exp(u[..., 1 : 1 + n_ls])
        ),
        noise_variance=noise,
        mean_constant=u[..., 1 + n_ls],
    )


def randomize_starts(
    generator: Optional[torch.Generator],
    params: GPRParams,
    num_starts: int,
    train_noise: bool = True,
    priors: Optional[GPPriors] = None,
) -> torch.Tensor:
    """``[R, P]`` initial vectors: the current parameters plus ``R − 1`` restarts. With
    ``priors`` the kernel entries of the restarts come from the LogNormal priors (the
    noise and the mean stay); without, they are log-uniform perturbations within a
    factor of 10 (the mean stays)."""
    u0 = pack_params(params, train_noise)
    n_ls = params.kernel.lengthscales.shape[-1]
    rest = u0.expand(num_starts - 1, u0.shape[0]).clone()
    if priors is not None:
        log_var, log_ls = sample_log_params(generator, priors, num_starts - 1, n_ls)
        rest[:, 0] = log_var
        rest[:, 1 : 1 + n_ls] = log_ls
    else:
        shifts = torch.rand(rest.shape, generator=generator, dtype=u0.dtype, device=u0.device)
        shifts = (2.0 * shifts - 1.0) * LN10
        shifts[:, 1 + n_ls] = 0.0
        rest = rest + shifts
    return torch.cat([u0[None], rest])


def fit_gpr_from_starts(
    starts: torch.Tensor,
    params: GPRParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    mask: torch.Tensor,
    *,
    train_noise: bool = True,
    max_iters: int = 100,
    priors: Optional[GPPriors] = None,
) -> GPRTrainingResult:
    """Run L-BFGS from every row of ``starts [R, P]`` on the negative log marginal
    likelihood (negative log posterior with ``priors``) and keep the best."""

    def loss_fn(u: torch.Tensor) -> torch.Tensor:
        p = unpack_params(u, params, train_noise)
        nll = -log_marginal_likelihood(p, X, Y, mask)
        if priors is not None:
            nll = nll - log_prior_density(p.kernel, priors)
        return nll

    results = minimize_lbfgs(loss_fn, starts, max_iters=max_iters)
    losses = torch.where(torch.isfinite(results.fun), results.fun, torch.inf)
    best = torch.argmin(losses)
    best_params = unpack_params(results.x[best], params, train_noise)
    if priors is not None:
        best_params = best_params.replace(kernel=squeeze_kernel(best_params.kernel, priors))
    return GPRTrainingResult(params=best_params, loss=losses[best], all_losses=losses)


def fit_gpr(
    generator: Optional[torch.Generator],
    params: GPRParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    mask: torch.Tensor,
    *,
    num_starts: int = 10,
    train_noise: bool = True,
    max_iters: int = 100,
    priors: Optional[GPPriors] = None,
) -> GPRTrainingResult:
    """Multi-start MAP (or, without priors, maximum-likelihood) fit of the GPR
    hyperparameters, restarts drawn from ``generator``."""
    starts = randomize_starts(generator, params, num_starts, train_noise, priors=priors)
    return fit_gpr_from_starts(
        starts, params, X, Y, mask, train_noise=train_noise, max_iters=max_iters, priors=priors
    )

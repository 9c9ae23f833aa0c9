"""LogNormal priors over stationary-kernel hyperparameters for MAP training (counterpart
of :mod:`trieste_tpu.models.gp.priors`): the log density added to the fit's loss, the
prior-sampled restarts, and the post-fit squeeze into a wide window around the locs."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ...ops.kernels import Stationary

KERNEL_PRIOR_SCALE = 1.0
"""LogNormal prior scale."""

SQUEEZE_LOG_RANGE = math.log(1e3)
"""Post-fit clip window: fitted log-params stay within ``loc ± log(1e3)``."""


@dataclass(frozen=True)
class GPPriors:
    """LogNormal priors: ``ls_loc``/``var_loc`` are the logs of the prior medians of the
    lengthscales ``[D]`` (or ``[1]``) and of the signal variance; ``scale`` is shared."""

    ls_loc: torch.Tensor
    var_loc: torch.Tensor
    scale: torch.Tensor


def default_priors(kernel: Stationary, scale: float = KERNEL_PRIOR_SCALE) -> GPPriors:
    """Priors centred at the kernel's current (initial) hyperparameters."""
    return GPPriors(
        ls_loc=torch.log(torch.clamp_min(kernel.lengthscales, 1e-12)),
        var_loc=torch.log(torch.clamp_min(kernel.variance, 1e-12)),
        scale=torch.as_tensor(scale, dtype=kernel.variance.dtype, device=kernel.variance.device),
    )


def log_prior_density(kernel: Stationary, priors: Optional[GPPriors]) -> torch.Tensor:
    """Sum of the LogNormal log-densities of the kernel hyperparameters (constants
    dropped): ``-log x - ((log x - loc)/s)²/2`` for each; ``[...]`` for a batch of kernels."""
    if priors is None:
        return torch.zeros_like(kernel.variance)
    log_ls = torch.log(torch.clamp_min(kernel.lengthscales, 1e-30))
    log_var = torch.log(torch.clamp_min(kernel.variance, 1e-30))
    s = priors.scale
    ls_term = torch.sum(-log_ls - 0.5 * torch.square((log_ls - priors.ls_loc) / s), dim=-1)
    var_term = -log_var - 0.5 * torch.square((log_var - priors.var_loc) / s)
    return ls_term + var_term


def sample_log_params(
    generator: Optional[torch.Generator], priors: GPPriors, num_samples: int, n_ls: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``(log_variance [R], log_lengthscales [R, n_ls])`` from the priors."""
    dtype, device = priors.var_loc.dtype, priors.var_loc.device
    z_var = torch.randn(num_samples, generator=generator, dtype=dtype, device=device)
    z_ls = torch.randn((num_samples, n_ls), generator=generator, dtype=dtype, device=device)
    return priors.var_loc + priors.scale * z_var, priors.ls_loc + priors.scale * z_ls


def squeeze_kernel(kernel: Stationary, priors: Optional[GPPriors]) -> Stationary:
    """Clip fitted kernel hyperparameters to ``exp(loc ± SQUEEZE_LOG_RANGE)``."""
    if priors is None:
        return kernel
    log_ls = torch.log(torch.clamp_min(kernel.lengthscales, 1e-30))
    log_ls = torch.clamp(log_ls, priors.ls_loc - SQUEEZE_LOG_RANGE, priors.ls_loc + SQUEEZE_LOG_RANGE)
    log_var = torch.log(torch.clamp_min(kernel.variance, 1e-30))
    log_var = torch.clamp(
        log_var, priors.var_loc - SQUEEZE_LOG_RANGE, priors.var_loc + SQUEEZE_LOG_RANGE
    )
    return kernel.replace(lengthscales=torch.exp(log_ls), variance=torch.exp(log_var))

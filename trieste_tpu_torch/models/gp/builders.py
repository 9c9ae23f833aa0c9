"""Model builders with data- and space-scaled defaults (counterpart of
:mod:`trieste_tpu.models.gp.builders`)."""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...data import Dataset
from ...ops.kernels import MATERN52, stationary
from ...space import SearchSpace
from .gpr import GaussianProcessRegression
from .posterior import GPRParams
from .priors import KERNEL_PRIOR_SCALE, default_priors

SIGNAL_NOISE_RATIO_LIKELIHOOD = 10.0
"""Signal-to-noise ratio that sets the default likelihood variance."""

KERNEL_LENGTHSCALE = 0.2
"""Initial lengthscales: ``0.2 · extent · √D`` per dimension."""


def default_gpr_params(
    dataset: Dataset,
    search_space: SearchSpace,
    *,
    kernel_kind: str = MATERN52,
    likelihood_variance: Optional[float] = None,
) -> GPRParams:
    """Initial hyperparameters scaled to the data and the space."""
    y = dataset.trimmed_observations
    dtype, device = dataset.query_points.dtype, dataset.device
    if y.shape[0] > 1:
        y_var = torch.clamp_min(torch.var(y, correction=0), 1e-6)
    else:
        y_var = torch.tensor(1.0, dtype=dtype, device=device)
    y_mean = torch.mean(y) if y.shape[0] > 0 else torch.tensor(0.0, dtype=dtype, device=device)
    extent = (search_space.upper - search_space.lower).to(dtype=dtype, device=device)
    lengthscales = KERNEL_LENGTHSCALE * extent * math.sqrt(search_space.dimension)
    # collapsed dimensions get a unit lengthscale
    lengthscales = torch.where(extent == 0.0, torch.ones_like(lengthscales), lengthscales)
    if likelihood_variance is None:
        noise = y_var / SIGNAL_NOISE_RATIO_LIKELIHOOD**2
    else:
        noise = torch.tensor(likelihood_variance, dtype=dtype, device=device)
    kernel = stationary(kernel_kind, variance=y_var, lengthscales=lengthscales, dtype=dtype,
                        device=device)
    return GPRParams(kernel=kernel, noise_variance=noise.to(dtype), mean_constant=y_mean.to(dtype))


def build_gpr(
    dataset: Dataset,
    search_space: SearchSpace,
    *,
    kernel_kind: str = MATERN52,
    kernel_priors: bool = True,
    likelihood_variance: Optional[float] = None,
    trainable_likelihood: bool = False,
    num_kernel_samples: int = 10,
    num_rff_features: int = 1000,
    optimize_generator: Optional[torch.Generator] = None,
) -> GaussianProcessRegression:
    """A :class:`GaussianProcessRegression` with a Matérn-5/2 ARD kernel scaled to the
    space, LogNormal MAP priors on the kernel hyperparameters, and a likelihood variance
    from a 10:1 signal-to-noise ratio (or fixed if given), not trainable by default."""
    params = default_gpr_params(
        dataset, search_space, kernel_kind=kernel_kind, likelihood_variance=likelihood_variance
    )
    priors = default_priors(params.kernel, KERNEL_PRIOR_SCALE) if kernel_priors else None
    return GaussianProcessRegression(
        params,
        dataset,
        num_kernel_samples=num_kernel_samples,
        train_noise=trainable_likelihood,
        num_rff_features=num_rff_features,
        optimize_generator=optimize_generator,
        priors=priors,
    )

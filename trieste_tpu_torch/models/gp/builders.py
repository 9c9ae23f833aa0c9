"""Model builders with data- and space-scaled defaults (counterpart of
:mod:`trieste_tpu.models.gp.builders`): the exact GP and the two sparse GPs, whose
inducing points start at k-means centroids of the data."""
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
from .sparse import SGPRParams, SparseGaussianProcessRegression, SparseVariational, SVGPParams

NUM_INDUCING_POINTS_PER_DIM = 25
"""Default inducing points per input dimension."""

MAX_NUM_INDUCING_POINTS = 500
"""Cap on the default number of inducing points."""

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


def _initial_inducing_points(
    dataset: Dataset, search_space: SearchSpace, num_inducing_points: Optional[int], seed: int
) -> torch.Tensor:
    """K-means centroids of the data (a padded random subsample if it is too small), from
    a generator seeded ``seed`` on the data's device."""
    from .inducing_points import KMeansInducingPointSelector

    M = num_inducing_points or min(
        NUM_INDUCING_POINTS_PER_DIM * search_space.dimension, MAX_NUM_INDUCING_POINTS
    )
    generator = torch.Generator(device=dataset.device).manual_seed(seed)
    return KMeansInducingPointSelector(generator=generator)._recalculate_inducing_points(
        M, None, dataset
    )


def build_sgpr(
    dataset: Dataset,
    search_space: SearchSpace,
    *,
    kernel_kind: str = MATERN52,
    kernel_priors: bool = True,
    likelihood_variance: Optional[float] = None,
    trainable_likelihood: bool = False,
    num_inducing_points: Optional[int] = None,
    trainable_inducing: bool = True,
    inducing_point_selector: Optional[object] = None,
    optimize_generator: Optional[torch.Generator] = None,
) -> SparseGaussianProcessRegression:
    """A :class:`SparseGaussianProcessRegression` with the kernel, priors and noise of
    :func:`build_gpr` and ``min(25·D, 500)`` inducing points (or ``num_inducing_points``)
    at k-means centroids of the data (generator seeded 7)."""
    base = default_gpr_params(
        dataset, search_space, kernel_kind=kernel_kind, likelihood_variance=likelihood_variance
    )
    params = SGPRParams(
        kernel=base.kernel,
        noise_variance=base.noise_variance,
        mean_constant=base.mean_constant,
        inducing_points=_initial_inducing_points(dataset, search_space, num_inducing_points, 7),
    )
    return SparseGaussianProcessRegression(
        params,
        dataset,
        inducing_point_selector=inducing_point_selector,
        train_noise=trainable_likelihood,
        train_inducing=trainable_inducing,
        optimize_generator=optimize_generator,
        priors=default_priors(base.kernel, KERNEL_PRIOR_SCALE) if kernel_priors else None,
    )


def build_svgp(
    dataset: Dataset,
    search_space: SearchSpace,
    *,
    kernel_kind: str = MATERN52,
    kernel_priors: bool = True,
    likelihood_variance: Optional[float] = None,
    trainable_likelihood: bool = False,
    num_inducing_points: Optional[int] = None,
    inducing_point_selector: Optional[object] = None,
    optimize_generator: Optional[torch.Generator] = None,
    minibatch_size: Optional[int] = None,
    minibatch_iters: int = 500,
    learning_rate: float = 0.05,
) -> SparseVariational:
    """A :class:`SparseVariational` SVGP with the kernel, priors and noise of
    :func:`build_gpr`, inducing points as :func:`build_sgpr` places them (generator seeded
    9), ``q_mu = 0`` and ``q_sqrt = I``. ``minibatch_size`` selects Adam on minibatches of
    that size for ``minibatch_iters`` steps, for large data."""
    base = default_gpr_params(
        dataset, search_space, kernel_kind=kernel_kind, likelihood_variance=likelihood_variance
    )
    Z = _initial_inducing_points(dataset, search_space, num_inducing_points, 9)
    M, P = Z.shape[0], dataset.num_outputs
    params = SVGPParams(
        kernel=base.kernel,
        noise_variance=base.noise_variance,
        mean_constant=base.mean_constant,
        inducing_points=Z,
        q_mu=Z.new_zeros((M, P)),
        q_sqrt=torch.eye(M, dtype=Z.dtype, device=Z.device).expand(P, M, M).clone(),
    )
    return SparseVariational(
        params,
        dataset,
        inducing_point_selector=inducing_point_selector,
        train_noise=trainable_likelihood,
        optimize_generator=optimize_generator,
        priors=default_priors(base.kernel, KERNEL_PRIOR_SCALE) if kernel_priors else None,
        minibatch_size=minibatch_size,
        minibatch_iters=minibatch_iters,
        learning_rate=learning_rate,
    )

"""Model diagnostics written as summaries (counterpart of :mod:`trieste_tpu.models.utils`):
the accuracy and calibration of a model's predictions over its data, and the parameters of
a stationary kernel and of a Gaussian likelihood. Every value is queued as a device
tensor, read at the loop's per-step flush."""
from __future__ import annotations

from typing import Tuple

import torch

from ..data import Dataset
from ..logging import (
    deferred_histogram,
    deferred_scalar,
    deferred_scalar_vector,
    get_tensorboard_writer,
)
from ..ops.kernels import Stationary
from .interfaces import ProbabilisticModel


def _metrics(
    model: ProbabilisticModel, qp: torch.Tensor, obs: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """``(mean, var, scalars [8], |error|, z residuals, variance error)`` of the model's
    marginal predictions at ``qp`` against ``obs``."""
    mean, var = model.predict(qp)
    diffs = obs.to(mean.dtype) - mean
    z_residuals = diffs / torch.sqrt(torch.clamp_min(var, 1e-24))
    variance_error = var - diffs**2
    scalars = torch.stack([
        torch.mean(mean),
        torch.mean(var),
        torch.mean(obs),
        torch.var(obs, correction=0),
        torch.sqrt(torch.mean(diffs**2)),
        torch.mean(torch.abs(diffs)),
        torch.std(z_residuals, correction=0),
        torch.sqrt(torch.mean(variance_error**2)),
    ])
    return mean, var, scalars, torch.abs(diffs), z_residuals, variance_error


def write_summary_data_based_metrics(
    dataset: Dataset, model: ProbabilisticModel, prefix: str = ""
) -> None:
    """Queue the accuracy and calibration of ``model`` on ``dataset``: histograms of the
    predicted means and variances, the observations, the absolute errors, the z residuals
    and the variance errors, and eight scalars summarizing them."""
    if get_tensorboard_writer() is None:
        return
    name = prefix + "accuracy"
    qp, obs = dataset.astuple()
    if qp.shape[0] == 0:
        return
    with torch.no_grad():
        mean, var, scalars, abs_diffs, z_residuals, variance_error = _metrics(model, qp, obs)
    deferred_histogram(f"{name}/predict_mean", mean)
    deferred_histogram(f"{name}/predict_variance", var)
    deferred_histogram(f"{name}/observations", obs)
    deferred_histogram(f"{name}/absolute_error", abs_diffs)
    deferred_histogram(f"{name}/z_residuals", z_residuals)
    deferred_histogram(f"{name}/variance_error", variance_error)
    deferred_scalar_vector(
        [
            f"{name}/predict_mean__mean",
            f"{name}/predict_variance__mean",
            f"{name}/observations_mean",
            f"{name}/observations_variance",
            f"{name}/root_mean_square_error",
            f"{name}/mean_absolute_error",
            f"{name}/z_residuals_std",
            f"{name}/root_mean_variance_error",
        ],
        scalars,
    )


def write_summary_kernel_parameters(kernel: Stationary, prefix: str = "") -> None:
    """Queue a stationary kernel's variance and each of its lengthscales."""
    if get_tensorboard_writer() is None:
        return
    deferred_scalar(f"{prefix}kernel.variance", kernel.variance)
    ls = torch.atleast_1d(kernel.lengthscales)
    if ls.shape[0] == 1:
        deferred_scalar(f"{prefix}kernel.lengthscales", ls[0])
    else:
        deferred_scalar_vector([f"{prefix}kernel.lengthscales[{i}]" for i in range(ls.shape[0])], ls)


def write_summary_likelihood_parameters(noise_variance: torch.Tensor, prefix: str = "") -> None:
    """Queue the observation-noise variance."""
    if get_tensorboard_writer() is None:
        return
    deferred_scalar(f"{prefix}likelihood.variance", noise_variance)

"""Analytic expected improvement (the EI part of
:mod:`trieste_tpu.acquisition.function.function`). Minimization convention."""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional

import torch

from ...data import Dataset
from ...models.interfaces import ProbabilisticModel
from ..interface import AcquisitionFunction, SingleModelAcquisitionBuilder
from ..utils import predictor

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _validate_dataset(dataset: Optional[Dataset], who: str) -> Dataset:
    if dataset is None or dataset.num_points == 0:
        raise ValueError(f"{who} requires a non-empty dataset")
    return dataset


def _min_posterior_mean(model: ProbabilisticModel, dataset: Dataset) -> torch.Tensor:
    """eta: the minimum posterior mean over the observed (unpadded) points."""
    mean, _ = model.predict(dataset.query_points)
    big = torch.finfo(mean.dtype).max
    return torch.min(torch.where(dataset.mask[:, None], mean, big))


def _single_batch(x: torch.Tensor, who: str) -> torch.Tensor:
    """Check that ``x`` is ``[..., 1, D]``: scoring only the first element of a batch
    would be wrong, not slow."""
    if x.ndim < 2 or x.shape[-2] != 1:
        raise ValueError(f"{who} only supports batch sizes of one, got query shape {tuple(x.shape)}")
    return x


def _ei_fn(predict: Callable, eta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Analytic expected improvement, ``x: [..., 1, D] -> [..., 1]``."""
    mean, var = predict(_single_batch(x, "expected_improvement")[..., 0, :])  # [..., L]
    std = torch.sqrt(torch.clamp_min(var, 1e-24))
    z = (eta - mean) / std
    pdf = torch.exp(-0.5 * z * z) * _INV_SQRT_2PI
    cdf = torch.special.ndtr(z)
    return ((eta - mean) * cdf + std * pdf)[..., 0:1].reshape(mean.shape[:-1] + (1,))


class ExpectedImprovement(SingleModelAcquisitionBuilder):
    """Analytic EI with the incumbent eta taken as the minimum posterior mean over the
    observed points."""

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        dataset = _validate_dataset(dataset, "ExpectedImprovement")
        return partial(_ei_fn, predictor(model), _min_posterior_mean(model, dataset))

    def __repr__(self) -> str:
        return "ExpectedImprovement()"

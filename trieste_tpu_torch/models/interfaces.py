"""Probabilistic-model protocols (counterpart of :mod:`trieste_tpu.models.interfaces`):
the two the Bayesian-optimization loop needs. The sampling and ``log`` capabilities wait
for the samplers and a summary writer to be ported."""
from __future__ import annotations

from typing import Any, Protocol, Tuple, runtime_checkable

import torch

from ..data import Dataset


@runtime_checkable
class ProbabilisticModel(Protocol):
    """A probabilistic model."""

    def predict(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Marginal mean and variance at ``query_points [..., D]`` → two ``[..., L]``."""
        raise NotImplementedError


@runtime_checkable
class TrainableProbabilisticModel(ProbabilisticModel, Protocol):
    """A trainable model."""

    def update(self, dataset: Dataset) -> None:
        """Set the model data (no hyperparameter training)."""
        raise NotImplementedError

    def optimize(self, dataset: Dataset) -> Any:
        """Train the model hyperparameters on ``dataset``."""
        raise NotImplementedError

"""Probabilistic-model protocols and the sampler base classes (counterpart of
:mod:`trieste_tpu.models.interfaces`). Acquisition builders ask for intersections of these
capabilities. Random sampling takes an explicit ``torch.Generator`` on the data's device.
The model stacks are not ported yet."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Optional, Protocol, Tuple, runtime_checkable

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


@runtime_checkable
class SupportsPredictJoint(ProbabilisticModel, Protocol):
    """Models with full-covariance predictions."""

    def predict_joint(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[..., B, D]`` → mean ``[..., B, L]``, covariance ``[..., L, B, B]``."""
        raise NotImplementedError


@runtime_checkable
class SupportsPredictY(ProbabilisticModel, Protocol):
    """Models that predict observations, noise included."""

    def predict_y(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError


@runtime_checkable
class SupportsGetKernel(ProbabilisticModel, Protocol):
    def get_kernel(self) -> Any:
        raise NotImplementedError


@runtime_checkable
class SupportsGetObservationNoise(ProbabilisticModel, Protocol):
    def get_observation_noise(self) -> torch.Tensor:
        raise NotImplementedError


@runtime_checkable
class SupportsGetInternalData(ProbabilisticModel, Protocol):
    def get_internal_data(self) -> Dataset:
        raise NotImplementedError


@runtime_checkable
class SupportsGetMeanFunction(ProbabilisticModel, Protocol):
    def get_mean_function(self) -> Callable[[torch.Tensor], torch.Tensor]:
        raise NotImplementedError


@runtime_checkable
class FastUpdateModel(ProbabilisticModel, Protocol):
    """Models with closed-form conditioning on hypothesized ("fantasized") extra data,
    with arbitrary leading batch dims."""

    def conditional_predict_f(
        self, query_points: torch.Tensor, additional_data: Dataset
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def conditional_predict_joint(
        self, query_points: torch.Tensor, additional_data: Dataset
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def conditional_predict_f_sample(
        self,
        generator: Optional[torch.Generator],
        query_points: torch.Tensor,
        additional_data: Dataset,
        num_samples: int,
    ) -> torch.Tensor:
        raise NotImplementedError

    def conditional_predict_y(
        self, query_points: torch.Tensor, additional_data: Dataset
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError


@runtime_checkable
class SupportsCovarianceBetweenPoints(SupportsPredictJoint, Protocol):
    def covariance_between_points(
        self, query_points_1: torch.Tensor, query_points_2: torch.Tensor
    ) -> torch.Tensor:
        raise NotImplementedError


class ReparametrizationSampler(ABC):
    """Repeatable Monte-Carlo sampling by the reparametrization trick: the base normal
    draws are frozen at the first call (or given as ``eps``), so every later call is the
    same deterministic function of its input. An acquisition optimizer's line search
    depends on that."""

    def __init__(
        self, sample_size: int, model: ProbabilisticModel, eps: Optional[torch.Tensor] = None
    ):
        if sample_size <= 0:
            raise ValueError(f"sample_size must be positive, got {sample_size}")
        self._sample_size = sample_size
        self._model = model
        self._eps = eps

    @property
    def sample_size(self) -> int:
        return self._sample_size

    @abstractmethod
    def sample(
        self, at: torch.Tensor, *, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """``at [..., B, D]`` → samples ``[..., S, B, L]``. ``generator`` is read only by
        the call that freezes the base draws."""

    def reset_sampler(self) -> None:
        """Forget the frozen base draws: the next :meth:`sample` redraws."""
        self._eps = None


TrajectoryFunction = Callable[[torch.Tensor], torch.Tensor]
"""A function ``[N, B, D] -> [N, B, L]`` drawn from a model's posterior."""


class TrajectoryFunctionClass(ABC):
    """A trajectory function with state (frozen feature weights)."""

    @abstractmethod
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        ...


class TrajectorySampler(ABC):
    """Draws approximate posterior-sample functions."""

    def __init__(self, model: ProbabilisticModel):
        self._model = model

    @abstractmethod
    def get_trajectory(
        self, generator: Optional[torch.Generator], batch_size: int = 1
    ) -> TrajectoryFunction:
        """Draw a new trajectory function with ``batch_size`` independent columns."""

    def update_trajectory(self, trajectory: TrajectoryFunction) -> TrajectoryFunction:
        """Refresh a trajectory after the model changed (default: keep it)."""
        return trajectory

    def resample_trajectory(
        self, trajectory: TrajectoryFunction, generator: Optional[torch.Generator] = None
    ) -> TrajectoryFunction:
        """Redraw the randomness (default: a new trajectory)."""
        return self.get_trajectory(generator)


@runtime_checkable
class HasTrajectorySampler(ProbabilisticModel, Protocol):
    def trajectory_sampler(self) -> TrajectorySampler:
        raise NotImplementedError


@runtime_checkable
class HasReparamSampler(ProbabilisticModel, Protocol):
    def reparam_sampler(self, num_samples: int) -> ReparametrizationSampler:
        raise NotImplementedError

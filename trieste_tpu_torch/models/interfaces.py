"""Probabilistic-model protocols and the sampler base classes (counterpart of
:mod:`trieste_tpu.models.interfaces`). Acquisition builders ask for intersections of these
capabilities. Random sampling takes an explicit ``torch.Generator`` on the data's device.

A model stack joins independent models, each over its own slice of the outputs, into one
multi-output model: it predicts member by member and concatenates on the last axis."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Optional, Protocol, Sequence, Tuple, runtime_checkable

import torch

from ..data import Dataset
from ..utils.misc import generator_for


@runtime_checkable
class ProbabilisticModel(Protocol):
    """A probabilistic model."""

    def predict(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Marginal mean and variance at ``query_points [..., D]`` → two ``[..., L]``."""
        raise NotImplementedError

    def sample(
        self, generator: Optional[torch.Generator], query_points: torch.Tensor, num_samples: int
    ) -> torch.Tensor:
        """``num_samples`` independent joint samples, ``[..., S, N, L]``."""
        raise NotImplementedError

    def log(self, dataset: Optional[Dataset] = None) -> None:
        """Queue model-specific summaries for the loop's writer."""
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


@runtime_checkable
class SupportsGetInducingVariables(ProbabilisticModel, Protocol):
    """Models with inducing variables (the sparse GPs)."""

    def get_inducing_variables(
        self,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, bool]:
        """``(Z [M, D], q_mu [M, L], q_sqrt [L, M, M], whiten)``."""
        raise NotImplementedError


@runtime_checkable
class SupportsCovarianceWithTopFidelity(ProbabilisticModel, Protocol):
    """Multifidelity models: query points carry a trailing fidelity column."""

    @property
    def num_fidelities(self) -> int:
        raise NotImplementedError

    def covariance_with_top_fidelity(self, query_points: torch.Tensor) -> torch.Tensor:
        """``cov(f_m(x), f_top(x))`` at each ``[x, m]`` row, ``[N, 1]``."""
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


class ModelStack:
    """Independent models over disjoint slices of the outputs, as one multi-output model.
    Each member is given with its event size (its number of outputs)."""

    def __init__(
        self,
        model_with_event_size: Tuple[ProbabilisticModel, int],
        *models_with_event_sizes: Tuple[ProbabilisticModel, int],
    ):
        pairs = [model_with_event_size, *models_with_event_sizes]
        self._models: Sequence[ProbabilisticModel] = [m for m, _ in pairs]
        self._event_sizes: Sequence[int] = [s for _, s in pairs]

    @property
    def models(self) -> Sequence[ProbabilisticModel]:
        return self._models

    @property
    def event_sizes(self) -> Sequence[int]:
        return self._event_sizes

    def predict(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The members' marginal means and variances, concatenated on the last axis."""
        means, vars_ = zip(*[m.predict(query_points) for m in self._models])
        return torch.cat(means, dim=-1), torch.cat(vars_, dim=-1)

    def sample(
        self, generator: Optional[torch.Generator], query_points: torch.Tensor, num_samples: int
    ) -> torch.Tensor:
        """Joint samples ``[..., S, B, L]``; the members draw in order from ``generator``."""
        generator = generator_for(generator, query_points.device)
        return torch.cat(
            [m.sample(generator, query_points, num_samples) for m in self._models], dim=-1
        )

    def log(self, dataset: Optional[Dataset] = None) -> None:
        for m in self._models:
            m.log(dataset)

    def _split_observations(self, observations: torch.Tensor) -> Sequence[torch.Tensor]:
        return torch.split(observations, list(self._event_sizes), dim=-1)


class TrainableModelStack(ModelStack):
    """A stack of trainable models: each member is updated and trained on its own slice of
    the observations, at the query points of the dataset."""

    def _member_datasets(self, dataset: Dataset) -> Sequence[Dataset]:
        qp = dataset.trimmed_query_points
        return [
            Dataset.from_arrays(qp, obs)
            for obs in self._split_observations(dataset.trimmed_observations)
        ]

    def update(self, dataset: Dataset) -> None:
        for m, data in zip(self._models, self._member_datasets(dataset)):
            m.update(data)

    def optimize(self, dataset: Dataset) -> None:
        for m, data in zip(self._models, self._member_datasets(dataset)):
            m.optimize(data)


class PredictJointModelStack(ModelStack):
    """A stack with joint predictions: means concatenate on the last axis, the (block
    diagonal) covariances ``[..., L, B, B]`` on axis −3."""

    def predict_joint(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        means, covs = zip(*[m.predict_joint(query_points) for m in self._models])
        return torch.cat(means, dim=-1), torch.cat(covs, dim=-3)


class PredictYModelStack(ModelStack):
    """A stack that predicts observations, each member with its own noise."""

    def predict_y(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        means, vars_ = zip(*[m.predict_y(query_points) for m in self._models])
        return torch.cat(means, dim=-1), torch.cat(vars_, dim=-1)


class TrainablePredictJointModelStack(TrainableModelStack, PredictJointModelStack):
    """A trainable stack with joint predictions."""


class HasReparamSamplerModelStack(ModelStack):
    """A stack whose members all have reparametrization samplers."""

    def reparam_sampler(self, num_samples: int) -> ReparametrizationSampler:
        from .stacks import StackReparametrizationSampler

        return StackReparametrizationSampler(num_samples, self)

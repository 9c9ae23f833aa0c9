"""Continuous Thompson sampling by trajectory draws (counterpart of
:mod:`trieste_tpu.acquisition.function.continuous_thompson_sampling`): negated posterior
function draws are maximized by the continuous optimizer. The parallel variant is a
vectorized acquisition function, one independent trajectory per slice.

A builder with ``generator=None`` seeds its own generator with 0 on the data's device
when it first prepares a function, and draws every later trajectory from it.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...data import Dataset
from ...models.interfaces import (
    HasTrajectorySampler,
    ProbabilisticModel,
    TrajectoryFunction,
    TrajectorySampler,
)
from ...utils.misc import new_generator
from ..interface import (
    AcquisitionFunction,
    SingleModelGreedyAcquisitionBuilder,
    SingleModelVectorizedAcquisitionBuilder,
)


def negate_trajectory_function(trajectory: TrajectoryFunction) -> AcquisitionFunction:
    """The acquisition function ``x -> -trajectory(x)``."""
    return lambda x: -trajectory(x)


class _TrajectoryBuilder:
    def __init__(self, *, generator: Optional[torch.Generator] = None):
        self._generator = generator

    def _sampler_and_generator(
        self, model: ProbabilisticModel, dataset: Optional[Dataset], who: str
    ):
        if not isinstance(model, HasTrajectorySampler):
            raise ValueError(
                f"{who} only supports models with a trajectory_sampler method; "
                f"received {model!r}"
            )
        if self._generator is None:
            data = dataset if dataset is not None else model.get_internal_data()
            self._generator = new_generator(data.device, 0)
        return model.trajectory_sampler(), self._generator

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class _LazyBatchTrajectory:
    """A negated trajectory whose batch of draws is made at the first call: their number
    V is the slice axis of the input ``[..., V, D]``. Maps to ``[..., V]``."""

    def __init__(self, sampler: TrajectorySampler, generator: torch.Generator):
        self._sampler = sampler
        self._generator = generator
        self._trajectory: Optional[TrajectoryFunction] = None
        self._V: Optional[int] = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        V = x.shape[-2]
        if self._trajectory is None or self._V != V:
            self._trajectory = self._sampler.get_trajectory(self._generator, batch_size=V)
            self._V = V
        return -self._trajectory(x)[..., 0]


class ParallelContinuousThompsonSampling(_TrajectoryBuilder, SingleModelVectorizedAcquisitionBuilder):
    """PCTS: V independent trajectory draws maximized at once as a vectorized acquisition
    function. Every update draws afresh."""

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        return _LazyBatchTrajectory(
            *self._sampler_and_generator(model, dataset, "ParallelContinuousThompsonSampling")
        )


class GreedyContinuousThompsonSampling(_TrajectoryBuilder, SingleModelGreedyAcquisitionBuilder):
    """Greedy CTS: one negated trajectory at a time, drawn afresh for every point of the
    batch (the pending points only trigger the redraw)."""

    def prepare_acquisition_function(
        self,
        model: ProbabilisticModel,
        dataset: Optional[Dataset] = None,
        pending_points: Optional[torch.Tensor] = None,
    ) -> AcquisitionFunction:
        sampler, generator = self._sampler_and_generator(
            model, dataset, "GreedyContinuousThompsonSampling"
        )
        trajectory = sampler.get_trajectory(generator, batch_size=1)

        def negated(x: torch.Tensor) -> torch.Tensor:  # [..., 1, D] -> [..., 1]
            flat = x.reshape(-1, 1, x.shape[-1])
            return -trajectory(flat)[..., 0].reshape(x.shape[:-2] + (1,))

        return negated

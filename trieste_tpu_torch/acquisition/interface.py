"""Acquisition-function interfaces (counterpart of :mod:`trieste_tpu.acquisition.interface`).

An acquisition function maps query points ``[..., B, D]`` to values ``[..., 1]``; here it
is any callable, typically a :func:`functools.partial` of a module-level function bound to
the model's prediction and the incumbent.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Generic, Mapping, Optional, TypeVar

import torch

from ..data import Dataset
from ..models.interfaces import ProbabilisticModel
from ..observer import OBJECTIVE
from ..types import Tag

AcquisitionFunction = Callable[[torch.Tensor], torch.Tensor]
"""Maps ``[..., B, D]`` to ``[..., 1]``."""

ProbabilisticModelType = TypeVar("ProbabilisticModelType", bound=ProbabilisticModel, contravariant=True)


class AcquisitionFunctionBuilder(Generic[ProbabilisticModelType], ABC):
    """Builds and updates acquisition functions over tagged models and datasets."""

    @abstractmethod
    def prepare_acquisition_function(
        self,
        models: Mapping[Tag, ProbabilisticModelType],
        datasets: Optional[Mapping[Tag, Dataset]] = None,
    ) -> AcquisitionFunction:
        """Build an acquisition function from models and data."""

    def update_acquisition_function(
        self,
        function: AcquisitionFunction,
        models: Mapping[Tag, ProbabilisticModelType],
        datasets: Optional[Mapping[Tag, Dataset]] = None,
    ) -> AcquisitionFunction:
        """Refresh an acquisition function after model or data updates (default: rebuild)."""
        return self.prepare_acquisition_function(models, datasets)


class SingleModelAcquisitionBuilder(Generic[ProbabilisticModelType], ABC):
    """Base for acquisitions over a single model and dataset."""

    def using(self, tag: Tag = OBJECTIVE) -> AcquisitionFunctionBuilder:
        """Lift to a tagged :class:`AcquisitionFunctionBuilder`."""
        single = self

        class _Anon(AcquisitionFunctionBuilder):
            def prepare_acquisition_function(self, models, datasets=None):
                return single.prepare_acquisition_function(
                    models[tag], datasets[tag] if datasets is not None else None
                )

            def update_acquisition_function(self, function, models, datasets=None):
                return single.update_acquisition_function(
                    function, models[tag], datasets[tag] if datasets is not None else None
                )

            def __repr__(self) -> str:
                return f"{single!r} using tag {tag!r}"

        return _Anon()

    @abstractmethod
    def prepare_acquisition_function(
        self, model: ProbabilisticModelType, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        ...

    def update_acquisition_function(
        self,
        function: AcquisitionFunction,
        model: ProbabilisticModelType,
        dataset: Optional[Dataset] = None,
    ) -> AcquisitionFunction:
        return self.prepare_acquisition_function(model, dataset)

"""Acquisition rules (the :class:`EfficientGlobalOptimization` part of
:mod:`trieste_tpu.acquisition.rule`, for one query point per step)."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Mapping, Optional, Union

import torch

from ..data import Dataset
from ..models.interfaces import ProbabilisticModel
from ..observer import OBJECTIVE
from ..space import SearchSpace
from ..types import Tag
from .interface import AcquisitionFunction, AcquisitionFunctionBuilder, SingleModelAcquisitionBuilder
from .optimizer import AcquisitionOptimizer, automatic_optimizer_selector


class AcquisitionRule(ABC):
    """The mechanism that chooses the query points of each step."""

    @abstractmethod
    def acquire(
        self,
        search_space: SearchSpace,
        models: Mapping[Tag, ProbabilisticModel],
        datasets: Optional[Mapping[Tag, Dataset]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Return query points ``[B, D]``."""


class EfficientGlobalOptimization(AcquisitionRule):
    """The default rule: build an acquisition function (expected improvement unless
    another builder is given) and maximize it. Only one query point per step is ported."""

    def __init__(
        self,
        builder: Optional[Union[AcquisitionFunctionBuilder, SingleModelAcquisitionBuilder]] = None,
        optimizer: Optional[AcquisitionOptimizer] = None,
        num_query_points: int = 1,
    ):
        if num_query_points != 1:
            raise ValueError(
                f"only one query point per step is supported, got {num_query_points}"
            )
        if builder is None:
            from .function.function import ExpectedImprovement

            builder = ExpectedImprovement()
        if isinstance(builder, SingleModelAcquisitionBuilder):
            builder = builder.using(OBJECTIVE)
        self._builder = builder
        self._optimizer = optimizer or automatic_optimizer_selector
        self._acquisition_function: Optional[AcquisitionFunction] = None

    def acquire(
        self,
        search_space: SearchSpace,
        models: Mapping[Tag, ProbabilisticModel],
        datasets: Optional[Mapping[Tag, Dataset]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if self._acquisition_function is None:
            self._acquisition_function = self._builder.prepare_acquisition_function(
                models, datasets
            )
        else:
            self._acquisition_function = self._builder.update_acquisition_function(
                self._acquisition_function, models, datasets
            )
        return self._optimizer(search_space, self._acquisition_function, generator=generator)

    def __repr__(self) -> str:
        return f"EfficientGlobalOptimization({self._builder!r}, {self._optimizer!r}, 1)"

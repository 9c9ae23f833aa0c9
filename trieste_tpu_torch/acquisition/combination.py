"""Combinations of acquisition functions (counterpart of
:mod:`trieste_tpu.acquisition.combination`): :class:`Sum`, :class:`Product` and
:class:`Map` over the functions that other builders prepare."""
from __future__ import annotations

from functools import partial
from typing import Callable, Mapping, Optional, Sequence

import torch

from ..data import Dataset
from ..models.interfaces import ProbabilisticModel
from ..types import Tag
from .function.function import _product_fn
from .interface import AcquisitionFunction, AcquisitionFunctionBuilder


def _sum_fn(fns: Sequence[Callable], x: torch.Tensor) -> torch.Tensor:
    result = fns[0](x)
    for f in fns[1:]:
        result = result + f(x)
    return result


def _map_fn(wrapper: Callable, fn: Callable, x: torch.Tensor) -> torch.Tensor:
    return wrapper(fn(x))


class Reducer(AcquisitionFunctionBuilder):
    """Combines several builders by reducing the functions they prepare; subclasses say
    how (:meth:`_reduce_fn`)."""

    def __init__(self, *builders: AcquisitionFunctionBuilder):
        if not builders:
            raise TypeError("At least one builder must be specified")
        self._acquisitions = tuple(builders)

    @property
    def acquisitions(self) -> Sequence[AcquisitionFunctionBuilder]:
        return self._acquisitions

    def _reduce_fn(self, fns: Sequence[AcquisitionFunction]) -> AcquisitionFunction:
        raise NotImplementedError

    def prepare_acquisition_function(
        self,
        models: Mapping[Tag, ProbabilisticModel],
        datasets: Optional[Mapping[Tag, Dataset]] = None,
    ) -> AcquisitionFunction:
        return self._reduce_fn(
            tuple(b.prepare_acquisition_function(models, datasets) for b in self._acquisitions)
        )

    def __repr__(self) -> str:
        return f"{type(self).__name__}({', '.join(map(repr, self._acquisitions))})"


class Sum(Reducer):
    """The pointwise sum of the builders' functions."""

    def _reduce_fn(self, fns: Sequence[AcquisitionFunction]) -> AcquisitionFunction:
        return partial(_sum_fn, tuple(fns))


class Product(Reducer):
    """The pointwise product of the builders' functions."""

    def _reduce_fn(self, fns: Sequence[AcquisitionFunction]) -> AcquisitionFunction:
        return partial(_product_fn, tuple(fns))


class Map(Reducer):
    """``wrapper`` applied to the output of one builder's function."""

    def __init__(
        self, wrapper: Callable[[torch.Tensor], torch.Tensor], builder: AcquisitionFunctionBuilder
    ):
        super().__init__(builder)
        self._wrapper = wrapper

    def _reduce_fn(self, fns: Sequence[AcquisitionFunction]) -> AcquisitionFunction:
        return partial(_map_fn, self._wrapper, fns[0])

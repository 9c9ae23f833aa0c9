"""Observer protocol: the bridge between the optimizer and the objective (counterpart of
:mod:`trieste_tpu.observer`).

>>> qp = torch.tensor([[0.0], [1.0], [2.0]])
>>> obs = torch.tensor([[1.0], [float("inf")], [3.0]])
>>> len(filter_finite(qp, obs))
2
"""
from __future__ import annotations

from typing import Callable, Mapping, Union

import torch

from .data import Dataset
from .types import Tag

OBJECTIVE: Tag = "OBJECTIVE"
"""Default tag for the objective data and model."""

SingleObserver = Callable[[torch.Tensor], Dataset]
MultiObserver = Callable[[torch.Tensor], Mapping[Tag, Dataset]]
Observer = Union[SingleObserver, MultiObserver]


def filter_finite(query_points: torch.Tensor, observations: torch.Tensor) -> Dataset:
    """Keep only the rows whose observations are all finite."""
    if observations.ndim != 2 or observations.shape[-1] != 1:
        raise ValueError(f"observations must have shape [N, 1], got {tuple(observations.shape)}")
    if query_points.ndim != 2 or query_points.shape[0] != observations.shape[0]:
        raise ValueError(
            f"query points {tuple(query_points.shape)} do not match observations "
            f"{tuple(observations.shape)}"
        )
    keep = torch.isfinite(observations).all(dim=-1)
    return Dataset.from_arrays(query_points[keep], observations[keep])

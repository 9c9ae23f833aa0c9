"""Observer factories (counterpart of :mod:`trieste_tpu.objectives.utils`)."""
from __future__ import annotations

from typing import Callable, Mapping, Union

import torch

from ..data import Dataset
from ..observer import OBJECTIVE, MultiObserver, Observer, SingleObserver
from ..types import Tag
from ..utils.misc import LocalizedTag


def mk_observer(objective: Callable[[torch.Tensor], torch.Tensor]) -> SingleObserver:
    """Wrap a function ``[N, D] -> [N, L]`` as an observer."""
    return lambda qp: Dataset.from_arrays(qp, objective(qp))


def mk_multi_observer(**kwargs: Callable[[torch.Tensor], torch.Tensor]) -> MultiObserver:
    """An observer of one dataset per keyword, each from its own objective."""
    return lambda qp: {key: Dataset.from_arrays(qp, obj(qp)) for key, obj in kwargs.items()}


def mk_batch_observer(
    objective_or_observer: Union[Callable[[torch.Tensor], torch.Tensor], Observer],
    default_key: Tag = OBJECTIVE,
) -> MultiObserver:
    """An observer of rank-3 query points ``[B, V, D]`` (a batch over V regions): the
    observations of all ``B·V`` points under each tag, and those of region ``v`` under
    ``LocalizedTag(tag, v)``. Rank-2 points are observed as they are."""

    def tagged(qp: torch.Tensor) -> Mapping[Tag, Dataset]:
        result = objective_or_observer(qp)
        if isinstance(result, torch.Tensor):
            result = Dataset.from_arrays(qp, result)
        return result if isinstance(result, Mapping) else {default_key: result}

    def observer(qps: torch.Tensor) -> Mapping[Tag, Dataset]:
        if qps.ndim == 2:
            return tagged(qps)
        if qps.ndim != 3:
            raise ValueError(f"query points must be rank 2 or 3, got shape {tuple(qps.shape)}")
        B, V, D = qps.shape
        out: dict[Tag, Dataset] = {}
        for tag, ds in tagged(qps.reshape(-1, D)).items():
            qp, obs = ds.astuple()
            qp3, obs3 = qp.reshape(B, V, D), obs.reshape(B, V, obs.shape[-1])
            out[tag] = ds
            for v in range(V):
                out[LocalizedTag(tag, v)] = Dataset.from_arrays(qp3[:, v], obs3[:, v])
        return out

    return observer

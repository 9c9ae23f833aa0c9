"""Acquisition utilities (counterpart of :mod:`trieste_tpu.acquisition.utils`), with the
local-dataset helpers of the trust regions."""
from __future__ import annotations

import copy
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import Dataset
from ..observer import OBJECTIVE
from ..types import Tag, TensorType
from ..utils.misc import LocalizedTag


def predictor(model) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """The marginal-prediction callable of ``model``, bound to its current state."""
    return model.predict


def joint_predictor(model) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Like :func:`predictor` for full-covariance predictions."""
    return model.predict_joint


def split_acquisition_function(
    fn: Callable[[torch.Tensor], torch.Tensor], split_size: int
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Wrap ``fn`` to evaluate inputs with a huge leading axis in chunks of ``split_size``
    rows, bounding peak memory."""
    if split_size <= 0:
        raise ValueError(f"split_size must be positive, got {split_size}")

    def wrapped(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] <= split_size:
            return fn(x)
        return torch.cat([fn(chunk) for chunk in torch.split(x, split_size)])

    return wrapped


def split_acquisition_function_calls(optimizer, split_size: int):
    """Wrap an acquisition optimizer so that all its acquisition evaluations are chunked."""

    def wrapped(space, f, generator=None):
        if isinstance(f, tuple):
            fn, v = f
            f = (split_acquisition_function(fn, split_size), v)
        else:
            f = split_acquisition_function(f, split_size)
        return optimizer(space, f, generator=generator)

    return wrapped


def select_nth_output(x: torch.Tensor, output_dim: int = 0) -> torch.Tensor:
    """Select one output dimension of trajectory samples."""
    return x[..., output_dim]


def get_local_dataset(local_space, dataset: Dataset) -> Dataset:
    """The points of ``dataset`` inside ``local_space``, in a dataset of their own."""
    if dataset.dimension != local_space.dimension:
        raise ValueError("dataset and space dimensions do not match")
    qp, obs = dataset.astuple()
    inside = local_space.contains(qp)
    return Dataset.from_arrays(qp[inside], obs[inside])


def copy_to_local_models(
    global_model, num_local_models: int, key: Tag = None
) -> Mapping[Tag, object]:
    """Copies of a model, one per region, under localized tags of ``key`` (default:
    ``OBJECTIVE``)."""
    key = key if key is not None else OBJECTIVE
    return {LocalizedTag(key, i): copy.deepcopy(global_model) for i in range(num_local_models)}


def with_local_datasets(
    datasets: Mapping[Tag, Dataset],
    num_local_datasets: int,
    local_dataset_indices: Optional[Sequence[TensorType]] = None,
) -> dict[Tag, Dataset]:
    """``datasets`` with a local dataset per region for each global tag that has none: a
    copy of the global dataset, or its rows at ``local_dataset_indices[i]``."""
    updated: dict[Tag, Dataset] = dict(datasets)
    for tag in list(datasets):
        ltag = LocalizedTag.from_tag(tag)
        if ltag.is_local:
            continue
        for i in range(num_local_datasets):
            local_tag = LocalizedTag(ltag.global_tag, i)
            if local_tag in updated:
                continue
            if local_dataset_indices is None:
                updated[local_tag] = datasets[tag]
            else:
                qp, obs = datasets[tag].astuple()
                idx = torch.as_tensor(local_dataset_indices[i], device=qp.device).long()
                updated[local_tag] = Dataset.from_arrays(qp[idx], obs[idx])
    return updated


def get_unique_points_mask(points: torch.Tensor, tolerance: float = 1e-6) -> torch.Tensor:
    """Greedy deduplication: mark the points farther than ``tolerance`` from every
    earlier kept point. ``[N, D] -> [N]`` bool. The scan runs on the host."""
    distances = torch.linalg.norm(points[:, None, :] - points[None, :, :], dim=-1)
    near = (distances <= tolerance).cpu().numpy()
    kept = np.zeros(points.shape[0], bool)
    for i in range(points.shape[0]):
        kept[i] = not np.any(near[i, :i] & kept[:i])
    return torch.as_tensor(kept, device=points.device)

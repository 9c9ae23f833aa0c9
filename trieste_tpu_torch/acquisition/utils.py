"""Acquisition utilities (counterpart of :mod:`trieste_tpu.acquisition.utils`). The
local-dataset helpers wait for the trust regions."""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


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


def get_unique_points_mask(points: torch.Tensor, tolerance: float = 1e-6) -> torch.Tensor:
    """Greedy deduplication: mark the points farther than ``tolerance`` from every
    earlier kept point. ``[N, D] -> [N]`` bool. The scan runs on the host."""
    distances = torch.linalg.norm(points[:, None, :] - points[None, :, :], dim=-1)
    near = (distances <= tolerance).cpu().numpy()
    kept = np.zeros(points.shape[0], bool)
    for i in range(points.shape[0]):
        kept[i] = not np.any(near[i, :i] & kept[:i])
    return torch.as_tensor(kept, device=points.device)

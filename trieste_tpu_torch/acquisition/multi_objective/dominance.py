"""Pareto dominance (counterpart of :mod:`trieste_tpu.acquisition.multi_objective.dominance`):
one vectorized O(N²) comparison on the observations' device, no loop.

>>> obs = torch.tensor([[0.0, 2.0], [1.0, 1.0], [2.0, 2.0]])
>>> non_dominated_mask(obs).tolist()
[True, True, False]
"""
from __future__ import annotations

from typing import Tuple

import torch


def non_dominated(observations: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The non-dominated rows of ``observations [N, M]`` (minimization) and the boolean
    ``[N]`` mask that picks them."""
    mask = non_dominated_mask(observations)
    return observations[mask], mask


def non_dominated_mask(observations: torch.Tensor) -> torch.Tensor:
    """``[N]``: row ``i`` is dominated when some row ``j`` is no worse in every objective
    and better in one."""
    obs = observations
    leq = torch.all(obs[None, :, :] <= obs[:, None, :], dim=-1)  # [i, j]
    lt = torch.any(obs[None, :, :] < obs[:, None, :], dim=-1)
    return ~torch.any(leq & lt, dim=1)

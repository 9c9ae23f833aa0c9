"""Box decompositions of the region that a Pareto front does not dominate (counterpart of
:mod:`trieste_tpu.acquisition.multi_objective.partition`).

The general decomposition is box subtraction: start from the one cell
``[anti_reference, reference]`` (``-inf`` below by default) and subtract each front
point's dominated box ``[p, reference]``; a box subtracted from a cell leaves at most M
disjoint boxes (a staircase). Two objectives have an exact partition by sorting the
front. Fronts are small, so the cells are computed on the host in numpy float64, in the
JAX package's order, and the bounds ``(lower [K, M], upper [K, M])`` move to the front's
device and dtype once.

>>> lower, upper = non_dominated_partition_bounds(
...     torch.tensor([3.0, 3.0]), torch.tensor([[1.0, 2.0], [2.0, 1.0]]))
>>> lower.tolist()
[[-inf, -inf], [1.0, -inf], [2.0, -inf]]
>>> upper.tolist()
[[1.0, 3.0], [2.0, 2.0], [3.0, 1.0]]
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .dominance import non_dominated


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _on_device_of(like, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """``arrays`` as tensors with the dtype and device of ``like`` (float64 on the CPU if
    it is not a tensor)."""
    if isinstance(like, torch.Tensor):
        dtype, device = like.dtype, like.device
    else:
        dtype, device = torch.float64, torch.device("cpu")
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in arrays)


def _subtract_dominated_box(
    cells: list[tuple[np.ndarray, np.ndarray]], point: np.ndarray
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Remove the region ``[point, +inf)`` from every cell, keeping disjoint boxes."""
    out: list[tuple[np.ndarray, np.ndarray]] = []
    M = point.shape[0]
    for lower, upper in cells:
        a = np.maximum(lower, point)
        if np.any(a >= upper):
            out.append((lower, upper))  # no intersection with the dominated box
            continue
        # staircase split: for each dim j keep the slab below a_j, with dims < j clamped
        for j in range(M):
            if a[j] <= lower[j]:
                continue
            lo = lower.copy()
            hi = upper.copy()
            lo[:j] = a[:j]
            hi[j] = a[j]
            if np.all(lo < hi):
                out.append((lo, hi))
    return out


def _non_dominated_cells(
    ref: np.ndarray, fr: np.ndarray, anti: Optional[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray]:
    M = ref.shape[-1]
    anti = np.full(M, -np.inf) if anti is None else anti
    if fr.size and np.any(fr > ref):
        raise ValueError(
            f"reference point {ref} must dominate every front point; got front max "
            f"{fr.max(0)}"
        )
    cells = [(anti.copy(), ref.copy())]
    for p in fr:
        cells = _subtract_dominated_box(cells, p)
    if not cells:
        return np.zeros((0, M)), np.zeros((0, M))
    return np.stack([c[0] for c in cells]), np.stack([c[1] for c in cells])


def non_dominated_partition_bounds(
    reference: torch.Tensor,
    front: torch.Tensor,
    anti_reference: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Disjoint cells ``(lower [K, M], upper [K, M])`` covering the region not dominated
    by ``front``, bounded above by ``reference`` (minimization). Lower bounds are
    ``-inf`` (or ``anti_reference``) where unbounded."""
    fr = np.atleast_2d(_host(front))
    anti = None if anti_reference is None else _host(anti_reference)
    lower, upper = _non_dominated_cells(_host(reference), fr, anti)
    return _on_device_of(front, lower, upper)


def prepare_default_non_dominated_partition_bounds(
    reference: torch.Tensor,
    observations: Optional[torch.Tensor] = None,
    anti_reference: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The default partition of the non-dominated region: exact for two objectives, box
    subtraction otherwise; one cell ``[anti_reference, reference]`` without observations."""
    M = reference.shape[-1]
    if observations is None or observations.numel() == 0:
        anti = np.full(M, -np.inf) if anti_reference is None else _host(anti_reference)
        return _on_device_of(reference, anti[None], _host(reference)[None])
    front, _ = non_dominated(observations)
    if M == 2:
        anti = torch.full((2,), -torch.inf) if anti_reference is None else anti_reference
        return ExactPartition2dNonDominated(front).partition_bounds(anti, reference)
    return non_dominated_partition_bounds(reference, front, anti_reference)


class ExactPartition2dNonDominated:
    """The exact partition of two objectives, by sorting the front on the first."""

    def __init__(self, front: torch.Tensor):
        self._like = front
        fr = np.atleast_2d(_host(front))
        if fr.shape[-1] != 2:
            raise ValueError(
                f"ExactPartition2dNonDominated requires 2 objectives, got {fr.shape[-1]}"
            )
        self.front = fr[np.argsort(fr[:, 0])]

    def partition_bounds(
        self, anti_reference: torch.Tensor, reference: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        anti, ref, fr = _host(anti_reference), _host(reference), self.front
        N = fr.shape[0]
        # staircase cells, left to right: x-bounds between consecutive front x's
        first = np.concatenate([[anti[0]], fr[:, 0]])
        second = np.concatenate([fr[:, 0], [ref[0]]])
        y_upper = np.concatenate([[ref[1]], np.minimum.accumulate(fr[:, 1])])
        lower = np.stack([first, np.full(N + 1, anti[1])], axis=-1)
        upper = np.stack([second, y_upper], axis=-1)
        keep = np.all(lower < upper, axis=-1)
        return _on_device_of(self._like, lower[keep], upper[keep])


class DividedAndConquerNonDominated:
    """A disjoint decomposition for any number of objectives (box subtraction)."""

    def __init__(self, front: torch.Tensor, threshold: int = 0):
        self.front = torch.atleast_2d(front)

    def partition_bounds(
        self, anti_reference: torch.Tensor, reference: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return non_dominated_partition_bounds(reference, self.front, anti_reference)

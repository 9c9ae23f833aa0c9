"""The Pareto front and its hypervolume (counterpart of
:mod:`trieste_tpu.acquisition.multi_objective.pareto`): :class:`Pareto` with the
hypervolume indicator over the cell partition and a Sharpe-ratio diverse subset, and the
default reference point.

The diverse subset solves a quadratic program over the probability simplex by 500 steps
of projected gradient descent. The front is host data and the program is tiny, so it runs
in float64 on the CPU: 500 launches on the card would cost more than the work.

>>> observations = torch.tensor([[0.0, 2.0], [1.0, 1.0], [2.0, 0.0], [2.0, 2.0]])
>>> tuple(Pareto(observations).front.shape)  # [2, 2] is dominated
(3, 2)
>>> float(Pareto(observations).hypervolume_indicator(torch.tensor([3.0, 3.0])))
6.0
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .dominance import non_dominated
from .partition import non_dominated_partition_bounds

QP_STEPS = 500
"""Projected-gradient steps of the diverse subset's quadratic program."""


class Pareto:
    """A Pareto front of observed points ``[N, M]`` (minimization)."""

    def __init__(self, observations: torch.Tensor, already_non_dominated: bool = False):
        obs = torch.atleast_2d(torch.as_tensor(observations))
        if not already_non_dominated:
            obs, _ = non_dominated(obs)
        self.front = obs

    def hypervolume_indicator(self, reference: torch.Tensor) -> torch.Tensor:
        """The hypervolume that the front dominates below ``reference``: the box from the
        ideal point to the reference, less the non-dominated cells clipped to it."""
        front = self.front
        ref = torch.as_tensor(reference, dtype=front.dtype, device=front.device)
        if front.shape[0] == 0:
            raise ValueError("empty front")
        if bool(torch.any(torch.max(front, dim=0).values > ref)):
            raise ValueError("reference point must dominate the whole front")
        ideal = torch.min(front, dim=0).values
        lower, upper = non_dominated_partition_bounds(ref, front, anti_reference=ideal)
        total = torch.prod(ref - ideal)
        if lower.shape[0] == 0:
            return total
        cell_vols = torch.prod(
            torch.clamp_min(upper - torch.maximum(lower, ideal), 0.0), dim=-1
        )
        return total - torch.sum(cell_vols)

    def sample_diverse_subset(
        self,
        sample_size: int,
        allow_repeats: bool = True,
        bounds_delta_scale_factor: float = 0.2,
        bounds_min_delta: float = 1e-9,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A subset of the front of ``sample_size`` points, each front point taken in
        proportion to its weight in the portfolio of largest Sharpe ratio
        ``pᵀw / sqrt(wᵀQw)`` over the simplex. ``p`` is each point's probability of
        dominating a uniform point of the front's padded bounding box and ``Q`` the
        covariance of those events. Returns the points and each front point's count."""
        front = self.front.detach().cpu().numpy().astype(np.float64)
        n = front.shape[0]
        if sample_size <= 0:
            raise ValueError(f"sample_size must be positive, got {sample_size}")
        if not allow_repeats and sample_size > n:
            raise ValueError(
                f"cannot sample {sample_size} distinct points from a front of size {n}"
            )
        lo = front.min(axis=0)
        hi = front.max(axis=0)
        delta = np.maximum((hi - lo) * bounds_delta_scale_factor, bounds_min_delta)
        lower, upper = lo - delta, hi + delta
        p = np.prod((upper - front) / (upper - lower), axis=-1)  # [n]
        both = np.maximum(front[:, None, :], front[None, :, :])
        P = np.prod((upper - both) / (upper - lower), axis=-1)  # [n, n]
        Q = P - np.outer(p, p) + 1e-9 * np.eye(n)
        w = _sharpe_weights(torch.as_tensor(Q), torch.as_tensor(p)).numpy()

        scaled = w * sample_size
        counts = np.floor(scaled).astype(int)
        if not allow_repeats:
            counts = np.minimum(counts, 1)
        # the remainder goes out by the largest fractional parts
        remainder = sample_size - counts.sum()
        order = np.argsort(-(scaled - np.floor(scaled)))
        i = 0
        while remainder > 0 and i < len(order):
            idx = order[i]
            if allow_repeats or counts[idx] == 0:
                counts[idx] += 1
                remainder -= 1
            i += 1
            if i == len(order) and remainder > 0 and allow_repeats:
                i = 0
        samples = np.repeat(front, counts, axis=0)
        like = self.front
        return (torch.as_tensor(samples, dtype=like.dtype, device=like.device),
                torch.as_tensor(counts, device=like.device))


def _sharpe_weights(Q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The simplex weights of largest ``pᵀw / sqrt(wᵀQw)``, by the equivalent program
    ``min yᵀQy`` subject to ``pᵀy = 1, y >= 0`` and ``w = y / sum(y)``: projected
    gradient steps of ``0.5 / ||Q||₂``, each projection a clip and a rescale."""

    def project(y: torch.Tensor) -> torch.Tensor:
        y = torch.clamp_min(y, 0.0)
        return y / torch.clamp_min(torch.dot(p, y), 1e-12)

    step = 0.5 / (torch.linalg.matrix_norm(Q, ord=2) + 1e-9)
    y = project(torch.ones_like(p))
    for _ in range(QP_STEPS):
        y = project(y - step * (2.0 * (Q @ y)))
    return y / torch.clamp_min(torch.sum(y), 1e-12)


def get_reference_point(observations: torch.Tensor) -> torch.Tensor:
    """The default reference point: the front's worst point, pushed out by twice the
    front's extent over its size."""
    obs = torch.atleast_2d(observations)
    if obs.shape[0] == 0:
        raise ValueError("empty observations")
    front, _ = non_dominated(obs)
    worst = torch.max(front, dim=0).values
    ideal = torch.min(front, dim=0).values
    return worst + 2.0 * (worst - ideal) / max(front.shape[0], 1)

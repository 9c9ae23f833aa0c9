"""A compact NSGA-II multi-objective genetic optimizer (counterpart of
:mod:`trieste_tpu.acquisition.multi_objective.nsga2`): fast non-dominated sorting with
crowding-distance selection, SBX crossover and polynomial mutation, in numpy on the host.
Each generation's population goes through the objective in one batch, so the expensive
part (a model's predictions over the population) runs where the model lives. Its default
``np.random.default_rng(0)`` makes it deterministic.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def _fast_non_dominated_ranks(F: np.ndarray) -> np.ndarray:
    """Pareto rank per row of ``F [N, M]`` (0 = non-dominated)."""
    N = F.shape[0]
    leq = np.all(F[None, :, :] <= F[:, None, :], axis=-1)
    lt = np.any(F[None, :, :] < F[:, None, :], axis=-1)
    dominates = leq & lt  # [i, j]: j dominates i
    ranks = np.full(N, -1)
    remaining = np.ones(N, bool)
    rank = 0
    while remaining.any():
        dominated_counts = (dominates & remaining[:, None]).sum(axis=1)
        front = remaining & (dominated_counts == 0)
        if not front.any():  # numerical safety
            front = remaining
        ranks[front] = rank
        remaining &= ~front
        rank += 1
    return ranks


def _crowding_distance(F: np.ndarray) -> np.ndarray:
    N, M = F.shape
    dist = np.zeros(N)
    for m in range(M):
        order = np.argsort(F[:, m])
        span = F[order[-1], m] - F[order[0], m]
        dist[order[0]] = dist[order[-1]] = np.inf
        if span > 0 and N > 2:
            dist[order[1:-1]] += (F[order[2:], m] - F[order[:-2], m]) / span
    return dist


def nsga2(
    objective: Callable[[np.ndarray], np.ndarray],
    lower: np.ndarray,
    upper: np.ndarray,
    *,
    population_size: int = 100,
    num_generations: int = 50,
    crossover_eta: float = 15.0,
    mutation_eta: float = 20.0,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Minimize a vector objective ``[N, D] -> [N, M]`` over a box. Returns the final
    population's non-dominated set: ``(points [K, D], values [K, M])``."""
    rng = rng or np.random.default_rng(0)
    D = lower.shape[0]
    P = population_size
    X = lower + rng.random((P, D)) * (upper - lower)
    F = np.asarray(objective(X))

    def tournament(ranks, crowd):
        a, b = rng.integers(0, P, 2)
        if ranks[a] < ranks[b]:
            return a
        if ranks[b] < ranks[a]:
            return b
        return a if crowd[a] > crowd[b] else b

    for _ in range(num_generations):
        ranks = _fast_non_dominated_ranks(F)
        crowd = _crowding_distance(F)
        # offspring by SBX crossover, then polynomial mutation
        children = np.empty_like(X)
        for i in range(0, P, 2):
            p1, p2 = X[tournament(ranks, crowd)], X[tournament(ranks, crowd)]
            u = rng.random(D)
            beta = np.where(
                u <= 0.5,
                (2 * u) ** (1.0 / (crossover_eta + 1)),
                (1.0 / (2 * (1 - u))) ** (1.0 / (crossover_eta + 1)),
            )
            c1 = 0.5 * ((1 + beta) * p1 + (1 - beta) * p2)
            c2 = 0.5 * ((1 - beta) * p1 + (1 + beta) * p2)
            children[i] = c1
            if i + 1 < P:
                children[i + 1] = c2
        # each gene mutates with probability 1/D
        mutate = rng.random((P, D)) < 1.0 / D
        u = rng.random((P, D))
        delta = np.where(
            u < 0.5,
            (2 * u) ** (1.0 / (mutation_eta + 1)) - 1.0,
            1.0 - (2 * (1 - u)) ** (1.0 / (mutation_eta + 1)),
        )
        children = np.where(mutate, children + delta * (upper - lower), children)
        children = np.clip(children, lower, upper)
        CF = np.asarray(objective(children))
        # environmental selection from the parents and children together
        allX = np.concatenate([X, children])
        allF = np.concatenate([F, CF])
        ranks = _fast_non_dominated_ranks(allF)
        crowd = _crowding_distance(allF)
        keep = np.lexsort((-crowd, ranks))[:P]
        X, F = allX[keep], allF[keep]

    mask = _fast_non_dominated_ranks(F) == 0
    return X[mask], F[mask]

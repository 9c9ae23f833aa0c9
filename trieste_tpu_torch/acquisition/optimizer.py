"""Acquisition-function optimizers (counterpart of :mod:`trieste_tpu.acquisition.optimizer`).

The continuous optimizer scores a seed pool of ``max(5000, 1000·D)`` points (the fused
prediction kernel serves this on the card), starts ``10·D`` projected L-BFGS runs from the
best seeds, runs them in lockstep, and returns the best of the runs and the seeds, so it
never does worse than random search. If no finite value is found, fresh seeds are tried
up to ``num_recovery_runs`` times before :class:`FailedOptimizationError`.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..logging import deferred_scalar, scalar
from ..ops.lbfgs import minimize_lbfgs
from ..space import Box, SearchSpace
from .interface import AcquisitionFunction

NUM_SAMPLES_MIN = 5000
"""Minimum number of initial candidate samples."""

NUM_SAMPLES_DIM = 1000
"""Initial candidate samples per input dimension."""

NUM_RUNS_DIM = 10
"""L-BFGS runs per input dimension."""

MAX_ITERS = 60
"""Iterations of each L-BFGS run."""

AcquisitionOptimizer = Callable[..., torch.Tensor]
"""Maximizes an acquisition function over a space, returning ``[1, D]``."""


class FailedOptimizationError(Exception):
    """Raised when the acquisition function is non-finite over every seed and run."""


def automatic_optimizer_selector(
    space: SearchSpace, f: AcquisitionFunction, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """The default optimizer for the space: the continuous optimizer for a :class:`Box`."""
    if not isinstance(space, Box):
        raise NotImplementedError(f"no optimizer is ported for {type(space).__name__}")
    return generate_continuous_optimizer()(space, f, generator=generator)


def _optimize_continuous_core(
    acq: Callable[[torch.Tensor], torch.Tensor],
    seeds: torch.Tensor,  # [N, V, D]
    lower: torch.Tensor,  # [V, D]
    upper: torch.Tensor,  # [V, D]
    num_runs: int,
    max_iters: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Seed scoring → top-k starts → lockstep multi-start L-BFGS → winner per slice over
    runs and seeds. ``acq`` maps ``[..., V, D] -> [..., V]``. Returns ``(points [V, D],
    values [V], improvement over the best seed [V])``."""
    N, V, D = seeds.shape
    with torch.no_grad():
        seed_vals = acq(seeds)  # [N, V]
    seed_vals = torch.where(torch.isfinite(seed_vals), seed_vals, -torch.inf)
    top_vals, top_idx = torch.topk(seed_vals.T, num_runs, dim=-1)  # [V, R]
    # starts[r] holds, for every slice v, that slice's r-th best seed
    starts = torch.gather(seeds.transpose(0, 1), 1, top_idx[..., None].expand(V, num_runs, D))
    starts = starts.transpose(0, 1)  # [R, V, D]

    # slices share the line search on their sum, so scale each by its best seed value
    # (equal to 1 when V == 1); no slice's argmax changes and gradients stay separate
    magnitudes = torch.abs(top_vals[:, 0])
    ref_mag = torch.max(magnitudes)
    slice_scale = torch.clamp(
        ref_mag / torch.maximum(magnitudes, 1e-12 * torch.clamp_min(ref_mag, 1e-300)), 1.0, 1e6
    )

    def neg_sum_acq(xflat: torch.Tensor) -> torch.Tensor:  # [R, V*D] -> [R]
        x = xflat.reshape(-1, V, D)
        return -torch.sum(acq(x) * slice_scale, dim=-1)

    res = minimize_lbfgs(
        neg_sum_acq, starts.reshape(num_runs, V * D), lower=lower.reshape(-1),
        upper=upper.reshape(-1), max_iters=max_iters,
    )
    opt_points = res.x.reshape(num_runs, V, D)
    with torch.no_grad():
        opt_vals = acq(opt_points)  # [R, V]
    opt_vals = torch.where(torch.isfinite(opt_vals), opt_vals, -torch.inf)

    slices = torch.arange(V, device=seeds.device)
    best_run = torch.argmax(opt_vals, dim=0)  # [V]
    run_pts = opt_points[best_run, slices]
    run_best = opt_vals[best_run, slices]
    seed_best_idx = torch.argmax(seed_vals, dim=0)
    seed_pts = seeds[seed_best_idx, slices]
    seed_best = seed_vals[seed_best_idx, slices]
    use_run = run_best >= seed_best
    points = torch.where(use_run[:, None], run_pts, seed_pts)
    values = torch.where(use_run, run_best, seed_best)
    return points, values, values - seed_best


def generate_continuous_optimizer(
    num_initial_samples: Optional[int] = None,
    num_optimization_runs: Optional[int] = None,
    num_recovery_runs: int = 10,
) -> AcquisitionOptimizer:
    """The default continuous optimizer. ``num_initial_samples`` defaults to
    ``max(5000, 1000·D)`` and ``num_optimization_runs`` to ``10·D``, per space at call
    time."""

    def optimize_continuous(
        space: Box, f: AcquisitionFunction, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        if generator is None:
            generator = torch.Generator(device=space.device).manual_seed(
                int(np.random.randint(2**31))
            )
        D = space.dimension
        N = num_initial_samples or max(NUM_SAMPLES_MIN, NUM_SAMPLES_DIM * D)
        R = min(num_optimization_runs or NUM_RUNS_DIM * D, N)
        lower, upper = space.lower[None], space.upper[None]

        def acq(x: torch.Tensor) -> torch.Tensor:  # [..., 1, D] -> [..., 1]
            return f(x).reshape(x.shape[:-2] + (1,))

        points, values, improvement = _optimize_continuous_core(
            acq, space.sample(generator, N)[:, None, :], lower, upper, R, MAX_ITERS
        )
        scalar("spo_af_evaluations", N + R * MAX_ITERS)
        deferred_scalar("spo_improvement_on_initial_samples", lambda: float(improvement.sum()))

        # recovery runs: retry with fresh seeds while no finite value was found
        recoveries = 0
        while not bool(torch.isfinite(values).all()):
            if recoveries >= num_recovery_runs:
                raise FailedOptimizationError(
                    "acquisition function returned no finite values over seeds and "
                    f"runs after {recoveries} recovery run(s)"
                )
            recoveries += 1
            new_points, new_values, _ = _optimize_continuous_core(
                acq, space.sample(generator, N)[:, None, :], lower, upper, R, MAX_ITERS
            )
            replace = ~torch.isfinite(values) & torch.isfinite(new_values)
            points = torch.where(replace[:, None], new_points, points)
            values = torch.where(replace, new_values, values)
        if recoveries:
            scalar("spo_recovery_runs", recoveries)
        return points

    return optimize_continuous

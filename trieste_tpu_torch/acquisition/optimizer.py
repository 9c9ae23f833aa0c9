"""Acquisition-function optimizers (counterpart of :mod:`trieste_tpu.acquisition.optimizer`).

The continuous optimizer scores a seed pool of ``max(5000, 1000·D)`` points (the fused
prediction kernel serves this on the card), starts ``10·D`` projected L-BFGS runs from the
best seeds, runs them in lockstep, and returns the best of the runs and the seeds, so it
never does worse than random search. If no finite value is found, fresh seeds are tried
up to ``num_recovery_runs`` times before :class:`FailedOptimizationError`.

Over a :class:`TaggedMultiSearchSpace` (a trust-region fleet) each slice draws its seeds
and keeps its bounds in its own region. Over a space with discrete parts (a tagged
product) the optimization is relaxed: each run keeps the discrete coordinates of its
start, frozen by bounds of zero width that differ from run to run. Over a box with
constraints the seeds are feasible samples, an infeasible seed or run never wins, and the
runs minimize the acquisition with an exact-penalty term ``weight · Σ relu(−r)²`` on the
constraints' residuals ``r``. A discrete space is searched exhaustively.

>>> from trieste_tpu_torch.space import DiscreteSearchSpace
>>> space = DiscreteSearchSpace(torch.tensor([[0.0], [1.0], [2.0]]))
>>> acq = lambda x: -torch.sum((x[..., 0, :] - 1.9) ** 2, dim=-1, keepdim=True)
>>> optimize_discrete(space, acq).tolist()
[[2.0]]
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from ..logging import deferred_scalar, scalar
from ..ops.lbfgs import minimize_lbfgs
from ..space import (
    GeneralDiscreteSearchSpace,
    SearchSpace,
    TaggedMultiSearchSpace,
    TaggedProductSearchSpace,
)
from ..utils.misc import generator_for
from .interface import AcquisitionFunction

NUM_SAMPLES_MIN = 5000
"""Minimum number of initial candidate samples."""

NUM_SAMPLES_DIM = 1000
"""Initial candidate samples per input dimension."""

NUM_RUNS_DIM = 10
"""L-BFGS runs per input dimension."""

MAX_ITERS = 60
"""Iterations of each L-BFGS run, unless ``optimizer_args`` gives ``max_iters``."""

AcquisitionOptimizer = Callable[..., torch.Tensor]
"""Maximizes an acquisition function (or a ``(function, V)`` vectorized pair) over a
space, returning ``[V, D]``."""

Vectorizable = Union[AcquisitionFunction, Tuple[AcquisitionFunction, int]]


class FailedOptimizationError(Exception):
    """Raised when the acquisition function is non-finite over every seed and run."""


def automatic_optimizer_selector(
    space: SearchSpace, f: Vectorizable, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """The default optimizer for the space: exhaustive search over a discrete space, the
    continuous optimizer (relaxed where parts are discrete) over any other."""
    if isinstance(space, GeneralDiscreteSearchSpace):
        return optimize_discrete(space, f)
    return generate_continuous_optimizer()(space, f, generator=generator)


def optimize_discrete(
    space: GeneralDiscreteSearchSpace, f: Vectorizable, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Exhaustive maximization over the points of a discrete space, each slice of a
    vectorized function on its own: ``[V, D]``."""
    fn, V = f if isinstance(f, tuple) else (f, 1)
    points = space.points  # [N, D]
    with torch.no_grad():
        vals = fn(points[:, None, :].expand(points.shape[0], V, points.shape[1]))
    best = torch.argmax(vals.reshape(points.shape[0], V), dim=0)  # [V]
    return points[best]


def _as_vectorized(f: Vectorizable) -> Tuple[Callable[[torch.Tensor], torch.Tensor], int]:
    """Normalize to a vectorized function ``[..., V, D] -> [..., V]`` and V."""
    if isinstance(f, tuple):
        fn, V = f
        return (lambda x: fn(x).reshape(x.shape[:-1])), V
    return (lambda x: f(x).reshape(x.shape[:-2] + (1,))), 1


def _space_bounds_and_discrete_mask(
    space: SearchSpace,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(lower [D], upper [D], discrete_mask [D])`` for the relaxed optimization: the
    dimensions of discrete (sub)spaces are masked, and each run keeps their seeded value."""
    mask = torch.zeros(space.dimension, dtype=torch.bool)
    if isinstance(space, GeneralDiscreteSearchSpace):
        mask[:] = True
    elif isinstance(space, TaggedProductSearchSpace):
        for tag in space.subspace_tags:
            if isinstance(space.get_subspace(tag), GeneralDiscreteSearchSpace):
                lo, hi = space.subspace_dimension_range(tag)
                mask[lo:hi] = True
    return space.lower, space.upper, mask.to(space.device)


def _feasible(residual_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return torch.all(residual_fn(x) >= -1e-7, dim=-1)


def _optimize_continuous_core(
    acq: Callable[[torch.Tensor], torch.Tensor],
    seeds: torch.Tensor,  # [N, V, D]
    lower: torch.Tensor,  # [V, D]
    upper: torch.Tensor,  # [V, D]
    num_runs: int,
    max_iters: int,
    discrete_mask: Optional[torch.Tensor] = None,  # [D] bool
    residual_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Seed scoring → top-k starts → lockstep multi-start L-BFGS → winner per slice over
    runs and seeds. ``acq`` maps ``[..., V, D] -> [..., V]``. The dimensions under
    ``discrete_mask`` keep each run's start: their bounds collapse to it, run by run.
    ``residual_fn`` (``[..., D] -> [..., n_res]``, feasible iff every residual is >= 0)
    makes the search constraint-aware: infeasible seeds and runs score ``-inf`` and the
    runs carry the exact penalty. Returns ``(points [V, D], values [V], improvement over
    the best seed [V])``."""
    N, V, D = seeds.shape
    with torch.no_grad():
        seed_vals = acq(seeds)  # [N, V]
        seed_vals = torch.where(torch.isfinite(seed_vals), seed_vals, -torch.inf)
        if residual_fn is not None:
            seed_vals = torch.where(_feasible(residual_fn, seeds), seed_vals, -torch.inf)
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
    # large against the scaled acquisition, so that a violation always loses, and finite,
    # so that the gradient pulls a violating run back inside
    penalty_weight = 100.0 * (1.0 + magnitudes * slice_scale)  # [V]

    def neg_sum_acq(xflat: torch.Tensor) -> torch.Tensor:  # [R, V*D] -> [R]
        x = xflat.reshape(-1, V, D)
        value = torch.sum(acq(x) * slice_scale, dim=-1)
        if residual_fn is not None:
            violation = torch.square(torch.relu(-residual_fn(x))).sum(dim=-1)  # [R, V]
            value = value - torch.sum(penalty_weight * violation, dim=-1)
        return -value

    if discrete_mask is None:
        discrete_mask = torch.zeros(D, dtype=torch.bool, device=seeds.device)
    run_lower = torch.where(discrete_mask, starts, lower).reshape(num_runs, V * D)
    run_upper = torch.where(discrete_mask, starts, upper).reshape(num_runs, V * D)
    res = minimize_lbfgs(
        neg_sum_acq, starts.reshape(num_runs, V * D), lower=run_lower, upper=run_upper,
        max_iters=max_iters,
    )
    opt_points = res.x.reshape(num_runs, V, D)
    with torch.no_grad():
        opt_vals = acq(opt_points)  # [R, V]
        opt_vals = torch.where(torch.isfinite(opt_vals), opt_vals, -torch.inf)
        if residual_fn is not None:
            opt_vals = torch.where(_feasible(residual_fn, opt_points), opt_vals, -torch.inf)

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
    optimizer_args: Optional[dict] = None,
) -> AcquisitionOptimizer:
    """The default continuous optimizer. ``num_initial_samples`` defaults to
    ``max(5000, 1000·D)`` and ``num_optimization_runs`` to ``10·D``, per space at call
    time; ``optimizer_args["max_iters"]`` sets the iterations of each run (default
    :data:`MAX_ITERS`)."""
    max_iters = (optimizer_args or {}).get("max_iters", MAX_ITERS)

    def optimize_continuous(
        space: SearchSpace, f: Vectorizable, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        generator = generator_for(generator, space.device)
        acq, V = _as_vectorized(f)
        D = space.dimension
        N = num_initial_samples or max(NUM_SAMPLES_MIN, NUM_SAMPLES_DIM * D)
        R = min(num_optimization_runs or NUM_RUNS_DIM * D, N)

        if isinstance(space, TaggedMultiSearchSpace):
            # each slice searches its own region; V may repeat the regions
            if V % space.num_subspaces != 0:
                raise ValueError(
                    f"The vectorization of the target function {V} must be a multiple of "
                    f"the number of subspaces {space.num_subspaces}"
                )
            repeats = V // space.num_subspaces
            lower, upper = space.lower.repeat(repeats, 1), space.upper.repeat(repeats, 1)
            discrete_mask = None

            def make_seeds() -> torch.Tensor:
                return space.sample(generator, N).repeat(1, repeats, 1)  # [N, V, D]

        else:
            lower_d, upper_d, discrete_mask = _space_bounds_and_discrete_mask(space)
            lower, upper = lower_d.expand(V, D), upper_d.expand(V, D)
            draw = space.sample_feasible if space.has_constraints else space.sample

            def make_seeds() -> torch.Tensor:  # every slice starts from the same pool
                return draw(generator, N)[:, None, :].expand(N, V, D)

        residual_fn = space.constraints_residuals if space.has_constraints else None
        points, values, improvement = _optimize_continuous_core(
            acq, make_seeds(), lower, upper, R, max_iters, discrete_mask, residual_fn
        )
        scalar("spo_af_evaluations", N + R * max_iters)
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
                acq, make_seeds(), lower, upper, R, max_iters, discrete_mask, residual_fn
            )
            replace = ~torch.isfinite(values) & torch.isfinite(new_values)
            points = torch.where(replace[:, None], new_points, points)
            values = torch.where(replace, new_values, values)
        if recoveries:
            scalar("spo_recovery_runs", recoveries)
        return points

    return optimize_continuous


def batchify_joint(
    batch_size_one_optimizer: AcquisitionOptimizer, batch_size: int
) -> AcquisitionOptimizer:
    """Lift a size-1 optimizer to optimize a joint batch, by searching ``space ** B`` and
    reshaping."""
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")

    def optimizer(
        space: SearchSpace, f: Vectorizable, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        if isinstance(f, tuple):
            raise ValueError("batchify_joint cannot be applied to vectorized functions")
        D = space.dimension

        def joint_fn(x: torch.Tensor) -> torch.Tensor:  # [..., 1, B*D]
            return f(x.reshape(x.shape[:-2] + (batch_size, D)))

        points = batch_size_one_optimizer(space**batch_size, joint_fn, generator=generator)
        return points.reshape(batch_size, D)

    return optimizer


def batchify_vectorize(
    batch_size_one_optimizer: AcquisitionOptimizer, batch_size: int
) -> AcquisitionOptimizer:
    """Lift a size-1 optimizer to optimize ``batch_size`` vectorized slices at once."""
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")

    def optimizer(
        space: SearchSpace, f: Vectorizable, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        if isinstance(f, tuple):
            raise ValueError(
                "batchify_vectorize cannot be applied to already-vectorized functions"
            )
        return batch_size_one_optimizer(space, (f, batch_size), generator=generator)

    return optimizer


def generate_random_search_optimizer(num_samples: int = NUM_SAMPLES_MIN) -> AcquisitionOptimizer:
    """Pure random-search maximization."""
    if num_samples <= 0:
        raise ValueError(f"num_samples must be positive, got {num_samples}")

    def optimizer(
        space: SearchSpace, f: Vectorizable, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        acq, V = _as_vectorized(f)
        generator = generator_for(generator, space.device)
        if isinstance(space, TaggedMultiSearchSpace):
            seeds = space.sample(generator, num_samples)  # [N, V, D]
        else:
            flat = space.sample(generator, num_samples)
            seeds = flat[:, None, :].expand(num_samples, V, flat.shape[-1])
        with torch.no_grad():
            best = torch.argmax(acq(seeds), dim=0)  # [V]
        return seeds[best, torch.arange(V, device=seeds.device)]

    return optimizer

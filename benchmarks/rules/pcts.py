"""The rule ``pcts``: ``EfficientGlobalOptimization`` with
``ParallelContinuousThompsonSampling`` over ``num_query_points`` slices, as upstream
Trieste's integration test runs it: a vectorized acquisition function, one negated
posterior trajectory per slice, all slices optimized at once.

Its trajectories draw from ``generator``, which the harness reseeds before each ask;
:func:`draws` hands what they draw to the reference, by the model's family."""


def build(traffic, optimizer, generator):
    from trieste_tpu_torch.acquisition import EfficientGlobalOptimization
    from trieste_tpu_torch.acquisition.function.continuous_thompson_sampling import (
        ParallelContinuousThompsonSampling,
    )

    return EfficientGlobalOptimization(
        ParallelContinuousThompsonSampling(generator=generator), optimizer=optimizer,
        num_query_points=int(traffic["num_query_points"]))


def draws(family, model, state, traffic):
    """What the ask about to be made will draw from a generator in ``state``: one
    trajectory per slice of the model's family."""
    return family.trajectory_draws(model, state, int(traffic["num_query_points"]))


def flops(step, cell, family):
    """The draw of the slices' trajectories, once an ask; the seed pool's score of every
    slice; and one value and gradient of all slices' trajectories per run, each run one
    point of every slice."""
    from benchmarks.harness.spec import load_module

    grad = load_module("metrics", "flops").GRAD_FACTOR
    pool = (family.trajectory_draw_flops(step, cell, step.slices)
            + family.trajectory_flops(step, cell, step.pool_rows, step.slices))
    runs = step.final_rows * grad * family.trajectory_flops(step, cell, 1, step.slices)
    return pool, runs

"""The rule ``ei``: ``EfficientGlobalOptimization`` with analytic expected improvement,
one point a step (the README quickstart's rule)."""


def build(traffic, optimizer, generator):
    """The rule; it draws nothing, so ``generator`` goes unused."""
    from trieste_tpu_torch.acquisition import EfficientGlobalOptimization, ExpectedImprovement

    return EfficientGlobalOptimization(ExpectedImprovement(), optimizer=optimizer)


def flops(step, cell, family):
    """The seed pool's score, all its rows in one pass, and one value and gradient of the
    acquisition per run, by the family's count of its marginal posterior."""
    from benchmarks.harness.spec import load_module

    grad = load_module("metrics", "flops").GRAD_FACTOR
    pool = family.marginal_flops(step, cell, step.pool_rows, one_pass=True)
    runs = step.final_rows * grad * family.marginal_flops(step, cell, 1)
    return pool, runs

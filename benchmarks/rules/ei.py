"""The rule ``ei``: ``EfficientGlobalOptimization`` with analytic expected improvement,
one point a step (the README quickstart's rule)."""


def build(traffic, optimizer):
    from trieste_tpu_torch.acquisition import EfficientGlobalOptimization, ExpectedImprovement

    return EfficientGlobalOptimization(ExpectedImprovement(), optimizer=optimizer)

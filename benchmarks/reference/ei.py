"""Plain analytic expected improvement of single points, the rule ``ei``."""
import torch

from benchmarks.reference import gp as R

VAR_FLOOR = 1e-24  # the least variance under the square root


def score(post: R.Posterior, x: torch.Tensor, traffic, draws=None) -> torch.Tensor:
    """EI below the incumbent at each row of ``x [N, 1, D]``: ``[N]``."""
    eta = post.eta()
    mean, var = post.marginal(x[:, 0, :])
    return R.expected_improvement(mean, var, eta, VAR_FLOOR)

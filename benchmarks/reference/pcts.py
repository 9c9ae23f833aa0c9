"""Plain parallel continuous Thompson sampling, the rule ``pcts``: each slice's score is
its own negated posterior trajectory, built by the family's reference posterior from the
raw draws the program's trajectories took."""
import torch


def score(post, x: torch.Tensor, traffic, draws) -> torch.Tensor:
    """``−f_v(x[:, v])`` at each row of ``x [N, V, D]``: ``[N, V]``."""
    return -post.trajectory(draws)(x)

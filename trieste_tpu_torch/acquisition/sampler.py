"""Thompson samplers (counterpart of :mod:`trieste_tpu.acquisition.sampler`). Every
sampler takes an explicit ``torch.Generator`` on the candidates' device."""
from __future__ import annotations

import math
from abc import ABC, abstractmethod
from typing import Optional

import torch

from ..models.interfaces import HasTrajectorySampler, ProbabilisticModel
from ..utils.misc import uniform


class ThompsonSampler(ABC):
    """Samples either minimizer locations or minimum values from a model's posterior at
    a finite candidate set."""

    def __init__(self, sample_min_value: bool = False):
        self._sample_min_value = sample_min_value

    @property
    def sample_min_value(self) -> bool:
        return self._sample_min_value

    @abstractmethod
    def sample(
        self,
        model: ProbabilisticModel,
        sample_size: int,
        at: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``at: [N, D]`` candidates → ``[S, D]`` minimizers or ``[S, 1]`` min-values."""

    def __repr__(self) -> str:
        return f"{type(self).__name__}(sample_min_value={self._sample_min_value!r})"


def _check_sample_size(sample_size: int) -> None:
    if sample_size <= 0:
        raise ValueError(f"sample_size must be positive, got {sample_size}")


class ExactThompsonSampler(ThompsonSampler):
    """Joint posterior draws over all candidates: exact, but O(N³) in their number."""

    def sample(self, model, sample_size, at, *, generator=None) -> torch.Tensor:
        _check_sample_size(sample_size)
        samples = model.sample(generator, at, sample_size)[..., 0]  # [S, N]
        if self._sample_min_value:
            return torch.min(samples, dim=-1, keepdim=True).values  # [S, 1]
        return at[torch.argmin(samples, dim=-1)]


def gumbel_min_value_samples(
    mean: torch.Tensor, var: torch.Tensor, u: torch.Tensor
) -> torch.Tensor:
    """Gumbel-trick samples of the posterior minimum from the marginals ``mean, var
    [N, 1]`` and uniform draws ``u [S, 1]``: the quartiles of ``min f`` under the
    independence approximation ``P(min f <= y) = 1 − Π_i P(f_i > y)``, found by bisection,
    fit a Gumbel distribution, which ``u`` then samples."""
    std = torch.sqrt(torch.clamp_min(var, 1e-24))
    quantiles = torch.tensor([0.25, 0.5, 0.75], dtype=mean.dtype, device=mean.device)
    a = torch.min(mean - 5.0 * std).expand(3)
    b = torch.min(mean + 1.0 * std).expand(3)
    for _ in range(50):
        mid = 0.5 * (a + b)  # [3]
        log_sf = torch.special.log_ndtr((mean - mid) / std)  # [N, 3]: log P(f_i > y)
        below = 1.0 - torch.exp(torch.sum(log_sf, dim=0)) < quantiles
        a, b = torch.where(below, mid, a), torch.where(below, b, mid)
    y25, y50, y75 = 0.5 * (a + b)
    scale = (y75 - y25) / (math.log(math.log(4.0)) - math.log(math.log(4.0 / 3.0)))
    loc = y50 + scale * math.log(math.log(2.0))
    samples = loc + scale * torch.log(-torch.log(1.0 - u))  # Gumbel-min draws
    return torch.minimum(samples, torch.min(mean))  # [S, 1]


class GumbelSampler(ThompsonSampler):
    """Gumbel-trick min-value samples (see :func:`gumbel_min_value_samples`). Only
    supports ``sample_min_value=True``."""

    def __init__(self, sample_min_value: bool = True):
        if not sample_min_value:
            raise ValueError("GumbelSampler only supports sample_min_value=True")
        super().__init__(True)

    def sample(self, model, sample_size, at, *, generator=None) -> torch.Tensor:
        _check_sample_size(sample_size)
        mean, var = model.predict(at)  # [N, 1]
        u = uniform(generator, (sample_size, 1), mean)
        return gumbel_min_value_samples(mean, var, torch.clamp(u, 1e-12, 1.0 - 1e-12))


class ThompsonSamplerFromTrajectory(ThompsonSampler):
    """Approximate Thompson sampling by trajectory draws: O(N) per sample. The ``S``
    trajectories are evaluated at all ``N`` candidates at once, so the features take
    ``N·S·m`` values."""

    def sample(self, model, sample_size, at, *, generator=None) -> torch.Tensor:
        _check_sample_size(sample_size)
        if not isinstance(model, HasTrajectorySampler):
            raise ValueError("ThompsonSamplerFromTrajectory requires HasTrajectorySampler")
        trajectory = model.trajectory_sampler().get_trajectory(generator, batch_size=sample_size)
        xb = at[:, None, :].expand(at.shape[0], sample_size, at.shape[-1])  # [N, S, D]
        vals = trajectory(xb)[..., 0]  # [N, S]
        if self._sample_min_value:
            return torch.min(vals, dim=0).values[:, None]  # [S, 1]
        return at[torch.argmin(vals, dim=0)]

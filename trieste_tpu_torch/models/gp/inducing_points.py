"""Inducing-point selectors (counterpart of :mod:`trieste_tpu.models.gp.inducing_points`):
strategies that place the inducing points of a sparse model as data arrives.

Each selector that draws owns a ``torch.Generator``, made on the data's device at its
first draw and seeded as its JAX twin's key (uniform 0, random subsample 1, k-means 2),
unless one is given. Its drawing step is split into the draw and a pure ``*_from_draws``
half. The greedy DPP selectors form the dense ``[n, n]`` Gram of the data and run a loop of
``M`` incremental-Cholesky steps; ``torch.argmax`` keeps the first of tied maxima, as
``jnp.argmax`` does, and ties decide which points are chosen.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

import torch

from ...data import Dataset
from ...ops.kernels import gram
from ...space import SearchSpace


class InducingPointSelector(ABC):
    """Places ``M`` inducing points, where ``M`` is the number the model holds now; with
    ``recalc_every_model_update=False`` only the first time."""

    _seed = 0

    def __init__(
        self, recalc_every_model_update: bool = True, generator: Optional[torch.Generator] = None
    ):
        self._recalc_every_model_update = recalc_every_model_update
        self._initialized = False
        self._generator = generator

    def _generator_on(self, device: torch.device) -> torch.Generator:
        if self._generator is None:
            self._generator = torch.Generator(device=device).manual_seed(self._seed)
        return self._generator

    def calculate_inducing_points(
        self, current_inducing_points: torch.Tensor, model, dataset: Dataset
    ) -> torch.Tensor:
        if self._initialized and not self._recalc_every_model_update:
            return current_inducing_points
        self._initialized = True
        return self._recalculate_inducing_points(current_inducing_points.shape[0], model, dataset)

    @abstractmethod
    def _recalculate_inducing_points(self, M: int, model, dataset: Dataset) -> torch.Tensor:
        ...


class UniformInducingPointSelector(InducingPointSelector):
    """Uniform samples of the search space."""

    def __init__(
        self,
        search_space: SearchSpace,
        recalc_every_model_update: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(recalc_every_model_update, generator)
        self._search_space = search_space

    def _recalculate_inducing_points(self, M, model, dataset):
        return self._search_space.sample(self._generator_on(self._search_space.device), M)


def random_subsample_from_draws(qp: torch.Tensor, M: int, draws: torch.Tensor) -> torch.Tensor:
    """``M`` rows of ``qp [n, D]``: with ``n >= M`` the rows ``draws [M]`` (distinct
    indices); otherwise all of them and ``M − n`` uniform points, ``draws [M − n, D]`` in
    ``[0, 1)``, scaled to the data's bounding box (its top widened by 1e-6)."""
    if qp.shape[0] >= M:
        return qp[draws]
    lo, hi = torch.amin(qp, dim=0), torch.amax(qp, dim=0) + 1e-6
    return torch.cat([qp, torch.maximum(lo, draws * (hi - lo) + lo)])


class RandomSubSampleInducingPointSelector(InducingPointSelector):
    """A random subsample of the data, padded with uniform points of the data's bounding
    box when the data holds fewer than ``M`` points."""

    _seed = 1

    def __init__(
        self, recalc_every_model_update: bool = True, generator: Optional[torch.Generator] = None
    ):
        super().__init__(recalc_every_model_update, generator)

    def _recalculate_inducing_points(self, M, model, dataset):
        qp = dataset.trimmed_query_points
        n, D = qp.shape
        gen = self._generator_on(qp.device)
        if n >= M:
            draws = torch.randperm(n, generator=gen, device=qp.device)[:M]
        else:
            draws = torch.rand((M - n, D), generator=gen, dtype=qp.dtype, device=qp.device)
        return random_subsample_from_draws(qp, M, draws)


def kmeans_from_draws(qp: torch.Tensor, M: int, perm: torch.Tensor, num_iters: int) -> torch.Tensor:
    """``num_iters`` Lloyd steps on the standardized data from the centroids
    ``qp[perm[:M]]``; a centroid that loses all its points stays where it is."""
    mean = torch.mean(qp, dim=0)
    std = torch.clamp_min(torch.std(qp, dim=0, correction=0), 1e-9)
    normed = (qp - mean) / std
    centroids = normed[perm[:M]]
    for _ in range(num_iters):
        d = torch.sum((normed[:, None, :] - centroids[None, :, :]) ** 2, dim=-1)  # [n, M]
        one_hot = torch.nn.functional.one_hot(torch.argmin(d, dim=-1), M).to(normed.dtype)
        counts = torch.sum(one_hot, dim=0)[:, None]  # [M, 1]
        sums = one_hot.T @ normed  # [M, D]
        centroids = torch.where(counts > 0, sums / torch.clamp_min(counts, 1), centroids)
    return centroids * std + mean


class KMeansInducingPointSelector(InducingPointSelector):
    """K-means centroids of the standardized data (a fixed number of Lloyd steps); a
    random subsample (with its padding) when the data holds fewer than ``M`` points."""

    _seed = 2

    def __init__(
        self,
        recalc_every_model_update: bool = True,
        num_iters: int = 20,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(recalc_every_model_update, generator)
        self._num_iters = num_iters

    def _recalculate_inducing_points(self, M, model, dataset):
        qp = dataset.trimmed_query_points
        n = qp.shape[0]
        gen = self._generator_on(qp.device)
        if n < M:
            return RandomSubSampleInducingPointSelector(generator=gen)._recalculate_inducing_points(
                M, model, dataset
            )
        perm = torch.randperm(n, generator=gen, device=qp.device)
        return kmeans_from_draws(qp, M, perm, self._num_iters)


class QualityFunction:
    """The quality score of each data point as a candidate inducing point, ``[n]``."""

    def __call__(self, model, dataset: Dataset) -> torch.Tensor:
        raise NotImplementedError


class UnitQualityFunction(QualityFunction):
    """Every point equal: the DPP allocates by the predictive variance alone."""

    def __call__(self, model, dataset):
        qp = dataset.trimmed_query_points
        return torch.ones(qp.shape[0], dtype=qp.dtype, device=qp.device)


class ModelBasedImprovementQualityFunction(QualityFunction):
    """The expected improvement over a conservative baseline (the largest posterior mean
    at the data) under the model as it stands."""

    def __call__(self, model, dataset):
        mean, variance = model.predict(dataset.trimmed_query_points)  # [n, 1]
        baseline = torch.max(mean)
        std = torch.sqrt(torch.clamp_min(variance, 1e-24))
        z = (baseline - mean) / std
        pdf = torch.exp(-0.5 * z * z) / (2.0 * torch.pi) ** 0.5
        improvement = (baseline - mean) * torch.special.ndtr(z) + std * pdf
        return improvement[:, 0]


def greedy_dpp_indices(K: torch.Tensor, quality: torch.Tensor, M: int) -> torch.Tensor:
    """The greedy MAP estimate of the quality-diversity DPP with Gram ``K [n, n]``: ``M``
    indices, each maximizing ``log d²ᵢ + 2 log qualityᵢ`` over the points not yet chosen,
    with the conditional variances ``d²`` kept by incremental Cholesky rows."""
    n = K.shape[0]
    log_q2 = 2.0 * torch.log(torch.clamp_min(quality, 1e-24))
    di = torch.diagonal(K).clone()
    rows = K.new_zeros((M, n))
    selected = torch.zeros(n, dtype=torch.bool, device=K.device)
    chosen = []
    for count in range(M):
        crit = torch.where(selected, -torch.inf, torch.log(torch.clamp_min(di, 1e-24)) + log_q2)
        j = torch.argmax(crit)
        dj = torch.sqrt(torch.clamp_min(di[j], 1e-12))
        lj = (K[j] - rows.T @ rows[:, j]) / dj
        di = torch.clamp_min(di - torch.square(lj), 0.0)
        rows[count] = lj
        selected[j] = True
        chosen.append(j)
    return torch.stack(chosen)


class DPPInducingPointSelector(InducingPointSelector):
    """The greedy MAP estimate of a quality-diversity DPP over the data, the model's
    kernel as its similarity and ``quality_function`` as its quality; a random subsample
    (the random-subsample selector's own draws, anew each time) when the data holds no
    more than ``M`` points."""

    def __init__(
        self,
        quality_function: Optional[QualityFunction] = None,
        recalc_every_model_update: bool = True,
    ):
        super().__init__(recalc_every_model_update)
        self._quality_function = quality_function or UnitQualityFunction()

    def _recalculate_inducing_points(self, M, model, dataset):
        qp = dataset.trimmed_query_points
        if qp.shape[0] <= M:
            return RandomSubSampleInducingPointSelector()._recalculate_inducing_points(
                M, model, dataset
            )
        K = gram(model.get_kernel(), qp)  # [n, n]
        return qp[greedy_dpp_indices(K, self._quality_function(model, dataset), M)]


class ConditionalVarianceReduction(DPPInducingPointSelector):
    """Greedy selection by the largest conditional variance (a unit-quality DPP)."""

    def __init__(self, recalc_every_model_update: bool = True):
        super().__init__(UnitQualityFunction(), recalc_every_model_update)


class ConditionalImprovementReduction(DPPInducingPointSelector):
    """A greedy DPP biased towards promising (low-mean) regions."""

    def __init__(self, recalc_every_model_update: bool = True):
        super().__init__(ModelBasedImprovementQualityFunction(), recalc_every_model_update)


def greedy_inference_dpp(
    M: int, kernel, quality_scores: torch.Tensor, dataset: Dataset
) -> torch.Tensor:
    """The greedy DPP over the dataset's points with the given kernel and quality scores:
    ``[min(M, n), D]`` points."""

    class _Fixed(QualityFunction):
        def __call__(self, model, ds):
            return quality_scores

    class _KernelOnly:
        def get_kernel(self):
            return kernel

    M = min(M, dataset.trimmed_query_points.shape[0])
    return DPPInducingPointSelector(_Fixed())._recalculate_inducing_points(
        M, _KernelOnly(), dataset
    )

"""Multi-objective acquisition functions (counterpart of
:mod:`trieste_tpu.acquisition.function.multi_objective`): analytic expected hypervolume
improvement (EHVI) over a box decomposition of the non-dominated region, its batch
Monte-Carlo form with exact union volumes by inclusion-exclusion (qEHVI), the
constrained form (ECHVI) and HIPPO's penalized batches.

The cell math runs on the device over ``[K]`` cells × ``[M]`` objectives; the cells come
from the observed front, on the host (:mod:`..multi_objective.partition`). A model
stack predicts member by member, so each member's seed-pool score is one marginal
prediction (the fused kernel's, on the card, for a pool of at least 2048 rows).
"""
from __future__ import annotations

import itertools
import math
from functools import partial
from typing import Callable, Mapping, Optional, Sequence, Tuple

import torch

from ...data import Dataset
from ...models.gp import posterior as P
from ...models.interfaces import ProbabilisticModel
from ...observer import OBJECTIVE
from ...types import Tag
from ..interface import (
    AcquisitionFunction,
    AcquisitionFunctionBuilder,
    SingleModelAcquisitionBuilder,
    SingleModelGreedyAcquisitionBuilder,
)
from ..multi_objective import (
    Pareto,
    get_reference_point,
    prepare_default_non_dominated_partition_bounds,
)
from ..utils import predictor
from .function import _MonteCarloBuilder, _product_fn, _validate_dataset

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)

ReferencePointSpec = Callable[[torch.Tensor], torch.Tensor]


def _psi(a: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """``psi(a, a) = std·pdf(z) + (a − mean)·cdf(z)`` with ``z = (a − mean) / std``."""
    z = (a - mean) / std
    return std * torch.exp(-0.5 * z * z) * _INV_SQRT_2PI + (a - mean) * torch.special.ndtr(z)


def _psi_minus_diff(
    mean: torch.Tensor, std: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor
) -> torch.Tensor:
    """The per-objective factor ``E[(u − max(y, l))⁺] = psi(u) − psi(l)`` of the box
    decomposition EHVI (Yang et al.). ``mean, std [..., 1, M]``, ``lower, upper [K, M]``
    → ``[..., K, M]``. A ``-inf`` lower bound contributes ``psi(l) = 0``; it is evaluated
    at a finite stand-in first, so that its discarded branch carries no NaN gradient."""
    finite_l = torch.isfinite(lower)
    safe_lower = torch.where(finite_l, lower, torch.zeros_like(lower))
    psi_l = torch.where(finite_l, _psi(safe_lower, mean, std), 0.0)
    return torch.clamp_min(_psi(upper, mean, std) - psi_l, 0.0)


def _ehvi_fn(
    predict: Callable, lower: torch.Tensor, upper: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Analytic EHVI, ``x [..., 1, D] -> [..., 1]``."""
    mean, var = predict(x[..., 0, :])  # [..., M]
    std = torch.sqrt(torch.clamp_min(var, 1e-24))
    factors = _psi_minus_diff(mean[..., None, :], std[..., None, :], lower, upper)
    return torch.sum(torch.prod(factors, dim=-1), dim=-1, keepdim=True)


def _front_cells(
    model: ProbabilisticModel, dataset: Dataset, reference_point_spec: ReferencePointSpec,
    keep: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cells ``(lower, upper)`` of the region that the model's mean at the observed
    points (those under ``keep``) does not dominate, below its reference point."""
    mean, _ = model.predict(dataset.trimmed_query_points)
    if keep is not None:
        mean = mean[keep]
    front = Pareto(mean).front
    return prepare_default_non_dominated_partition_bounds(reference_point_spec(mean), front)


class ExpectedHypervolumeImprovement(SingleModelAcquisitionBuilder):
    """Analytic expected hypervolume improvement over the cells of the region that the
    model's mean at the observed points does not dominate."""

    def __init__(self, reference_point_spec: Optional[ReferencePointSpec] = None):
        self._ref_spec = reference_point_spec or get_reference_point

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        dataset = _validate_dataset(dataset, "ExpectedHypervolumeImprovement")
        lower, upper = _front_cells(model, dataset, self._ref_spec)
        return partial(_ehvi_fn, predictor(model), lower, upper)

    def __repr__(self) -> str:
        return "ExpectedHypervolumeImprovement()"


def _subset_masks(batch_size: int, device=None) -> torch.Tensor:
    """``[2^B − 1, B]`` boolean masks of the non-empty subsets of a batch, in the order of
    ``itertools.product``, for inclusion-exclusion."""
    masks = list(itertools.product([False, True], repeat=batch_size))[1:]
    return torch.tensor(masks, dtype=torch.bool, device=device)


def _batch_ehvi_fn(
    sample: Callable,
    lower: torch.Tensor,  # [K, M]
    upper: torch.Tensor,  # [K, M]
    subset_masks: torch.Tensor,  # [T, B]
    x: torch.Tensor,
) -> torch.Tensor:
    """qEHVI by Monte Carlo, each sample's improvement the exact volume of the union of
    the batch's boxes in every cell, by inclusion-exclusion. ``x [..., B, D] -> [..., 1]``;
    the largest intermediate is ``[..., S, K, T, B, M]``."""
    samples = sample(x)  # [..., S, B, M]
    m = torch.maximum(samples[..., None, :, :], lower[:, None, :])  # [..., S, K, B, M]
    signs = torch.where(torch.sum(subset_masks, dim=-1) % 2 == 1, 1.0, -1.0).to(m.dtype)
    masked = torch.where(subset_masks[:, :, None], m[..., None, :, :], -torch.inf)
    subset_max = torch.amax(masked, dim=-2)  # [..., S, K, T, M]
    vols = torch.prod(torch.clamp_min(upper[:, None, :] - subset_max, 0.0), dim=-1)
    union = torch.sum(signs * vols, dim=-1)  # [..., S, K]
    return torch.mean(torch.sum(union, dim=-1), dim=-1, keepdim=True)


class _BatchEHVIWithLazyMasks:
    """qEHVI whose subset masks are made once the batch size is known."""

    def __init__(self, sample: Callable, lower: torch.Tensor, upper: torch.Tensor):
        self._sample = sample
        self._lower = lower
        self._upper = upper
        self._masks: Optional[torch.Tensor] = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self._masks is None or self._masks.shape[-1] != x.shape[-2]:
            self._masks = _subset_masks(x.shape[-2], x.device)
        return _batch_ehvi_fn(self._sample, self._lower, self._upper, self._masks, x)


class BatchMonteCarloExpectedHypervolumeImprovement(_MonteCarloBuilder):
    """qEHVI from joint reparametrization samples over the batch (a model stack's members
    sample side by side). The base draws are frozen at the first call of each prepared
    function."""

    def __init__(
        self,
        sample_size: int,
        reference_point_spec: Optional[ReferencePointSpec] = None,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(sample_size, generator=generator)
        self._ref_spec = reference_point_spec or get_reference_point

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        dataset = _validate_dataset(dataset, "BatchMonteCarloExpectedHypervolumeImprovement")
        lower, upper = _front_cells(model, dataset, self._ref_spec)
        return _BatchEHVIWithLazyMasks(self._sample_fn(model, dataset, joint=True), lower, upper)


class ExpectedConstrainedHypervolumeImprovement(AcquisitionFunctionBuilder):
    """EHVI over the front of the points predicted feasible, times the constraint
    builder's probability of feasibility. While no observed point is feasible with at
    least ``min_feasibility_probability``, the function is the feasibility alone."""

    def __init__(
        self,
        objective_tag: Tag,
        constraint_builder: AcquisitionFunctionBuilder,
        min_feasibility_probability: float = 0.5,
        reference_point_spec: Optional[ReferencePointSpec] = None,
    ):
        self._objective_tag = objective_tag
        self._constraint_builder = constraint_builder
        self._min_feasibility_probability = min_feasibility_probability
        self._ref_spec = reference_point_spec or get_reference_point

    def prepare_acquisition_function(
        self,
        models: Mapping[Tag, ProbabilisticModel],
        datasets: Optional[Mapping[Tag, Dataset]] = None,
    ) -> AcquisitionFunction:
        if datasets is None or self._objective_tag not in datasets:
            raise ValueError(
                f"ExpectedConstrainedHypervolumeImprovement requires a dataset for "
                f"{self._objective_tag!r}"
            )
        dataset = _validate_dataset(
            datasets[self._objective_tag], "ExpectedConstrainedHypervolumeImprovement"
        )
        model = models[self._objective_tag]
        constraint_fn = self._constraint_builder.prepare_acquisition_function(models, datasets)
        pof = constraint_fn(dataset.trimmed_query_points[:, None, :])[..., 0]
        feasible = pof >= self._min_feasibility_probability
        if not bool(torch.any(feasible)):
            return constraint_fn
        lower, upper = _front_cells(model, dataset, self._ref_spec, keep=feasible)
        ehvi = partial(_ehvi_fn, predictor(model), lower, upper)
        return partial(_product_fn, (ehvi, constraint_fn))

    def __repr__(self) -> str:
        return (
            f"ExpectedConstrainedHypervolumeImprovement({self._objective_tag!r}, "
            f"{self._constraint_builder!r})"
        )


def _member_states(model: ProbabilisticModel) -> Tuple[Tuple[P.GPRParams, P.GPRCache], ...]:
    """``(params, posterior cache)`` of each exact-GP member of a stack (or of the model)."""
    members = getattr(model, "models", [model])
    if not all(hasattr(m, "params") and hasattr(m, "posterior_cache") for m in members):
        raise NotImplementedError(
            "HIPPO currently requires exact-GP members (params/posterior_cache)"
        )
    return tuple((m.params, m.posterior_cache) for m in members)


def _hippo_penalty_fn(
    member_states: Sequence[Tuple[P.GPRParams, P.GPRCache]],
    pending_points: torch.Tensor,  # [P, D]
    x: torch.Tensor,
) -> torch.Tensor:
    """HIPPO's penalty, ``x [..., 1, D] -> [..., 1]``: per member and pending point, one
    minus the squared posterior correlation, multiplied over both."""
    flat = x.reshape(-1, x.shape[-1])  # [N, D]
    penalty = torch.ones(flat.shape[0], dtype=flat.dtype, device=flat.device)
    for params, cache in member_states:
        cov = P.covariance_between_points(params, cache, flat, pending_points)  # [N, P]
        _, var_x = P.predict_f(params, cache, flat)  # [N, 1]
        _, var_p = P.predict_f(params, cache, pending_points)  # [P, 1]
        rho2 = torch.square(cov) / torch.clamp_min(var_x * var_p[:, 0][None, :], 1e-24)
        penalty = penalty * torch.prod(1.0 - torch.clamp(rho2, 0.0, 1.0), dim=-1)
    return penalty.reshape(x.shape[:-2] + (1,))


class HIPPO(SingleModelGreedyAcquisitionBuilder):
    """Penalized batches for many objectives: the base function (EHVI by default) times
    a penalty on the posterior correlation with the points already in the batch."""

    def __init__(
        self,
        objective_tag: Tag = OBJECTIVE,
        base_acquisition_function_builder: Optional[SingleModelAcquisitionBuilder] = None,
    ):
        self._objective_tag = objective_tag
        self._base_builder = base_acquisition_function_builder or ExpectedHypervolumeImprovement()

    def prepare_acquisition_function(
        self,
        model: ProbabilisticModel,
        dataset: Optional[Dataset] = None,
        pending_points: Optional[torch.Tensor] = None,
    ) -> AcquisitionFunction:
        base = self._base_builder.prepare_acquisition_function(model, dataset)
        if pending_points is None or pending_points.numel() == 0:
            return base
        penalty = partial(_hippo_penalty_fn, _member_states(model), pending_points)
        return partial(_product_fn, (base, penalty))

    def __repr__(self) -> str:
        return f"HIPPO({self._objective_tag!r}, {self._base_builder!r})"

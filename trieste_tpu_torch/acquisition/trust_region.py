"""Batch trust-region acquisition rules (counterpart of
:mod:`trieste_tpu.acquisition.trust_region`).

Updatable regions, the stateful :class:`BatchTrustRegion` rule and its three families:
box regions (the plain hypercube region, TREGO's alternation of a global and a local
phase, TuRBO), discrete regions (a neighbourhood of a location in a finite point set, or
one fixed point) and product regions over a mixed product space.

A region is a search space that moves: its geometry lives in tensors on the global
space's device (a box region's bounds, as for every :class:`Box`, on the host) and it
draws from a ``torch.Generator`` of its own on that device. ``acquire`` returns a ``State``
callable giving ``[B, V, D]`` points, one column per region. With one base rule the V
regions are searched at once, as one vectorized acquisition over a
:class:`TaggedMultiSearchSpace`; with a list of rules, region by region, each rule
seeing its region's local data under the global tag. ``filter_datasets`` is the
state-returning step that initializes or updates every region and re-masks the local
datasets at unchanged capacity.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data import Dataset
from ..models.interfaces import ProbabilisticModel
from ..observer import OBJECTIVE
from ..space import (
    Box,
    CategoricalSearchSpace,
    GeneralDiscreteSearchSpace,
    SearchSpace,
    TaggedMultiSearchSpace,
    TaggedProductSearchSpace,
)
from ..types import Tag
from ..utils.misc import LocalizedTag, generator_for, get_value_for_tag
from .rule import AcquisitionRule, EfficientGlobalOptimization, LocalDatasetsAcquisitionRule


class UpdatableTrustRegion(SearchSpace):
    """A search (sub)space that updates itself from the models and datasets."""

    def __init__(self, region_index: Optional[int] = None):
        self.region_index = region_index
        self.input_active_dims: Optional[Tuple[int, int]] = None  # (start, end) columns

    def with_input_active_dims(self, x: torch.Tensor) -> torch.Tensor:
        """This region's columns of ``x`` (a member of a product region reads its own)."""
        if self.input_active_dims is None:
            return x
        lo, hi = self.input_active_dims
        return x[..., lo:hi]

    @property
    def requires_initialization(self) -> bool:
        """Whether the region wants to be initialized rather than updated this step."""
        return False

    def initialize(
        self,
        models: Optional[Mapping[Tag, ProbabilisticModel]] = None,
        datasets: Optional[Mapping[Tag, Dataset]] = None,
    ) -> None:
        raise NotImplementedError

    def update(
        self,
        models: Optional[Mapping[Tag, ProbabilisticModel]] = None,
        datasets: Optional[Mapping[Tag, Dataset]] = None,
    ) -> None:
        raise NotImplementedError

    def dataset_filter_mask(self, global_ds: Dataset) -> torch.Tensor:
        """The rows of the global dataset that this region's local dataset keeps
        (default: the members of the region)."""
        qp = self.with_input_active_dims(global_ds.query_points)
        return self.contains(qp) & global_ds.mask

    def _get_tagged_dataset(
        self, datasets: Optional[Mapping[Tag, Dataset]]
    ) -> Optional[Dataset]:
        """The objective dataset of this region: its localized tag where present."""
        if datasets is None:
            return None
        if self.region_index is not None:
            local = LocalizedTag(OBJECTIVE, self.region_index)
            if local in datasets:
                return datasets[local]
        _, ds = get_value_for_tag(datasets, OBJECTIVE)
        return ds


@dataclass(frozen=True)
class BatchTrustRegionState:
    """The acquisition state of a trust-region rule: the region fleet."""

    subspaces: Tuple[UpdatableTrustRegion, ...]

    @property
    def acquisition_space(self) -> TaggedMultiSearchSpace:
        return TaggedMultiSearchSpace(list(self.subspaces))


class BatchTrustRegion(LocalDatasetsAcquisitionRule):
    """A base acquisition rule run over a fleet of trust regions.

    With one base rule the regions are searched at once (one acquisition over the
    ``TaggedMultiSearchSpace``); with one rule per region, region by region, each rule
    seeing its region's local models and data under their global tags.
    """

    def __init__(
        self,
        init_subspaces: Union[None, int, Sequence[UpdatableTrustRegion]] = None,
        rule: Union[None, AcquisitionRule, Sequence[AcquisitionRule]] = None,
    ):
        self._init_subspaces: Optional[Tuple[UpdatableTrustRegion, ...]]
        if init_subspaces is None or isinstance(init_subspaces, int):
            self._num_regions = init_subspaces or 1
            self._init_subspaces = None
        else:
            self._init_subspaces = tuple(init_subspaces)
            self._num_regions = len(self._init_subspaces)
            for i, s in enumerate(self._init_subspaces):
                s.region_index = i
        self._rule = rule
        self._subspaces: Optional[Tuple[UpdatableTrustRegion, ...]] = None
        self._initialized = False

    @property
    def num_local_datasets(self) -> int:
        return self._num_regions

    def _make_default_subspaces(
        self, search_space: SearchSpace
    ) -> Tuple[UpdatableTrustRegion, ...]:
        raise NotImplementedError

    def _make_default_rule(self) -> AcquisitionRule:
        """MONLCB over the fleet, one optimism level per region."""
        from .function.function import MultipleOptimismNegativeLowerConfidenceBound

        return EfficientGlobalOptimization(
            MultipleOptimismNegativeLowerConfidenceBound(self._global_search_space),
            num_query_points=self._num_regions,
        )

    def initialize_subspaces(self, search_space: SearchSpace) -> None:
        """Make the regions (unless given) and the base rule (unless given)."""
        self._global_search_space = search_space
        if self._subspaces is None:
            if self._init_subspaces is None:
                self._subspaces = self._make_default_subspaces(search_space)
            else:
                self._subspaces = self._init_subspaces
            self._num_regions = len(self._subspaces)
        if self._rule is None:
            self._rule = self._make_default_rule()

    def acquire(
        self,
        search_space: SearchSpace,
        models: Mapping[Tag, ProbabilisticModel],
        datasets: Optional[Mapping[Tag, Dataset]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Callable[[Optional[BatchTrustRegionState]], Tuple[BatchTrustRegionState, torch.Tensor]]:
        if self._subspaces is None:
            self.initialize_subspaces(search_space)
        generator = generator_for(generator, search_space.device)

        def state_func(
            state: Optional[BatchTrustRegionState],
        ) -> Tuple[BatchTrustRegionState, torch.Tensor]:
            subspaces = state.subspaces if state is not None else self._subspaces
            if isinstance(self._rule, (list, tuple)):
                points = [
                    rule_i.acquire(
                        subspace, _select_local(models, i),
                        _select_local(datasets, i) if datasets else None, generator=generator,
                    )
                    for i, (subspace, rule_i) in enumerate(zip(subspaces, self._rule))
                ]
                qp = torch.stack(points, dim=1)  # [B, V, D]
            else:
                pts = self._rule.acquire(
                    TaggedMultiSearchSpace(list(subspaces)), models, datasets,
                    generator=generator,
                )
                qp = pts.reshape(-1, len(subspaces), pts.shape[-1])
            return BatchTrustRegionState(tuple(subspaces)), qp

        return state_func

    def filter_datasets(
        self,
        models: Mapping[Tag, ProbabilisticModel],
        datasets: Mapping[Tag, Dataset],
    ) -> Callable[
        [Optional[BatchTrustRegionState]], Tuple[BatchTrustRegionState, Mapping[Tag, Dataset]]
    ]:
        """Initialize (first call, or where a region asks for it) or update every region,
        then re-mask each local dataset to its region's rows of the global one."""

        def state_func(
            state: Optional[BatchTrustRegionState],
        ) -> Tuple[BatchTrustRegionState, Mapping[Tag, Dataset]]:
            subspaces = (
                state.subspaces if state is not None and state.subspaces else self._subspaces
            )
            if subspaces is None:
                raise ValueError("the trust regions are not initialized: call initialize_subspaces")
            for subspace in subspaces:
                if not self._initialized or subspace.requires_initialization:
                    subspace.initialize(models, datasets)
                else:
                    subspace.update(models, datasets)
            self._initialized = True
            self._subspaces = tuple(subspaces)

            # a local dataset keeps the global capacity and only permutes its rows and
            # lowers num_points, so the model's cache sees the same shapes on every step
            filtered: dict[Tag, Dataset] = {
                tag: ds for tag, ds in datasets.items() if not LocalizedTag.from_tag(tag).is_local
            }
            for tag, dataset in datasets.items():
                ltag = LocalizedTag.from_tag(tag)
                if ltag.is_local:
                    global_ds = filtered.get(ltag.global_tag, dataset)
                    region = subspaces[ltag.local_index]
                    local_ds = _mask_to_region(global_ds, region.dataset_filter_mask(global_ds))
                    # a region that holds no observation yet keeps the whole dataset, so
                    # its models and acquisition functions stay buildable
                    filtered[tag] = global_ds if local_ds.num_points == 0 else local_ds
            return BatchTrustRegionState(tuple(subspaces)), filtered

        return state_func


def _is_improvement(y_new: float, y_min: float, kappa_margin: float) -> bool:
    """``y_new < y_min - kappa_margin`` where ``y_min`` is finite; any finite ``y_new``
    improves on an empty region (``y_min = inf``, where the margin would be nan)."""
    if not math.isfinite(y_min):
        return math.isfinite(y_new)
    return y_new < y_min - kappa_margin


def _mask_to_region(global_ds: Dataset, inside: torch.Tensor) -> Dataset:
    """The rows of a padded dataset where ``inside`` holds, at unchanged capacity: a stable
    partition moves them to the front in their order and ``num_points`` drops to their
    count. Padded rows stay behind them."""
    order = torch.argsort((~inside).to(torch.int8), stable=True)
    return Dataset(
        global_ds.query_points[order], global_ds.observations[order], int(inside.sum())
    )


def _select_local(mapping: Mapping[Tag, object], index: int) -> dict[Tag, object]:
    """Region ``index``'s entries under their global tags, global entries elsewhere."""
    out: dict[Tag, object] = {}
    for tag, value in mapping.items():
        ltag = LocalizedTag.from_tag(tag)
        if ltag.is_local and ltag.local_index == index:
            out[ltag.global_tag] = value
        elif not ltag.is_local and ltag.global_tag not in out:
            out.setdefault(tag, value)
    return out


def _host_bounds(bound: Union[torch.Tensor, np.ndarray]) -> np.ndarray:
    if isinstance(bound, torch.Tensor):
        bound = bound.detach().cpu().numpy()
    return np.array(bound, np.float64)  # a copy: never an alias of another box's bounds


# -- box regions -----------------------------------------------------------------------


class UpdatableTrustRegionBox(Box, UpdatableTrustRegion):
    """A box trust region inside a global box, on its device and with its dtype."""

    def __init__(self, global_search_space: Box, region_index: Optional[int] = None):
        self._global_search_space = global_search_space
        Box.__init__(
            self, global_search_space._lower, global_search_space._upper,
            dtype=global_search_space.dtype, device=global_search_space.device,
        )
        UpdatableTrustRegion.__init__(self, region_index)

    @property
    def global_search_space(self) -> Box:
        return self._global_search_space

    def _set_bounds(
        self, lower: Union[torch.Tensor, np.ndarray], upper: Union[torch.Tensor, np.ndarray]
    ) -> None:
        """Move the region: the bounds are kept on the host, as for every box."""
        self._lower = _host_bounds(lower)
        self._upper = _host_bounds(upper)


class SingleObjectiveTrustRegionBox(UpdatableTrustRegionBox):
    """The hypercube trust region: on a success (the region's best observation improves
    by more than ``kappa`` times the region's volume) it recentres on the best point and
    grows ``eps`` by ``1/beta``; on a failure it shrinks ``eps`` by ``beta``; below
    ``min_eps`` it starts again at a random location, ``eps = zeta·extent``."""

    def __init__(
        self,
        global_search_space: Box,
        beta: float = 0.7,
        kappa: float = 1e-4,
        zeta: float = 0.5,
        min_eps: float = 1e-2,
        region_index: Optional[int] = None,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(global_search_space, region_index)
        self._beta = beta
        self._kappa = kappa
        self._zeta = zeta
        self._min_eps = min_eps
        self._generator = generator_for(generator, global_search_space.device)
        self._needs_init = True
        self._region_initialized = False
        self._y_min = math.inf
        self.location: Optional[torch.Tensor] = None
        self.eps: Optional[torch.Tensor] = None

    @property
    def requires_initialization(self) -> bool:
        return self._needs_init

    def _resize_bounds(self) -> None:
        g = self.global_search_space
        self._set_bounds(
            torch.maximum(self.location - self.eps, g.lower),
            torch.minimum(self.location + self.eps, g.upper),
        )

    def _region_min(
        self, datasets: Optional[Mapping[Tag, Dataset]]
    ) -> Tuple[Optional[torch.Tensor], float]:
        """The best (point, value) among the observations inside the region."""
        ds = self._get_tagged_dataset(datasets)
        if ds is None or len(ds) == 0:
            return None, math.inf
        qp, obs = ds.astuple()
        qp = self.with_input_active_dims(qp)
        inside = Box.contains(self, qp)
        if not bool(inside.any()):
            return None, math.inf
        qp_in, obs_in = qp[inside], obs[inside, 0]
        idx = int(torch.argmin(obs_in))
        return qp_in[idx], float(obs_in[idx])

    def initialize(self, models=None, datasets=None) -> None:
        g = self.global_search_space
        self.location = g.sample(self._generator, 1)[0]
        self.eps = self._zeta * (g.upper - g.lower)
        self._resize_bounds()
        # nothing observed in the fresh region yet: the first update is a success, which
        # recentres it on the best point
        self._y_min = math.inf
        self._region_initialized = True
        self._needs_init = False

    def _step_success(self, y_new: float) -> bool:
        tr_volume = float(np.prod(self._upper - self._lower))
        return y_new < self._y_min - self._kappa * tr_volume

    def update(self, models=None, datasets=None) -> None:
        best_point, y_new = self._region_min(datasets)
        if best_point is not None and self._step_success(y_new):
            self.location = best_point
            self.eps = self.eps / self._beta
            self._y_min = y_new
        else:
            self.eps = self.eps * self._beta
        if float(torch.max(self.eps)) < self._min_eps:
            self._needs_init = True
            self.initialize(models, datasets)
            return
        self._resize_bounds()


class BatchTrustRegionBox(BatchTrustRegion):
    """The batch trust-region rule over box regions; by default ``init_subspaces``
    :class:`SingleObjectiveTrustRegionBox` regions, region ``i`` drawing from a generator
    seeded with ``i``, and MONLCB over the fleet."""

    def _make_default_subspaces(
        self, search_space: SearchSpace
    ) -> Tuple[UpdatableTrustRegion, ...]:
        return tuple(
            SingleObjectiveTrustRegionBox(
                search_space, region_index=i,
                generator=torch.Generator(device=search_space.device).manual_seed(i),
            )
            for i in range(self._num_regions)
        )


class TREGOBox(SingleObjectiveTrustRegionBox):
    """TREGO: a global phase (the whole space) and a local trust-region phase in turn.

    A success keeps or makes the search global, a failure toggles the phase; ``eps``
    changes only when the step just taken was local; the minimum it tracks is that of
    the whole dataset, and its local dataset is the whole dataset; the first
    initialization starts global, a re-initialization (``eps`` collapsed) local."""

    def __init__(self, global_search_space: Box, **kwargs: object):
        super().__init__(global_search_space, **kwargs)  # type: ignore[arg-type]
        self._is_global = True

    @property
    def is_global(self) -> bool:
        return self._is_global

    def _resize_bounds(self) -> None:
        if self._is_global:
            g = self.global_search_space
            self._set_bounds(g._lower, g._upper)
        else:
            super()._resize_bounds()

    def dataset_filter_mask(self, global_ds: Dataset) -> torch.Tensor:
        return global_ds.mask  # the model always sees every point

    def _global_min(
        self, datasets: Optional[Mapping[Tag, Dataset]]
    ) -> Tuple[Optional[torch.Tensor], float]:
        """The best (point, value) over the whole dataset."""
        ds = self._get_tagged_dataset(datasets)
        if ds is None or len(ds) == 0:
            return None, math.inf
        qp, obs = ds.astuple()
        qp = self.with_input_active_dims(qp)
        idx = int(torch.argmin(obs[:, 0]))
        return qp[idx], float(obs[idx, 0])

    def initialize(self, models=None, datasets=None) -> None:
        self._is_global = not self._region_initialized
        super().initialize(models, datasets)

    def update(self, models=None, datasets=None) -> None:
        best_point, y_new = self._global_min(datasets)
        success = best_point is not None and self._step_success(y_new)
        if not self._is_global:
            self.eps = self.eps / self._beta if success else self.eps * self._beta
        if success:
            self.location = best_point
            self._y_min = y_new
        self._is_global = success or not self._is_global
        if float(torch.max(self.eps)) < self._min_eps:
            self._needs_init = True
            self.initialize(models, datasets)
            return
        self._resize_bounds()


class TURBOBox(UpdatableTrustRegionBox):
    """The TuRBO trust region: its side ``L`` doubles (up to ``L_max``) after
    ``success_tolerance`` successes in a row and halves after ``failure_tolerance``
    failures in a row; below ``L_min`` it starts again. The box is centred on the best
    point of its data, its widths shaped by the model's ARD lengthscales."""

    def __init__(
        self,
        global_search_space: Box,
        L_min: Optional[float] = None,
        L_init: Optional[float] = None,
        L_max: Optional[float] = None,
        success_tolerance: int = 3,
        failure_tolerance: Optional[int] = None,
        region_index: Optional[int] = None,
    ):
        super().__init__(global_search_space, region_index)
        extent = float(np.max(global_search_space._upper - global_search_space._lower))
        D = global_search_space.dimension
        self.L_min = L_min if L_min is not None else 0.5**7 * extent
        self.L_init = L_init if L_init is not None else 0.8 * extent
        self.L_max = L_max if L_max is not None else 1.6 * extent
        self.success_tolerance = success_tolerance
        self.failure_tolerance = failure_tolerance if failure_tolerance is not None else max(2, D)
        if success_tolerance <= 0:
            raise ValueError("success tolerance must be an integer greater than 0")
        if self.failure_tolerance <= 0:
            raise ValueError("failure tolerance must be an integer greater than 0")
        self.L = self.L_init
        self.success_counter = 0
        self.failure_counter = 0
        self._y_min = math.inf
        self.location: Optional[torch.Tensor] = None
        self._needs_init = True

    @property
    def requires_initialization(self) -> bool:
        return self._needs_init

    def _lengthscale_weights(
        self, models: Optional[Mapping[Tag, ProbabilisticModel]]
    ) -> torch.Tensor:
        """The model's lengthscales over their geometric mean (ones without a kernel)."""
        g = self.global_search_space
        ones = torch.ones(g.dimension, dtype=g.dtype, device=g.device)
        _, model = get_value_for_tag(models, OBJECTIVE)
        if model is None or not hasattr(model, "get_kernel"):
            return ones
        try:
            ls = torch.broadcast_to(
                torch.atleast_1d(model.get_kernel().lengthscales), (g.dimension,)
            ).to(dtype=g.dtype, device=g.device)
        except (AttributeError, RuntimeError, NotImplementedError):
            return ones
        return ls / torch.exp(torch.mean(torch.log(torch.clamp_min(ls, 1e-12))))

    def _fallback_location(self) -> torch.Tensor:
        """The centre of a region with no data yet: one draw of a generator seeded with 0."""
        g = self.global_search_space
        return g.sample(torch.Generator(device=g.device).manual_seed(0), 1)[0]

    def _resize(self, models, datasets) -> None:
        ds = self._get_tagged_dataset(datasets)
        if ds is not None and len(ds) > 0:
            qp, obs = ds.astuple()
            qp = self.with_input_active_dims(qp)
            idx = int(torch.argmin(obs[:, 0]))
            self.location = qp[idx]
            self._y_min = min(self._y_min, float(obs[idx, 0]))
        elif self.location is None:
            self.location = self._fallback_location()
        half = 0.5 * self.L * self._lengthscale_weights(models)
        g = self.global_search_space
        self._set_bounds(
            torch.maximum(self.location - half, g.lower),
            torch.minimum(self.location + half, g.upper),
        )

    def initialize(self, models=None, datasets=None) -> None:
        self.L = self.L_init
        self.success_counter = 0
        self.failure_counter = 0
        self._y_min = math.inf
        self._resize(models, datasets)
        self._needs_init = False

    def update(self, models=None, datasets=None) -> None:
        ds = self._get_tagged_dataset(datasets)
        if ds is None or len(ds) == 0:
            return
        y_new = float(torch.min(ds.trimmed_observations[:, 0]))
        if _is_improvement(y_new, self._y_min, 1e-10 * abs(self._y_min)):
            self.success_counter += 1
            self.failure_counter = 0
        else:
            self.failure_counter += 1
            self.success_counter = 0
        if self.success_counter >= self.success_tolerance:
            self.L = min(2.0 * self.L, self.L_max)
            self.success_counter = 0
        elif self.failure_counter >= self.failure_tolerance:
            self.L = self.L / 2.0
            self.failure_counter = 0
        if self.L < self.L_min:
            self._needs_init = True
            self.initialize(models, datasets)
            return
        self._resize(models, datasets)


# -- discrete regions ------------------------------------------------------------------


class UpdatableTrustRegionDiscrete(GeneralDiscreteSearchSpace, UpdatableTrustRegion):
    """A trust region over a finite global point set: the points near a location
    (Euclidean distance over normalized numeric coordinates, Hamming distance over
    categories)."""

    def __init__(
        self,
        global_search_space: GeneralDiscreteSearchSpace,
        region_index: Optional[int] = None,
    ):
        self._global_search_space = global_search_space
        GeneralDiscreteSearchSpace.__init__(self, global_search_space.points)
        UpdatableTrustRegion.__init__(self, region_index)

    @property
    def global_search_space(self) -> GeneralDiscreteSearchSpace:
        return self._global_search_space

    def _distances(self, location: torch.Tensor) -> torch.Tensor:
        """The distance of every global point to ``location``."""
        g = self._global_search_space
        pts = g.points
        if isinstance(g, CategoricalSearchSpace):
            return torch.sum(pts != location[None, :], dim=-1).to(pts.dtype)
        extent = torch.clamp_min(g.upper - g.lower, 1e-12)
        return torch.linalg.norm((pts - location[None, :]) / extent, dim=-1)

    def _select(self, keep: torch.Tensor) -> None:
        if not bool(keep.any()):
            keep = keep.clone()
            keep[0] = True
        self._points = self._global_search_space.points[keep]

    def _random_index(self) -> int:
        """An index of the global point set, drawn from the region's generator."""
        n = self._global_search_space.points.shape[0]
        return int(torch.randint(0, n, (), generator=self._generator, device=self._generator.device))


class FixedPointTrustRegionDiscrete(UpdatableTrustRegionDiscrete):
    """One random point of the global set, which never moves."""

    def __init__(
        self,
        global_search_space: GeneralDiscreteSearchSpace,
        region_index: Optional[int] = None,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(global_search_space, region_index)
        self._generator = generator_for(generator, global_search_space.device)

    def initialize(self, models=None, datasets=None) -> None:
        idx = self._random_index()
        self._points = self._global_search_space.points[idx : idx + 1]

    def update(self, models=None, datasets=None) -> None:
        pass


class SingleObjectiveTrustRegionDiscrete(UpdatableTrustRegionDiscrete):
    """A discrete region whose radius ``eps`` (in normalized distance; in categories,
    ``eps`` times the dimension and at least 1) grows on a success and shrinks on a
    failure, as the hypercube region's does."""

    def __init__(
        self,
        global_search_space: GeneralDiscreteSearchSpace,
        beta: float = 0.7,
        kappa: float = 1e-4,
        zeta: float = 0.5,
        min_eps: float = 1e-2,
        region_index: Optional[int] = None,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(global_search_space, region_index)
        self._beta = beta
        self._kappa = kappa
        self._zeta = zeta
        self._min_eps = min_eps
        self._generator = generator_for(generator, global_search_space.device)
        self._needs_init = True
        self._y_min = math.inf
        self.location: Optional[torch.Tensor] = None
        self.eps: float = zeta

    @property
    def requires_initialization(self) -> bool:
        return self._needs_init

    def _resize(self) -> None:
        d = self._distances(self.location)
        if isinstance(self._global_search_space, CategoricalSearchSpace):
            radius = max(self.eps * self._global_search_space.dimension, 1.0)
        else:
            radius = self.eps
        self._select(d <= radius)

    def _region_min(self, datasets):
        ds = self._get_tagged_dataset(datasets)
        if ds is None or len(ds) == 0:
            return None, math.inf
        qp, obs = ds.astuple()
        qp = self.with_input_active_dims(qp)
        inside = GeneralDiscreteSearchSpace._contains(self, qp)
        if not bool(inside.any()):
            return None, math.inf
        qp_in, obs_in = qp[inside], obs[inside, 0]
        idx = int(torch.argmin(obs_in))
        return qp_in[idx], float(obs_in[idx])

    def initialize(self, models=None, datasets=None) -> None:
        self.location = self._global_search_space.points[self._random_index()]
        self.eps = self._zeta
        self._resize()
        self._y_min = math.inf  # a fresh region: the first update is a success
        self._needs_init = False

    def update(self, models=None, datasets=None) -> None:
        best_point, y_new = self._region_min(datasets)
        if best_point is not None and _is_improvement(
            y_new, self._y_min, self._kappa * abs(self._y_min)
        ):
            self.location = best_point
            self.eps /= self._beta
            self._y_min = y_new
        else:
            self.eps *= self._beta
        if self.eps < self._min_eps:
            self._needs_init = True
            self.initialize(models, datasets)
            return
        self._resize()


# -- product regions -------------------------------------------------------------------


class UpdatableTrustRegionProduct(TaggedProductSearchSpace, UpdatableTrustRegion):
    """A product of regions, one per component of a mixed global product space; each
    member reads its own columns of the data."""

    def __init__(
        self,
        regions: Sequence[UpdatableTrustRegion],
        tags: Optional[Sequence[str]] = None,
        region_index: Optional[int] = None,
    ):
        self._regions = list(regions)
        TaggedProductSearchSpace.__init__(self, list(regions), tags)
        UpdatableTrustRegion.__init__(self, region_index)
        for r in self._regions:
            r.region_index = region_index

    @property
    def regions(self) -> Mapping[str, UpdatableTrustRegion]:
        return {t: self._spaces[t] for t in self._tags}

    @property
    def requires_initialization(self) -> bool:
        return any(r.requires_initialization for r in self._regions)

    def _sync(self) -> None:
        """Recompute the product's geometry after its members moved."""
        TaggedProductSearchSpace.__init__(self, self._regions, self._tags)

    def _assign_active_dims(self) -> None:
        for tag, r in zip(self._tags, self._regions):
            r.input_active_dims = self.subspace_dimension_range(tag)

    def initialize(self, models=None, datasets=None) -> None:
        self._assign_active_dims()
        for r in self._regions:
            r.region_index = self.region_index
            r.initialize(models, datasets)
        self._sync()

    def update(self, models=None, datasets=None) -> None:
        self._assign_active_dims()
        for r in self._regions:
            r.update(models, datasets)
        self._sync()


class BatchTrustRegionProduct(BatchTrustRegion):
    """The batch trust-region rule over product regions of a mixed space. By default,
    region ``i`` pairs a :class:`SingleObjectiveTrustRegionBox` (generator seeded with
    ``i``) for each continuous component with a :class:`SingleObjectiveTrustRegionDiscrete`
    (seeded with ``1000 + i``) for each discrete one, and each region has its own
    :class:`EfficientGlobalOptimization`."""

    def _make_default_subspaces(self, search_space):
        if not isinstance(search_space, TaggedProductSearchSpace):
            raise ValueError("BatchTrustRegionProduct requires a TaggedProductSearchSpace")
        device = search_space.device
        subspaces = []
        for i in range(self._num_regions):
            regions = []
            for tag in search_space.subspace_tags:
                sub = search_space.get_subspace(tag)
                if isinstance(sub, GeneralDiscreteSearchSpace):
                    regions.append(SingleObjectiveTrustRegionDiscrete(
                        sub, generator=torch.Generator(device=device).manual_seed(1000 + i)
                    ))
                else:
                    regions.append(SingleObjectiveTrustRegionBox(
                        sub, generator=torch.Generator(device=device).manual_seed(i)
                    ))
            subspaces.append(UpdatableTrustRegionProduct(
                regions, tags=list(search_space.subspace_tags), region_index=i
            ))
        return tuple(subspaces)

    def _make_default_rule(self):
        return [EfficientGlobalOptimization() for _ in range(self._num_regions)]

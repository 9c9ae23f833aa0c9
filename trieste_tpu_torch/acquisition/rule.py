"""Acquisition rules: how the query points of each step are chosen (counterpart of
:mod:`trieste_tpu.acquisition.rule`).

The rule ABCs and the point-selection rules: :class:`EfficientGlobalOptimization`,
:class:`RandomSampling`, :class:`DiscreteThompsonSampling`, the asynchronous rules and
:class:`BatchHypervolumeSharpeRatioIndicator` (qHSRI). The trust-region rules implement
:class:`LocalDatasetsAcquisitionRule` in :mod:`.trust_region`.

A rule with state follows the functional ``State`` protocol: ``acquire`` may return a
callable ``state -> (state, points)``.

>>> state = AsynchronousRuleState(None)
>>> state.has_pending_points
False
>>> state = state.add_pending_points(torch.tensor([[0.0, 0.0], [1.0, 1.0]]))
>>> tuple(state.pending_points.shape)
(2, 2)
>>> state = state.remove_points(torch.tensor([[1.0, 1.0]]))  # its observation arrived
>>> tuple(state.pending_points.shape)
(1, 2)
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..data import Dataset
from ..logging import deferred_histogram
from ..models.interfaces import ProbabilisticModel
from ..observer import OBJECTIVE
from ..space import SearchSpace
from ..types import Tag
from ..utils.misc import generator_for
from .interface import (
    AcquisitionFunction,
    AcquisitionFunctionBuilder,
    GreedyAcquisitionFunctionBuilder,
    SingleModelAcquisitionBuilder,
    SingleModelGreedyAcquisitionBuilder,
    VectorizedAcquisitionFunctionBuilder,
)
from .optimizer import (
    AcquisitionOptimizer,
    automatic_optimizer_selector,
    batchify_joint,
    batchify_vectorize,
)
from .sampler import ExactThompsonSampler, ThompsonSampler


def _check_num_query_points(num_query_points: int) -> None:
    if num_query_points <= 0:
        raise ValueError(
            f"Number of query points must be greater than 0, got {num_query_points}"
        )


class AcquisitionRule(ABC):
    """The mechanism that chooses the query points of each step."""

    @abstractmethod
    def acquire(
        self,
        search_space: SearchSpace,
        models: Mapping[Tag, ProbabilisticModel],
        datasets: Optional[Mapping[Tag, Dataset]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Return query points ``[B, D]`` or a ``State`` callable."""

    def acquire_single(
        self,
        search_space: SearchSpace,
        model: ProbabilisticModel,
        dataset: Optional[Dataset] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """:meth:`acquire` for one model and dataset under the ``OBJECTIVE`` tag."""
        if isinstance(dataset, dict) or isinstance(model, dict):
            raise ValueError(
                "AcquisitionRule.acquire_single method does not support multiple datasets "
                "or models: use acquire instead"
            )
        return self.acquire(
            search_space,
            {OBJECTIVE: model},
            {OBJECTIVE: dataset} if dataset is not None else None,
            generator=generator,
        )

    def filter_datasets(
        self, models: Mapping[Tag, ProbabilisticModel], datasets: Mapping[Tag, Dataset]
    ):
        """Filter the datasets before the models are updated: the datasets, or a ``State``
        callable that gives them (default: unchanged)."""
        return datasets


class LocalDatasetsAcquisitionRule(AcquisitionRule):
    """Marker ABC for rules that need per-region local datasets."""

    @property
    @abstractmethod
    def num_local_datasets(self) -> int:
        ...

    @abstractmethod
    def initialize_subspaces(self, search_space: SearchSpace) -> None:
        ...


class EfficientGlobalOptimization(AcquisitionRule):
    """The default rule: build an acquisition function (expected improvement unless
    another builder is given) and maximize it.

    With ``num_query_points > 1`` a vectorized builder is optimized slice by slice
    (:func:`batchify_vectorize`), a greedy builder point by point with the points chosen
    so far pending, and any other builder jointly over ``space ** B``
    (:func:`batchify_joint`).
    """

    def __init__(
        self,
        builder: Optional[
            Union[
                AcquisitionFunctionBuilder,
                GreedyAcquisitionFunctionBuilder,
                SingleModelAcquisitionBuilder,
                SingleModelGreedyAcquisitionBuilder,
            ]
        ] = None,
        optimizer: Optional[AcquisitionOptimizer] = None,
        num_query_points: int = 1,
        initial_acquisition_function: Optional[AcquisitionFunction] = None,
    ):
        _check_num_query_points(num_query_points)
        if builder is None:
            if num_query_points != 1:
                raise ValueError(
                    "An acquisition function builder must be specified for batch sizes "
                    "greater than one"
                )
            from .function.function import ExpectedImprovement

            builder = ExpectedImprovement()
        if isinstance(builder, (SingleModelAcquisitionBuilder, SingleModelGreedyAcquisitionBuilder)):
            builder = builder.using(OBJECTIVE)
        optimizer = optimizer or automatic_optimizer_selector
        if num_query_points > 1:
            if isinstance(builder, VectorizedAcquisitionFunctionBuilder):
                optimizer = batchify_vectorize(optimizer, num_query_points)
            elif not isinstance(builder, GreedyAcquisitionFunctionBuilder):
                optimizer = batchify_joint(optimizer, num_query_points)
        self._builder = builder
        self._optimizer = optimizer
        self._num_query_points = num_query_points
        self._acquisition_function = initial_acquisition_function

    @property
    def acquisition_function(self) -> Optional[AcquisitionFunction]:
        return self._acquisition_function

    @property
    def num_query_points(self) -> int:
        return self._num_query_points

    def acquire(
        self,
        search_space: SearchSpace,
        models: Mapping[Tag, ProbabilisticModel],
        datasets: Optional[Mapping[Tag, Dataset]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        generator = generator_for(generator, search_space.device)
        greedy = isinstance(self._builder, GreedyAcquisitionFunctionBuilder)
        extra = (None,) if greedy else ()  # a greedy step starts with no pending points
        if self._acquisition_function is None:
            self._acquisition_function = self._builder.prepare_acquisition_function(
                models, datasets, *extra
            )
        else:
            self._acquisition_function = self._builder.update_acquisition_function(
                self._acquisition_function, models, datasets, *extra
            )
        points = self._optimizer(search_space, self._acquisition_function, generator=generator)
        if greedy:
            for _ in range(self._num_query_points - 1):
                self._acquisition_function = self._builder.update_acquisition_function(
                    self._acquisition_function, models, datasets, pending_points=points,
                    new_optimization_step=False,
                )
                chosen = self._optimizer(
                    search_space, self._acquisition_function, generator=generator
                )
                points = torch.cat([points, chosen])
        # deferred: read at the loop's per-step flush, not in the middle of the step
        deferred_histogram("EGO.query_points", points)
        return points

    def __repr__(self) -> str:
        return (
            f"EfficientGlobalOptimization({self._builder!r}, {self._optimizer!r}, "
            f"{self._num_query_points!r})"
        )


class RandomSampling(AcquisitionRule):
    """Uniform random baseline."""

    def __init__(self, num_query_points: int = 1):
        _check_num_query_points(num_query_points)
        self._num_query_points = num_query_points

    def acquire(self, search_space, models, datasets=None, generator=None) -> torch.Tensor:
        generator = generator_for(generator, search_space.device)
        return search_space.sample(generator, self._num_query_points)

    def __repr__(self) -> str:
        return f"RandomSampling({self._num_query_points!r})"


class DiscreteThompsonSampling(AcquisitionRule):
    """Thompson sampling over a random finite discretization of the space."""

    def __init__(
        self,
        num_search_space_samples: int,
        num_query_points: int,
        thompson_sampler: Optional[ThompsonSampler] = None,
    ):
        if num_search_space_samples <= 0:
            raise ValueError(
                f"Search space must be greater than 0, got {num_search_space_samples}"
            )
        _check_num_query_points(num_query_points)
        if thompson_sampler is not None and thompson_sampler.sample_min_value:
            raise ValueError("Thompson sampling requires a minimizer (not min-value) sampler")
        self._num_search_space_samples = num_search_space_samples
        self._num_query_points = num_query_points
        self._thompson_sampler = thompson_sampler or ExactThompsonSampler()

    def acquire(self, search_space, models, datasets=None, generator=None) -> torch.Tensor:
        if models.keys() != {OBJECTIVE}:
            raise ValueError(
                f"dict of models must contain the single key {OBJECTIVE!r}, "
                f"got keys {models.keys()}"
            )
        if datasets is None or datasets.keys() != {OBJECTIVE}:
            raise ValueError(f"datasets must contain the single key {OBJECTIVE!r}")
        generator = generator_for(generator, search_space.device)
        candidates = search_space.sample(generator, self._num_search_space_samples)
        return self._thompson_sampler.sample(
            models[OBJECTIVE], self._num_query_points, candidates, generator=generator
        )

    def __repr__(self) -> str:
        return (
            f"DiscreteThompsonSampling({self._num_search_space_samples!r}, "
            f"{self._num_query_points!r}, {self._thompson_sampler!r})"
        )


@dataclass(frozen=True)
class AsynchronousRuleState:
    """The pending points of asynchronous Bayesian optimization: asked for, not yet
    observed."""

    pending_points: Optional[torch.Tensor] = None  # [P, D]

    @property
    def has_pending_points(self) -> bool:
        return self.pending_points is not None and self.pending_points.shape[0] > 0

    def remove_points(self, points_to_remove: torch.Tensor) -> "AsynchronousRuleState":
        """Drop the pending points that were observed: for each observed point the first
        pending one that is close to it. Matched on the host, once per ``acquire``."""
        if not self.has_pending_points:
            return self
        pending = self.pending_points.detach().cpu().numpy()
        keep = np.ones(len(pending), bool)
        for row in points_to_remove.detach().cpu().numpy():
            matches = np.where(keep & np.all(np.isclose(pending, row), axis=-1))[0]
            if len(matches):
                keep[matches[0]] = False
        return AsynchronousRuleState(
            self.pending_points[torch.as_tensor(keep, device=self.pending_points.device)]
        )

    def add_pending_points(self, new_points: torch.Tensor) -> "AsynchronousRuleState":
        new = torch.atleast_2d(new_points)
        if not self.has_pending_points:
            return AsynchronousRuleState(new)
        return AsynchronousRuleState(torch.cat([self.pending_points, new]))


AsynchronousStateFunc = Callable[
    [Optional[AsynchronousRuleState]], Tuple[AsynchronousRuleState, torch.Tensor]
]


def _without_observed(
    state: Optional[AsynchronousRuleState], datasets: Optional[Mapping[Tag, Dataset]]
) -> AsynchronousRuleState:
    state = state or AsynchronousRuleState(None)
    if datasets is not None and OBJECTIVE in datasets:
        state = state.remove_points(datasets[OBJECTIVE].trimmed_query_points)
    return state


class AsynchronousOptimization(AcquisitionRule):
    """Asynchronous BO with batch (not greedy) acquisition functions: the pending points
    are prepended to every candidate batch and only the new tail is optimized."""

    def __init__(
        self,
        builder: Optional[Union[AcquisitionFunctionBuilder, SingleModelAcquisitionBuilder]] = None,
        optimizer: Optional[AcquisitionOptimizer] = None,
        num_query_points: int = 1,
    ):
        _check_num_query_points(num_query_points)
        if builder is None:
            from .function.function import BatchMonteCarloExpectedImprovement

            builder = BatchMonteCarloExpectedImprovement(10_000)
        if isinstance(builder, SingleModelAcquisitionBuilder):
            builder = builder.using(OBJECTIVE)
        self._builder = builder
        self._optimizer = batchify_joint(optimizer or automatic_optimizer_selector, num_query_points)
        self._num_query_points = num_query_points
        self._acquisition_function: Optional[AcquisitionFunction] = None

    def acquire(self, search_space, models, datasets=None, generator=None) -> AsynchronousStateFunc:
        generator = generator_for(generator, search_space.device)
        if self._acquisition_function is None:
            self._acquisition_function = self._builder.prepare_acquisition_function(
                models, datasets
            )
        else:
            self._acquisition_function = self._builder.update_acquisition_function(
                self._acquisition_function, models, datasets
            )
        acquisition_function = self._acquisition_function

        def state_func(state):
            state = _without_observed(state, datasets)
            acq = acquisition_function
            if state.has_pending_points:
                pending = state.pending_points

                def acq(x: torch.Tensor) -> torch.Tensor:  # [..., B, D]
                    expanded = pending.expand(x.shape[:-2] + pending.shape)
                    return acquisition_function(torch.cat([expanded, x], dim=-2))

            new_points = self._optimizer(search_space, acq, generator=generator)
            return state.add_pending_points(new_points), new_points

        return state_func

    def __repr__(self) -> str:
        return f"AsynchronousOptimization({self._builder!r}, {self._num_query_points!r})"


class AsynchronousGreedy(AcquisitionRule):
    """Asynchronous BO with greedy builders, which take the pending points themselves."""

    def __init__(
        self,
        builder: Union[GreedyAcquisitionFunctionBuilder, SingleModelGreedyAcquisitionBuilder],
        optimizer: Optional[AcquisitionOptimizer] = None,
        num_query_points: int = 1,
    ):
        if builder is None:
            raise ValueError("Builder cannot be None")
        _check_num_query_points(num_query_points)
        if isinstance(builder, SingleModelGreedyAcquisitionBuilder):
            builder = builder.using(OBJECTIVE)
        if not isinstance(builder, GreedyAcquisitionFunctionBuilder):
            # this rule's loop relies on the pending-points protocol of greedy builders
            raise NotImplementedError(
                f"AsynchronousGreedy requires a greedy acquisition builder, "
                f"got {type(builder).__name__}"
            )
        self._builder = builder
        self._optimizer = optimizer or automatic_optimizer_selector
        self._num_query_points = num_query_points
        self._acquisition_function: Optional[AcquisitionFunction] = None

    def acquire(self, search_space, models, datasets=None, generator=None) -> AsynchronousStateFunc:
        generator = generator_for(generator, search_space.device)

        def state_func(state):
            state = _without_observed(state, datasets)
            if self._acquisition_function is None:
                self._acquisition_function = self._builder.prepare_acquisition_function(
                    models, datasets, state.pending_points
                )
            else:
                self._acquisition_function = self._builder.update_acquisition_function(
                    self._acquisition_function, models, datasets, state.pending_points
                )
            new_points = self._optimizer(
                search_space, self._acquisition_function, generator=generator
            )
            state = state.add_pending_points(new_points)
            for _ in range(self._num_query_points - 1):
                self._acquisition_function = self._builder.update_acquisition_function(
                    self._acquisition_function, models, datasets, state.pending_points,
                    new_optimization_step=False,
                )
                batch_point = self._optimizer(
                    search_space, self._acquisition_function, generator=generator
                )
                new_points = torch.cat([new_points, batch_point])
                state = state.add_pending_points(batch_point)
            return state, new_points

        return state_func

    def __repr__(self) -> str:
        return f"AsynchronousGreedy({self._builder!r}, {self._num_query_points!r})"


class BatchHypervolumeSharpeRatioIndicator(AcquisitionRule):
    """qHSRI: a batch drawn from the front of the model's (mean, −std) trade-off by a
    Sharpe-ratio diverse subset. NSGA-II finds the front on the host, each population
    predicted in one batch on the model's device; points unlikely to improve on the best
    observation are filtered out first; the diverse subset's program is
    :meth:`~.multi_objective.Pareto.sample_diverse_subset`."""

    def __init__(
        self,
        num_query_points: int = 1,
        ga_population_size: int = 100,
        ga_n_generations: int = 50,
        filter_threshold: float = 0.1,
    ):
        if num_query_points <= 0:
            raise ValueError(f"num_query_points must be positive, got {num_query_points}")
        if not 0.0 <= filter_threshold < 1.0:
            raise ValueError(f"filter_threshold must be in [0, 1), got {filter_threshold}")
        self._num_query_points = num_query_points
        self._population_size = ga_population_size
        self._n_generations = ga_n_generations
        self._filter_threshold = filter_threshold

    def _find_mean_std_front(
        self, model: ProbabilisticModel, space: SearchSpace
    ) -> Tuple[np.ndarray, np.ndarray]:
        """NSGA-II over (mean, −std): the points of the trade-off between exploitation
        and exploration, and their values ``[K, 2]``."""
        from .multi_objective.nsga2 import nsga2

        def objective(x: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                mean, var = model.predict(
                    torch.as_tensor(x, dtype=space.dtype, device=space.device)
                )
            std = torch.sqrt(torch.clamp_min(var, 1e-24))
            return torch.cat([mean, -std], dim=-1).cpu().numpy()

        return nsga2(
            objective,
            space.lower.cpu().numpy(),
            space.upper.cpu().numpy(),
            population_size=self._population_size,
            num_generations=self._n_generations,
        )

    def acquire(
        self,
        search_space: SearchSpace,
        models: Mapping[Tag, ProbabilisticModel],
        datasets: Optional[Mapping[Tag, Dataset]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        from .multi_objective import Pareto

        if models.keys() != {OBJECTIVE}:
            raise ValueError(f"dict of models must contain the single key {OBJECTIVE!r}")
        if datasets is None or OBJECTIVE not in datasets or len(datasets[OBJECTIVE]) == 0:
            raise ValueError("qHSRI requires a non-empty objective dataset")
        points, front = self._find_mean_std_front(models[OBJECTIVE], search_space)
        means, stds = front[:, :1], -front[:, 1:]

        # keep the points likely enough to improve on the best observation
        eta = float(torch.min(datasets[OBJECTIVE].trimmed_observations))
        pi = torch.special.ndtr(torch.as_tensor((eta - means) / stds)).numpy()[:, 0]
        keep = pi >= self._filter_threshold
        if keep.sum() < self._num_query_points:
            keep = np.argsort(-pi)[: max(self._num_query_points, 5)]
        points, means, stds = points[keep], means[keep], stds[keep]

        front_vals = np.concatenate([means, -stds], axis=-1)
        pareto = Pareto(torch.as_tensor(front_vals))
        _, counts = pareto.sample_diverse_subset(self._num_query_points, allow_repeats=True)
        # each sampled front row back to its query point
        chosen: list = []
        for row, count in zip(pareto.front.numpy(), counts.numpy()):
            if count > 0:
                idx = int(np.argmin(np.linalg.norm(front_vals - row[None, :], axis=-1)))
                chosen.extend([points[idx]] * int(count))
        return torch.as_tensor(
            np.stack(chosen[: self._num_query_points]), dtype=search_space.dtype,
            device=search_space.device,
        )

    def __repr__(self) -> str:
        return (
            f"BatchHypervolumeSharpeRatioIndicator({self._num_query_points!r}, "
            f"{self._population_size!r}, {self._n_generations!r}, "
            f"{self._filter_threshold!r})"
        )

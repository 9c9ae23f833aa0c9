"""The closed-loop Bayesian optimizer (counterpart of :mod:`trieste_tpu.bayesian_optimizer`).

Per step: early-stop check → record the state → ``rule.acquire`` → observer → dataset
append → model update and training → summaries. Any exception ends the run as an
``Err`` result that carries the history so far.
"""
from __future__ import annotations

import copy
import traceback
from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .data import Dataset
from .logging import flush_deferred_summaries, get_tensorboard_writer, scalar, set_step_number
from .models.interfaces import ProbabilisticModel, TrainableProbabilisticModel
from .observer import OBJECTIVE, Observer
from .space import SearchSpace
from .types import Tag
from .utils.misc import Err, LocalizedTag, Ok, Result, Timer

EarlyStopCallback = Callable[[Mapping[Tag, Dataset], Mapping[Tag, ProbabilisticModel]], bool]


@dataclass(frozen=True)
class Record:
    """The data and models at a BO step."""

    datasets: Mapping[Tag, Dataset]
    models: Mapping[Tag, ProbabilisticModel]

    @property
    def dataset(self) -> Dataset:
        if len(self.datasets) == 1:
            return next(iter(self.datasets.values()))
        raise ValueError(f"expected a single dataset, found {len(self.datasets)}")

    @property
    def model(self) -> ProbabilisticModel:
        if len(self.models) == 1:
            return next(iter(self.models.values()))
        raise ValueError(f"expected a single model, found {len(self.models)}")


class OptimizationResult:
    """The final :class:`Record` (or the error that ended the run) and the step history."""

    def __init__(self, final_result: Result[Record], history: Sequence[Record]):
        self.final_result = final_result
        self.history = list(history)

    @property
    def is_ok(self) -> bool:
        return self.final_result.is_ok

    @property
    def is_err(self) -> bool:
        return self.final_result.is_err

    def try_get_final_dataset(self) -> Dataset:
        return self.final_result.unwrap().dataset

    def try_get_final_model(self) -> ProbabilisticModel:
        return self.final_result.unwrap().model

    def try_get_optimal_point(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(query point, observation, index) of the minimum observation."""
        dataset = self.try_get_final_dataset()
        if dataset.num_outputs != 1:
            raise ValueError("expected a single objective")
        qp, obs = dataset.astuple()
        idx = torch.argmin(obs[:, 0])
        return qp[idx], obs[idx], idx


class BayesianOptimizer:
    """The closed-loop optimizer."""

    def __init__(self, observer: Observer, search_space: SearchSpace):
        self._observer = observer
        self._search_space = search_space

    def __repr__(self) -> str:
        return f"BayesianOptimizer({self._observer!r}, {self._search_space!r})"

    def optimize(
        self,
        num_steps: int,
        datasets: Union[Mapping[Tag, Dataset], Dataset],
        models: Union[Mapping[Tag, TrainableProbabilisticModel], TrainableProbabilisticModel],
        acquisition_rule: Optional[object] = None,
        *,
        track_state: bool = True,
        early_stop_callback: Optional[EarlyStopCallback] = None,
        generator: Optional[torch.Generator] = None,
    ) -> OptimizationResult:
        """Run ``num_steps`` steps of the loop. ``generator`` (default: seeded from numpy's
        global generator, on the data's device) drives the acquisition's randomness."""
        if isinstance(datasets, Dataset):
            datasets = {OBJECTIVE: datasets}
            models = {OBJECTIVE: models}  # type: ignore[dict-item]
        datasets = dict(datasets)
        models = dict(models)
        if num_steps < 0:
            raise ValueError(f"num_steps must be at least 0, got {num_steps}")
        dataset_globals = {LocalizedTag.from_tag(t).global_tag for t in datasets}
        model_globals = {LocalizedTag.from_tag(t).global_tag for t in models}
        if dataset_globals != model_globals:
            raise ValueError(
                f"datasets and models should cover the same global tags. Got "
                f"{datasets.keys()} and {models.keys()} respectively."
            )
        if not datasets:
            raise ValueError("dicts of datasets and models must be populated.")
        if acquisition_rule is None:
            if datasets.keys() != {OBJECTIVE}:
                raise ValueError(
                    f"Default acquisition requires the single key {OBJECTIVE!r}, "
                    f"got keys {datasets.keys()}"
                )
            from .acquisition.rule import EfficientGlobalOptimization

            acquisition_rule = EfficientGlobalOptimization()
        if generator is None:
            device = next(iter(datasets.values())).device
            generator = torch.Generator(device=device).manual_seed(int(np.random.randint(2**31)))

        history: list[Record] = []
        step = 0
        try:
            with Timer() as initial_fit_timer:
                for tag, model in models.items():
                    model.update(datasets[tag])
                    model.optimize(datasets[tag])
            scalar("wallclock/model_fitting", initial_fit_timer.time)

            for step in range(1, num_steps + 1):
                set_step_number(step)
                if early_stop_callback and early_stop_callback(datasets, models):
                    break
                if track_state:
                    history.append(Record(copy.deepcopy(datasets), copy.deepcopy(models)))

                with Timer() as step_timer:
                    with Timer() as acquire_timer:
                        query_points = acquisition_rule.acquire(
                            self._search_space, models, datasets=datasets, generator=generator
                        )
                    with Timer() as observation_timer:
                        observer_output = self._observer(query_points)
                        tagged_output = (
                            observer_output
                            if isinstance(observer_output, Mapping)
                            else {OBJECTIVE: observer_output}
                        )
                        for tag in datasets:
                            if tag in tagged_output:
                                datasets[tag] = datasets[tag] + tagged_output[tag]
                    with Timer() as fit_timer:
                        for tag, model in models.items():
                            model.update(datasets[tag])
                            model.optimize(datasets[tag])

                if get_tensorboard_writer() is not None:
                    scalar("wallclock/step", step_timer.time)
                    scalar("wallclock/query_point_generation", acquire_timer.time)
                    scalar("wallclock/observation", observation_timer.time)
                    scalar("wallclock/model_fitting", fit_timer.time)
                    flush_deferred_summaries()

        except Exception as error:  # noqa: BLE001 - the loop reports every failure as Err
            print(traceback.format_exc())
            print(f"Optimization failed at step {step}, encountered error: {error}")
            return OptimizationResult(Err(error), history)

        return OptimizationResult(Ok(Record(datasets, models)), history)

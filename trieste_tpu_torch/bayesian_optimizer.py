"""The closed-loop Bayesian optimizer (counterpart of :mod:`trieste_tpu.bayesian_optimizer`).

Per step: early-stop check → record the state → ``rule.acquire`` (a rule with state
returns a function of it) → observer → dataset append → ``rule.filter_datasets`` → model
update and training → summaries (with a writer set: each model's ``log``, the
observations and query points, the wall clocks, then one flush of what the step queued;
pairplots of the observations and the query points where the summary filter admits
``_pairplot`` and matplotlib is installed).
Any exception ends the run as an ``Err`` result that carries the history so far. Records
and results are saved with ``torch.save`` and loaded with ``torch.load``; load only files
that this package wrote.

A rule with local datasets (a trust-region fleet) gets its regions and one local copy of
each global dataset at step 0; its ``[B, V, D]`` points are observed through
:func:`~trieste_tpu_torch.objectives.utils.mk_batch_observer`, which also gives each
region its own new observations.
"""
from __future__ import annotations

import copy
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .acquisition.rule import LocalDatasetsAcquisitionRule
from .acquisition.utils import with_local_datasets
from .data import Dataset
from .logging import (
    deferred_histogram,
    deferred_scalar,
    flush_deferred_summaries,
    get_tensorboard_writer,
    include_summary,
    pyplot,
    scalar,
    set_step_number,
    step_number,
    text,
)
from .models.interfaces import ProbabilisticModel, TrainableProbabilisticModel
from .objectives.utils import mk_batch_observer
from .observer import OBJECTIVE, Observer
from .space import SearchSpace
from .types import Tag
from .utils.misc import Err, LocalizedTag, Ok, Result, Timer, ignoring_local_tags, new_generator

EarlyStopCallback = Callable[
    [Mapping[Tag, Dataset], Mapping[Tag, ProbabilisticModel], Optional[Any]], bool
]


def _single(mapping: Mapping[Tag, Any], what: str) -> Any:
    mapping = ignoring_local_tags(mapping)
    if len(mapping) == 1:
        return next(iter(mapping.values()))
    raise ValueError(f"expected a single {what}, found {len(mapping)}")


@dataclass(frozen=True)
class Record:
    """The data, models and acquisition state at a BO step."""

    datasets: Mapping[Tag, Dataset]
    models: Mapping[Tag, ProbabilisticModel]
    acquisition_state: Optional[Any] = None

    @property
    def dataset(self) -> Dataset:
        """The single dataset, if there is exactly one (ignoring local tags)."""
        return _single(self.datasets, "dataset")

    @property
    def model(self) -> ProbabilisticModel:
        return _single(self.models, "model")

    def save(self, path: Union[str, Path]) -> "FrozenRecord":
        """Write this record to ``path``."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save(self, path)
        return FrozenRecord(Path(path))


@dataclass(frozen=True)
class FrozenRecord:
    """A record on disk, loaded each time it is read."""

    path: Path

    def load(self) -> Record:
        return torch.load(self.path, weights_only=False)

    @property
    def datasets(self) -> Mapping[Tag, Dataset]:
        return self.load().datasets

    @property
    def models(self) -> Mapping[Tag, ProbabilisticModel]:
        return self.load().models

    @property
    def acquisition_state(self) -> Optional[Any]:
        return self.load().acquisition_state

    @property
    def dataset(self) -> Dataset:
        return self.load().dataset

    @property
    def model(self) -> ProbabilisticModel:
        return self.load().model


class OptimizationResult:
    """The final :class:`Record` (or the error that ended the run) and the step history."""

    STEP_GLOB = "step.*.pickle"
    RESULTS_FILENAME = "results.pickle"

    def __init__(
        self, final_result: Result[Record], history: Sequence[Union[Record, FrozenRecord]]
    ):
        self.final_result = final_result
        self.history = list(history)

    def astuple(self) -> Tuple[Result[Record], Sequence[Union[Record, FrozenRecord]]]:
        return self.final_result, self.history

    @property
    def is_ok(self) -> bool:
        return self.final_result.is_ok

    @property
    def is_err(self) -> bool:
        return self.final_result.is_err

    def try_get_final_datasets(self) -> Mapping[Tag, Dataset]:
        return self.final_result.unwrap().datasets

    def try_get_final_dataset(self) -> Dataset:
        return self.final_result.unwrap().dataset

    def try_get_final_models(self) -> Mapping[Tag, ProbabilisticModel]:
        return self.final_result.unwrap().models

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

    @staticmethod
    def step_filename(step: int, num_steps: int) -> str:
        return f"step.{step:0{len(str(num_steps - 1))}d}.pickle"

    def save_result(self, path: Union[str, Path]) -> None:
        """Write the final result only."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save(self.final_result, path)

    def save(self, base_path: Union[str, Path]) -> None:
        """Write the final result and every in-memory record of the history to a
        directory."""
        base = Path(base_path)
        self.save_result(base / self.RESULTS_FILENAME)
        for i, record in enumerate(self.history):
            if not isinstance(record, FrozenRecord):
                record.save(base / self.step_filename(i, len(self.history)))

    @classmethod
    def from_path(cls, base_path: Union[str, Path]) -> "OptimizationResult":
        """Load a result that :meth:`save` wrote."""
        base = Path(base_path)
        try:
            final_result = torch.load(base / cls.RESULTS_FILENAME, weights_only=False)
        except FileNotFoundError as e:
            final_result = Err(e)
        history = [FrozenRecord(p) for p in sorted(base.glob(cls.STEP_GLOB))]
        return cls(final_result, history)


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
        acquisition_state: Optional[Any] = None,
        *,
        track_state: bool = True,
        track_path: Optional[Union[str, Path]] = None,
        fit_model: bool = True,
        fit_initial_model: bool = True,
        early_stop_callback: Optional[EarlyStopCallback] = None,
        start_step: int = 0,
        generator: Optional[torch.Generator] = None,
    ) -> OptimizationResult:
        """Run the loop up to step ``num_steps``, from ``start_step``. ``generator``
        (default: seeded from numpy's global generator, on the data's device) drives the
        acquisition's randomness. With ``track_path`` the history is written there and
        kept as :class:`FrozenRecord`."""
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
            generator = new_generator(next(iter(datasets.values())).device)
        # the rows up to these counts are the "initial" group of the pairplot summaries
        initial_counts = {tag: ds.num_points for tag, ds in datasets.items()}

        def filtered(state):
            """The rule's view of the datasets, which may depend on (and move) its state."""
            result = acquisition_rule.filter_datasets(models, datasets)
            if callable(result):
                state, result = result(state)
            return state, dict(result)

        def fit(filtered_datasets) -> None:
            for tag, model in models.items():
                _, tag_data = _match_tag(filtered_datasets, tag)
                model.update(tag_data)
                optimize_model_and_save_result(model, tag_data)

        history: list = []
        if get_tensorboard_writer() is not None:
            text("metadata", f"Observer: {self._observer}\nSearch space: {self._search_space}\n"
                             f"Device: {_describe(next(iter(datasets.values())).device)}")
        step = start_step
        try:
            if isinstance(acquisition_rule, LocalDatasetsAcquisitionRule) and start_step == 0:
                acquisition_rule.initialize_subspaces(self._search_space)
                datasets = with_local_datasets(datasets, acquisition_rule.num_local_datasets)
            acquisition_state, filtered_datasets = filtered(acquisition_state)
            if fit_model and fit_initial_model and start_step == 0:
                with Timer() as initial_fit_timer:
                    fit(filtered_datasets)
                with step_number(0):
                    scalar("wallclock/model_fitting", initial_fit_timer.time)

            for step in range(start_step + 1, num_steps + 1):
                set_step_number(step)
                if early_stop_callback and early_stop_callback(
                    datasets, models, acquisition_state
                ):
                    break
                if track_state:
                    try:
                        record = Record(
                            copy.deepcopy(datasets), copy.deepcopy(models),
                            copy.deepcopy(acquisition_state),
                        )
                        if track_path is None:
                            history.append(record)
                        else:
                            filename = OptimizationResult.step_filename(step, num_steps)
                            history.append(record.save(Path(track_path) / filename))
                    except Exception as e:
                        raise NotImplementedError(
                            "Failed to save the optimization state; pass "
                            "track_state=False to disable tracking"
                        ) from e

                with Timer() as step_timer:
                    with Timer() as acquire_timer:
                        points_or_stateful = acquisition_rule.acquire(
                            self._search_space, models, datasets=filtered_datasets,
                            generator=generator,
                        )
                        if callable(points_or_stateful):
                            acquisition_state, query_points = points_or_stateful(
                                acquisition_state
                            )
                        else:
                            query_points = points_or_stateful
                    with Timer() as observation_timer:
                        observer_output = self._call_observer(query_points)
                        tagged_output = (
                            observer_output
                            if isinstance(observer_output, Mapping)
                            else {OBJECTIVE: observer_output}
                        )
                        for tag in datasets:
                            if tag in tagged_output:
                                datasets[tag] = datasets[tag] + tagged_output[tag]
                    acquisition_state, filtered_datasets = filtered(acquisition_state)
                    with Timer() as fit_timer:
                        if fit_model:
                            fit(filtered_datasets)

                if get_tensorboard_writer() is not None:
                    write_summary_observations(datasets, models, tagged_output, fit_timer,
                                               initial_counts)
                    write_summary_query_points(datasets, initial_counts)
                    scalar("wallclock/step", step_timer.time)
                    scalar("wallclock/query_point_generation", acquire_timer.time)
                    scalar("wallclock/observation", observation_timer.time)
                    flush_deferred_summaries()  # one read of every queued device value

        except Exception as error:  # noqa: BLE001 - the loop reports every failure as Err
            print(traceback.format_exc())
            print(f"Optimization failed at step {step}, encountered error: {error}")
            return OptimizationResult(Err(error), history)

        return OptimizationResult(Ok(Record(datasets, models, acquisition_state)), history)

    def _call_observer(self, query_points: torch.Tensor):
        if query_points.ndim == 3:  # [B, V, D]: one column per region
            return mk_batch_observer(self._observer)(query_points)
        return self._observer(query_points)

    def continue_optimization(
        self, num_steps: int, previous_result: OptimizationResult, **kwargs: Any
    ) -> OptimizationResult:
        """Resume from a previous result's final record or, if it failed, from the last
        entry of its history; ``kwargs`` go to :meth:`optimize`."""
        if previous_result.is_ok:
            record = previous_result.final_result.unwrap()
            start_step = len(previous_result.history)
        elif previous_result.history:
            last = previous_result.history[-1]
            record = last.load() if isinstance(last, FrozenRecord) else last
            start_step = len(previous_result.history) - 1
        else:
            raise ValueError("previous_result has neither a final result nor history")
        result = self.optimize(
            num_steps, dict(record.datasets), dict(record.models),
            acquisition_state=record.acquisition_state, start_step=start_step, **kwargs,
        )
        result.history = list(previous_result.history[:start_step]) + list(result.history)
        return result


def _match_tag(datasets: Mapping[Tag, Dataset], tag: Tag) -> Tuple[Tag, Dataset]:
    """The data for a tag, falling back from a local tag to its global one."""
    for candidate in (tag, LocalizedTag.from_tag(tag).global_tag):
        if candidate in datasets:
            return candidate, datasets[candidate]
    raise ValueError(f"no dataset found for tag {tag!r}")


def optimize_model_and_save_result(model: TrainableProbabilisticModel, dataset: Dataset) -> Any:
    """Train a model and queue its final loss as a summary."""
    result = model.optimize(dataset)
    if hasattr(result, "loss"):
        deferred_scalar("model.training_loss", result.loss)
    return result


def _describe(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def write_summary_observations(
    datasets: Mapping[Tag, Dataset],
    models: Mapping[Tag, ProbabilisticModel],
    tagged_output: Mapping[Tag, Dataset],
    model_fitting_timer: Timer,
    initial_counts: Optional[Mapping[Tag, int]] = None,
) -> None:
    """Queue each global tag's model summaries (its ``log``) and, per output dimension, its
    new observations with the best of them and the best overall; with two outputs or more,
    a pairplot of the observations (:func:`_pairplot_summary`, non-dominated rows marked);
    write the fit's wall clock."""
    for tag, dataset in ignoring_local_tags(datasets).items():
        obs = dataset.trimmed_observations
        if obs.shape[0] == 0:
            continue
        model = models.get(tag)
        if model is not None and hasattr(model, "log"):
            try:
                model.log(dataset)
            except Exception as e:  # noqa: BLE001 - a summary never stops the loop
                print(f"failed to log model {tag}: {e}")
        L = obs.shape[-1]
        new_obs = tagged_output[tag].trimmed_observations if tag in tagged_output else obs[:0]
        for i in range(L):
            suffix = f"[{i}]" if L > 1 else ""
            if new_obs.shape[0]:
                deferred_histogram(f"{tag}.observation{suffix}/new_observations", new_obs[..., i])
                deferred_scalar(f"{tag}.observation{suffix}/best_new_observation",
                                torch.min(new_obs[..., i]))
            deferred_scalar(f"{tag}.observation{suffix}/best_overall", torch.min(obs[..., i]))
        name = f"{tag}.observations/_pairplot"
        if L >= 2 and include_summary(name):
            _pairplot_summary(name, obs, (initial_counts or {}).get(tag, 0), new_obs.shape[0],
                              mark_non_dominated=True)
    scalar("wallclock/model_fitting", model_fitting_timer.time)


def write_summary_query_points(
    datasets: Mapping[Tag, Dataset], initial_counts: Optional[Mapping[Tag, int]] = None
) -> None:
    """Queue a histogram of each global tag's query points per input dimension and, with
    two dimensions or more, write a pairplot of them (:func:`_pairplot_summary`)."""
    for tag, dataset in ignoring_local_tags(datasets).items():
        qp = dataset.trimmed_query_points
        if qp.shape[0] == 0:
            continue
        for i in range(qp.shape[-1]):
            deferred_histogram(f"{tag}.query_points/[{i}]", qp[:, i])
        name = f"{tag}.query_points/_pairplot"
        if qp.shape[-1] >= 2 and include_summary(name):
            _pairplot_summary(name, qp, (initial_counts or {}).get(tag, 0), 0)


def _pairplot_summary(
    name: str, data: torch.Tensor, num_initial: int, num_new: int,
    mark_non_dominated: bool = False,
) -> None:
    """Write a pairplot of ``data [n, K]`` (copied to the host), its rows grouped as the
    first ``num_initial``, the last ``num_new`` and the old ones between, the non-dominated
    rows marked where asked. Nothing is written without matplotlib; any other failure
    raises."""
    try:
        import matplotlib  # noqa: F401 - the figure needs it
    except ImportError:
        return
    from .acquisition.multi_objective.dominance import non_dominated_mask
    from .experimental.plotting.pairplot import observation_groups, pairplot

    n = data.shape[0]
    num_initial = min(num_initial, n)
    num_new = min(num_new, n - num_initial)
    front = _host(non_dominated_mask(data)) if mark_non_dominated else None
    groups = observation_groups(num_initial, n - num_initial - num_new, num_new, front)
    pyplot(name, pairplot(_host(data), groups))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def stop_at_minimum(
    minimum: Optional[Any] = None,
    minimizers: Optional[Any] = None,
    minimum_rtol: float = 0.005,
    minimum_atol: float = 0.0,
    minimizers_atol: float = 1e-5,
    minimizers_rtol: float = 0.0,
) -> EarlyStopCallback:
    """An early-stop callback: stop once the best observation is close to the known
    ``minimum``, or the best point close to one of the known ``minimizers``."""

    def callback(
        datasets: Mapping[Tag, Dataset],
        _models: Mapping[Tag, ProbabilisticModel],
        _state: Optional[Any],
    ) -> bool:
        tagged = ignoring_local_tags(datasets)
        if OBJECTIVE not in tagged:
            return False
        qp, obs = tagged[OBJECTIVE].astuple()
        if obs.shape[0] == 0:
            return False
        idx = int(torch.argmin(obs[:, 0]))
        best_y, best_x = _host(obs[idx, 0]), _host(qp[idx])
        if minimum is not None and np.allclose(
            best_y, _host(minimum), rtol=minimum_rtol, atol=minimum_atol
        ):
            return True
        if minimizers is not None:
            close = np.isclose(best_x, _host(minimizers), rtol=minimizers_rtol, atol=minimizers_atol)
            if np.any(np.all(close, axis=-1)):
                return True
        return False

    return callback

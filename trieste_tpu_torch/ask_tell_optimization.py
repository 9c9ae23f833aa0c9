"""The open-loop Ask/Tell interface (counterpart of :mod:`trieste_tpu.ask_tell_optimization`).

Users drive the loop themselves (from a lab, a cluster queue or another process) while
the optimizer keeps the models, the datasets and the acquisition state. ``ask`` returns
query points, ``tell`` takes their observations. All of the state round-trips through
:class:`AskTellOptimizerState`.

The optimizer owns a ``torch.Generator`` on the data's device (given, or seeded from
numpy's global generator); every ``ask`` hands it to the rule, which advances it.
"""
from __future__ import annotations

import copy as copy_module
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Tuple, Union

import torch

from .acquisition.rule import (
    AcquisitionRule,
    EfficientGlobalOptimization,
    LocalDatasetsAcquisitionRule,
)
from .acquisition.utils import with_local_datasets
from .bayesian_optimizer import Record, _match_tag, _single, optimize_model_and_save_result
from .data import Dataset
from .logging import flush_deferred_summaries
from .models.interfaces import TrainableProbabilisticModel
from .observer import OBJECTIVE
from .space import SearchSpace
from .types import Tag
from .utils.misc import LocalizedTag, generator_for


@dataclass(frozen=True)
class AskTellOptimizerState:
    """A snapshot of an Ask/Tell run that can be stored and restored."""

    record: Record
    local_data_ixs: Optional[Tuple[torch.Tensor, ...]] = None
    local_data_len: Optional[int] = None


class AskTellOptimizerABC(ABC):
    """The Ask/Tell loop; a subclass says how a model is updated when data arrive."""

    def __init__(
        self,
        search_space: SearchSpace,
        datasets: Union[Mapping[Tag, Dataset], Dataset],
        models: Union[Mapping[Tag, TrainableProbabilisticModel], TrainableProbabilisticModel],
        acquisition_rule: Optional[AcquisitionRule] = None,
        acquisition_state: Optional[Any] = None,
        *,
        fit_model: bool = True,
        track_data: bool = True,
        local_data_ixs: Optional[Tuple[torch.Tensor, ...]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        if isinstance(datasets, Dataset):
            datasets = {OBJECTIVE: datasets}
            models = {OBJECTIVE: models}  # type: ignore[dict-item]
        datasets = dict(datasets)
        models = dict(models)
        if not datasets or not models:
            raise ValueError("dicts of datasets and models must be populated.")
        # compared modulo local tags: a state restored from a run with local datasets
        # carries LocalizedTag datasets next to a single global model
        dataset_gtags = {LocalizedTag.from_tag(tag).global_tag for tag in datasets}
        model_gtags = {LocalizedTag.from_tag(tag).global_tag for tag in models}
        if dataset_gtags != model_gtags:
            raise ValueError(
                f"datasets and models should contain the same keys (modulo local tags). "
                f"Got {datasets.keys()} and {models.keys()} respectively."
            )
        self._search_space = search_space
        self._datasets = datasets
        self._models = models
        self._acquisition_state = acquisition_state
        self._track_data = track_data
        self._generator = generator_for(generator, next(iter(datasets.values())).device)

        if acquisition_rule is None:
            if datasets.keys() != {OBJECTIVE}:
                raise ValueError(
                    f"Default acquisition requires the single key {OBJECTIVE!r}, "
                    f"got keys {datasets.keys()}"
                )
            acquisition_rule = EfficientGlobalOptimization()
        self._acquisition_rule = acquisition_rule
        if isinstance(acquisition_rule, LocalDatasetsAcquisitionRule):
            # the regions, and a local dataset per region: the rows at local_data_ixs[i]
            # where given, else a copy of the global dataset (a restored state already
            # carries its local datasets, which are kept)
            acquisition_rule.initialize_subspaces(search_space)
            self._datasets = with_local_datasets(
                self._datasets, acquisition_rule.num_local_datasets, local_data_ixs
            )

        self._refilter()
        if fit_model:
            self._update_models()

    @abstractmethod
    def update_model(self, model: TrainableProbabilisticModel, dataset: Dataset) -> None:
        """How to (re)train a model when data changes."""

    def _refilter(self) -> None:
        filtered = self._acquisition_rule.filter_datasets(self._models, self._datasets)
        if callable(filtered):
            self._acquisition_state, filtered = filtered(self._acquisition_state)
        self._filtered_datasets = dict(filtered)

    def _update_models(self) -> None:
        for tag, model in self._models.items():
            self.update_model(model, _match_tag(self._filtered_datasets, tag)[1])

    @property
    def datasets(self) -> Mapping[Tag, Dataset]:
        return self._datasets

    @property
    def dataset(self) -> Dataset:
        return _single(self.datasets, "dataset")

    @property
    def models(self) -> Mapping[Tag, TrainableProbabilisticModel]:
        return self._models

    @models.setter
    def models(self, models: Mapping[Tag, TrainableProbabilisticModel]) -> None:
        """Replace the models; the keys must match the current ones exactly."""
        if models.keys() != self._models.keys():
            raise ValueError(
                f"New models contain incorrect keys. Expected {self._models.keys()}, "
                f"received {models.keys()}."
            )
        self._models = dict(models)

    @property
    def model(self) -> TrainableProbabilisticModel:
        return _single(self.models, "model")

    @model.setter
    def model(self, model: TrainableProbabilisticModel) -> None:
        """Replace the model of a single-model optimizer keyed by ``OBJECTIVE``."""
        if self._models.keys() != {OBJECTIVE}:
            raise ValueError(
                f"Expected a single model keyed by {OBJECTIVE!r}, found {self._models.keys()}"
            )
        self._models = {OBJECTIVE: model}

    @property
    def acquisition_state(self) -> Optional[Any]:
        return self._acquisition_state

    @classmethod
    def dataset_len(cls, datasets: Mapping[Tag, Dataset]) -> int:
        """The common size of the global (not local) datasets."""
        lens = {
            tag: len(ds) for tag, ds in datasets.items()
            if not LocalizedTag.from_tag(tag).is_local
        }
        unique = set(lens.values())
        if len(unique) != 1:
            raise ValueError(f"Expected unique global dataset size, got {sorted(unique)}: {lens}")
        return next(iter(unique))

    def to_record(self, copy: bool = True) -> Record:
        """The current datasets, models and acquisition state, copied unless told not to."""
        parts = (self._datasets, self._models, self._acquisition_state)
        return Record(*(copy_module.deepcopy(parts) if copy else parts))

    @classmethod
    def from_record(
        cls,
        record: Record,
        search_space: SearchSpace,
        acquisition_rule: Optional[AcquisitionRule] = None,
        track_data: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> "AskTellOptimizerABC":
        """An optimizer on a record's state. The models are not refitted."""
        return cls(
            search_space, dict(record.datasets), dict(record.models),
            acquisition_rule=acquisition_rule, acquisition_state=record.acquisition_state,
            fit_model=False, track_data=track_data, generator=generator,
        )

    def to_state(self, copy: bool = False) -> AskTellOptimizerState:
        return AskTellOptimizerState(record=self.to_record(copy=copy))

    @classmethod
    def from_state(
        cls,
        state: AskTellOptimizerState,
        search_space: SearchSpace,
        acquisition_rule: Optional[AcquisitionRule] = None,
        track_data: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> "AskTellOptimizerABC":
        """An optimizer on a stored state, ``state.local_data_ixs`` included. The models
        are not refitted."""
        record = state.record
        return cls(
            search_space, dict(record.datasets), dict(record.models),
            acquisition_rule=acquisition_rule, acquisition_state=record.acquisition_state,
            fit_model=False, track_data=track_data, local_data_ixs=state.local_data_ixs,
            generator=generator,
        )

    def ask(self) -> torch.Tensor:
        """Optimize the acquisition function and return the query points."""
        points_or_stateful = self._acquisition_rule.acquire(
            self._search_space, self._models, datasets=self._filtered_datasets,
            generator=self._generator,
        )
        if callable(points_or_stateful):
            self._acquisition_state, points_or_stateful = points_or_stateful(
                self._acquisition_state
            )
        return points_or_stateful

    def tell(self, new_data: Union[Mapping[Tag, Dataset], Dataset]) -> None:
        """Take in new observations, filter the datasets anew and retrain.

        With ``track_data=True`` (the default) ``new_data`` holds only the new
        observations, which are appended; with ``track_data=False`` the caller owns the
        data and passes the full updated datasets, which replace the internal ones.
        """
        if isinstance(new_data, Dataset):
            new_data = {OBJECTIVE: new_data}
        unknown = set(new_data.keys()) - set(self._datasets.keys())
        if unknown:
            # every told tag must address an existing dataset: a localized tag whose base
            # merely exists would have its observations dropped
            raise ValueError(
                f"Unknown tag(s) {unknown!r} in new data; expected keys {self._datasets.keys()}"
            )
        for tag, ds in new_data.items():
            self._datasets[tag] = self._datasets[tag] + ds if self._track_data else ds
        self._refilter()
        self._update_models()
        flush_deferred_summaries()  # what ask() and the fits queued


class AskTellOptimizer(AskTellOptimizerABC):
    """Ask/Tell with model updating and hyperparameter training."""

    def update_model(self, model: TrainableProbabilisticModel, dataset: Dataset) -> None:
        model.update(dataset)
        optimize_model_and_save_result(model, dataset)


class AskTellOptimizerNoTraining(AskTellOptimizerABC):
    """Ask/Tell that never updates or retrains its models."""

    def update_model(self, model: TrainableProbabilisticModel, dataset: Dataset) -> None:
        pass

"""Encoded-model wrappers (counterpart of :mod:`trieste_tpu.models.encoders`): a model
trained over encoded inputs (one-hot, say) that the loop drives in the raw space (category
indices, say). Every call encodes the points before it reaches the model.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..data import Dataset
from ..space import EncoderFunction


def encode_dataset(dataset: Dataset, encoder: EncoderFunction) -> Dataset:
    """``dataset`` with its query points encoded."""
    qp, obs = dataset.astuple()
    return Dataset.from_arrays(encoder(qp), obs)


class EncodedProbabilisticModel:
    """A model whose public interface takes points before encoding; every other attribute
    (``get_kernel``, ``get_observation_noise``, ...) is the wrapped model's."""

    def __init__(self, model, encoder: EncoderFunction):
        self._model = model
        self._encoder = encoder

    @property
    def encoder(self) -> EncoderFunction:
        return self._encoder

    @property
    def wrapped_model(self):
        return self._model

    def predict(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._model.predict(self._encoder(query_points))

    def predict_joint(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._model.predict_joint(self._encoder(query_points))

    def predict_y(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._model.predict_y(self._encoder(query_points))

    def sample(
        self, generator: Optional[torch.Generator], query_points: torch.Tensor, num_samples: int
    ) -> torch.Tensor:
        return self._model.sample(generator, self._encoder(query_points), num_samples)

    def log(self, dataset: Optional[Dataset] = None) -> None:
        self._model.log(encode_dataset(dataset, self._encoder) if dataset else None)

    def __getattr__(self, name: str):
        # a copy is made without __init__: until its state is set there is nothing to delegate to
        if "_model" not in self.__dict__:
            raise AttributeError(name)
        return getattr(self._model, name)

    def __repr__(self) -> str:
        return f"EncodedProbabilisticModel({self._model!r})"


class EncodedTrainableProbabilisticModel(EncodedProbabilisticModel):
    """The trainable variant: the data is encoded before ``update`` and ``optimize``."""

    def update(self, dataset: Dataset) -> None:
        self._model.update(encode_dataset(dataset, self._encoder))

    def optimize(self, dataset: Dataset):
        return self._model.optimize(encode_dataset(dataset, self._encoder))

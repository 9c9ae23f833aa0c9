"""Core type aliases (counterpart of :mod:`trieste_tpu.types`)."""
from __future__ import annotations

from typing import Callable, Hashable, Tuple, TypeVar, Union

import numpy as np
import torch

TensorType = Union[torch.Tensor, np.ndarray]
"""Type alias for tensor-like values accepted by the framework."""

S = TypeVar("S")
T = TypeVar("T")

State = Callable[[S], Tuple[S, T]]
"""A stateful computation: consumes a state, returns the new state and a value."""

Tag = Hashable
"""Type alias for a dataset/model tag."""

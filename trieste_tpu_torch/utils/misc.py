"""Miscellaneous core utilities (counterpart of :mod:`trieste_tpu.utils.misc`): the
``Result`` monad, ``Timer``, ``LocalizedTag``, the dtype policy and
``flatten_leading_dims``.

>>> Ok(3).unwrap()
3
>>> Err(ValueError("boom")).is_err
True
>>> flat, unflatten = flatten_leading_dims(torch.zeros(2, 3, 4))
>>> tuple(flat.shape), tuple(unflatten(flat).shape)
((6, 4), (2, 3, 4))
"""
from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable, Generic, NoReturn, Optional, Tuple, TypeVar

import torch

from ..types import Tag

T = TypeVar("T")


class _Defaults:
    """Default constants. ``JITTER`` is added to Gram-matrix diagonals before Cholesky;
    :func:`jitter_for` makes it dtype-aware."""

    JITTER: float = 1e-6


DEFAULTS = _Defaults()


def default_float() -> torch.dtype:
    """The default floating dtype: torch's default dtype (float32 unless the caller set
    float64), the counterpart of the JAX package's x64 switch."""
    return torch.get_default_dtype()


def jitter_for(dtype: torch.dtype) -> float:
    """Cholesky jitter: 1e-6 for float64, a larger 1e-5 for float32."""
    return DEFAULTS.JITTER if dtype.itemsize >= 8 else 1e-5


class Result(ABC, Generic[T]):
    """Success/failure wrapper."""

    @property
    @abstractmethod
    def is_ok(self) -> bool:
        """`True` iff this is an :class:`Ok`."""

    @property
    def is_err(self) -> bool:
        return not self.is_ok

    @abstractmethod
    def unwrap(self) -> T:
        """Return the wrapped value, or raise the wrapped error."""


@dataclass(frozen=True)
class Ok(Result[T]):
    value: T

    @property
    def is_ok(self) -> bool:
        return True

    def unwrap(self) -> T:
        return self.value


@dataclass(frozen=True)
class Err(Result[NoReturn]):
    error: Exception

    @property
    def is_ok(self) -> bool:
        return False

    def unwrap(self) -> NoReturn:
        raise self.error


class Timer:
    """Context manager measuring wall-clock time. CUDA work is asynchronous: the timed
    code must end in something that waits for the device for the time to cover it."""

    def __enter__(self) -> "Timer":
        self.start = time.perf_counter()
        self.time = 0.0
        return self

    def __exit__(self, *_: Any) -> None:
        self.time = time.perf_counter() - self.start


@dataclass(frozen=True)
class LocalizedTag:
    """A tag with a global part and an optional local (region) index."""

    global_tag: Tag
    local_index: Optional[int]

    @property
    def is_local(self) -> bool:
        return self.local_index is not None

    @classmethod
    def from_tag(cls, tag: Tag) -> "LocalizedTag":
        return tag if isinstance(tag, LocalizedTag) else cls(tag, None)

    def __str__(self) -> str:
        return f"{self.global_tag}__{self.local_index}" if self.is_local else str(self.global_tag)


def flatten_leading_dims(
    x: torch.Tensor, output_dims: int = 2
) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """Flatten the leading dims of ``x`` down to ``output_dims`` total dims; returns the
    flattened tensor and an unflatten function."""
    if not 1 <= output_dims <= x.ndim:
        raise ValueError(f"output_dims {output_dims} must be in [1, {x.ndim}]")
    leading = x.shape[: x.ndim - output_dims + 1]
    rest = x.shape[x.ndim - output_dims + 1 :]
    flat = x.reshape((-1,) + tuple(rest))

    def unflatten(y: torch.Tensor) -> torch.Tensor:
        return y.reshape(tuple(leading) + tuple(y.shape[1:]))

    return flat, unflatten

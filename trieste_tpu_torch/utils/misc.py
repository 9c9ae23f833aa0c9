"""Miscellaneous core utilities (counterpart of :mod:`trieste_tpu.utils.misc`): the
``Result`` monad, ``Timer``, ``LocalizedTag`` and the tag helpers, the dtype policy,
``flatten_leading_dims``, ``to_numpy`` and the explicit-generator helpers.

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
from typing import Any, Callable, Generic, Mapping, NoReturn, Optional, Tuple, TypeVar, Union

import numpy as np
import torch

from ..types import Tag

T = TypeVar("T")
U = TypeVar("U")
K = TypeVar("K")


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


def map_values(f: Callable[[T], U], mapping: Mapping[K, T]) -> dict[K, U]:
    """Apply ``f`` to every value of ``mapping``."""
    return {k: f(v) for k, v in mapping.items()}


def ignoring_local_tags(mapping: Mapping[Tag, T]) -> dict[Tag, T]:
    """Expose local tags under their global name where no global entry exists."""
    out = {k: v for k, v in mapping.items() if not LocalizedTag.from_tag(k).is_local}
    for k, v in mapping.items():
        ltag = LocalizedTag.from_tag(k)
        if ltag.is_local and ltag.global_tag not in out:
            out[ltag.global_tag] = v
    return out


def get_value_for_tag(
    mapping: Optional[Mapping[Tag, T]], *tags: Tag
) -> Tuple[Optional[Tag], Optional[T]]:
    """The first matching ``(tag, value)`` pair, searching ``tags`` in order (default:
    the ``OBJECTIVE`` tag); ``(None, None)`` if none matches."""
    from ..observer import OBJECTIVE

    if mapping is None:
        return None, None
    for tag in tags or (OBJECTIVE,):
        if tag in mapping:
            return tag, mapping[tag]
    return None, None


def new_generator(
    device: Union[str, torch.device], seed: Optional[int] = None
) -> torch.Generator:
    """A generator on ``device``, seeded with ``seed`` or, without one, from numpy's
    global generator (so ``np.random.seed`` pins a whole run)."""
    seed = int(np.random.randint(2**31)) if seed is None else seed
    return torch.Generator(device=device).manual_seed(seed)


def check_generator(generator: torch.Generator, device: Union[str, torch.device]) -> None:
    """Raise if ``generator`` does not live on ``device``: randomness is drawn where the
    data is, never moved across."""
    if generator.device.type != torch.device(device).type:
        raise ValueError(
            f"the generator is on {generator.device}, the data on {device}: pass a "
            f"torch.Generator(device={str(device)!r})"
        )


def generator_for(
    generator: Optional[torch.Generator], device: Union[str, torch.device]
) -> torch.Generator:
    """``generator`` after a check of its device, or a fresh one on ``device``."""
    if generator is None:
        return new_generator(device)
    check_generator(generator, device)
    return generator


def standard_normal(
    generator: Optional[torch.Generator], shape: Tuple[int, ...], like: torch.Tensor
) -> torch.Tensor:
    """Standard-normal base draws with the dtype and device of ``like``."""
    generator = generator_for(generator, like.device)
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def uniform(
    generator: Optional[torch.Generator], shape: Tuple[int, ...], like: torch.Tensor
) -> torch.Tensor:
    """Uniform ``[0, 1)`` base draws with the dtype and device of ``like``."""
    generator = generator_for(generator, like.device)
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


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


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """``x`` as a numpy array on the host (a copy from the device where it lives there)."""
    return x.detach().cpu().numpy()

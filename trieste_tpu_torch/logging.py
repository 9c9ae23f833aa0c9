"""Summary logging (the writer-agnostic subset of :mod:`trieste_tpu.logging`).

With no writer set, every call returns at once and evaluates nothing. A writer is any
object with ``add_scalar(name, value, step)``. ``deferred_scalar`` queues a closure
whose device read would otherwise stall the hot path; the BO loop flushes the queue once
per step.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Union

_WRITER: Optional[Any] = None
_STEP: int = 0
_DEFERRED: list = []


def set_tensorboard_writer(writer: Optional[Any]) -> None:
    """Attach (or, with ``None``, detach) the summary writer."""
    global _WRITER
    _WRITER = writer


def get_tensorboard_writer() -> Optional[Any]:
    return _WRITER


def set_step_number(step: int) -> None:
    global _STEP
    if step < 0:
        raise ValueError(f"step number must be non-negative, got {step}")
    _STEP = step


def get_step_number() -> int:
    return _STEP


def _evaluate(value: Union[float, Callable[[], float]]) -> float:
    return float(value() if callable(value) else value)


def scalar(name: str, value: Union[float, Callable[[], float]]) -> None:
    """Write a scalar now, if a writer is set."""
    if _WRITER is not None:
        _WRITER.add_scalar(name, _evaluate(value), _STEP)


def deferred_scalar(name: str, value: Union[float, Callable[[], float]]) -> None:
    """Queue a scalar for the next :func:`flush_deferred_summaries`, if a writer is set."""
    if _WRITER is not None:
        _DEFERRED.append((name, value, _STEP))


def flush_deferred_summaries() -> None:
    """Evaluate and write the queued scalars at their enqueue-time steps."""
    global _DEFERRED
    pending, _DEFERRED = _DEFERRED, []
    if _WRITER is None:
        return
    for name, value, step in pending:
        _WRITER.add_scalar(name, _evaluate(value), step)

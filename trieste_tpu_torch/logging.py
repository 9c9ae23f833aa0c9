"""Summary logging: a module-global summary writer, step number and summary filter
(counterpart of :mod:`trieste_tpu.logging`).

A writer is any object with the ``SummaryWriter`` methods it is asked for
(``add_scalar``, ``add_histogram``, ``add_text``, ``add_figure``):
``torch.utils.tensorboard.SummaryWriter`` where the ``tensorboard`` package is installed,
or the dependency-free :class:`JsonlSummaryWriter`, one JSON line per event. With no
writer set, or a name the filter rejects, a call returns at once and evaluates nothing.

The deferred calls queue a value (a tensor, or a closure that returns one) without reading
it: a read from the device would stall the step. The loops flush the queue once per step,
and the flush reads every queued tensor of a device in one packed transfer. Errors in
evaluating or writing a summary are printed and swallowed per entry, so that a failing
summary never stops the optimization.
"""
from __future__ import annotations

import contextlib
import fnmatch
import json
import os
import sys
import time
from typing import Any, Callable, Iterator, Optional, Union

import numpy as np
import torch

from .profiling import host_read, span

SummaryFilter = Callable[[str], bool]


def default_summary_filter(name: str) -> bool:
    """Hide the summaries whose name, or any ``/``-separated part of it, starts with ``_``."""
    return not any(part.startswith("_") for part in name.split("/"))


_WRITER: Optional[Any] = None
_STEP: int = 0
_FILTER: SummaryFilter = default_summary_filter


class JsonlSummaryWriter:
    """A summary writer with no dependencies: one JSON object per line of
    ``logdir/events.jsonl`` (a histogram as its mean, std, min, max and count)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(logdir, "events.jsonl")
        self._f = open(self._path, "a")

    def _write(self, tag: str, step: int, **event: Any) -> None:
        self._f.write(json.dumps({"t": time.time(), "tag": tag, **event, "step": step}) + "\n")
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(tag, step, value=float(value))

    def add_histogram(self, tag: str, values: Any, step: int) -> None:
        v = np.asarray(values).reshape(-1)
        stats = (
            {"mean": float(v.mean()), "std": float(v.std()), "min": float(v.min()),
             "max": float(v.max())}
            if v.size else {"mean": 0.0, "std": 0.0, "min": 0.0, "max": 0.0}
        )
        self._write(tag, step, histogram={**stats, "count": int(v.size)})

    def add_text(self, tag: str, text: str, step: int) -> None:
        self._write(tag, step, text=str(text))

    def add_figure(self, tag: str, figure: Any, step: int, **kwargs: Any) -> None:
        """Save the figure as a PNG beside the event file and record its path."""
        safe = "".join(c if (c.isalnum() or c in "-_.") else "_" for c in tag)
        png = os.path.join(os.path.dirname(self._path), f"{safe}.{step:04d}.png")
        figure.savefig(png, dpi=100)
        self._write(tag, step, figure=png)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def make_summary_writer(logdir: str, prefer_tensorboard: bool = True) -> Any:
    """A writer for ``logdir``: ``torch.utils.tensorboard.SummaryWriter`` where it can be
    made and is preferred, else a :class:`JsonlSummaryWriter`."""
    if prefer_tensorboard:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # the tensorboard package is not installed
            pass
        else:
            return SummaryWriter(logdir)
    return JsonlSummaryWriter(logdir)


def set_tensorboard_writer(writer: Optional[Any]) -> None:
    """Attach (or, with ``None``, detach) the summary writer. What is queued for the
    outgoing writer is flushed to it first."""
    global _WRITER
    if _WRITER is not None and _WRITER is not writer:
        flush_deferred_summaries(force=True)
    _WRITER = writer


def get_tensorboard_writer() -> Optional[Any]:
    return _WRITER


@contextlib.contextmanager
def tensorboard_writer(writer: Optional[Any]) -> Iterator[None]:
    """Set the writer for the enclosed block."""
    old = get_tensorboard_writer()
    set_tensorboard_writer(writer)
    try:
        yield
    finally:
        set_tensorboard_writer(old)


def set_step_number(step: int) -> None:
    global _STEP
    if step < 0:
        raise ValueError(f"step number must be non-negative, got {step}")
    _STEP = step


def get_step_number() -> int:
    return _STEP


@contextlib.contextmanager
def step_number(step: int) -> Iterator[None]:
    """Set the step number for the enclosed block."""
    old = get_step_number()
    set_step_number(step)
    try:
        yield
    finally:
        set_step_number(old)


def set_summary_filter(summary_filter: SummaryFilter) -> None:
    global _FILTER
    _FILTER = summary_filter


def get_summary_filter() -> SummaryFilter:
    return _FILTER


def include_summary(name: str) -> bool:
    return _FILTER(name)


def _evaluate(value: Any) -> Any:
    return value() if callable(value) else value


def _host(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        host_read("summaries.write")
        return value.detach().cpu().numpy()
    return np.asarray(value)


# -- deferred summaries ---------------------------------------------------------------

_DEFERRED: list = []
_FLUSH_INTERVAL: int = 1
_FLUSHES_SKIPPED: int = 0


def set_deferred_flush_interval(interval: int) -> None:
    """Flush the queue only at every ``interval``-th per-step flush (default 1: every
    step). Queued entries keep their steps, so the events arrive unchanged, only later;
    detaching the writer always flushes."""
    global _FLUSH_INTERVAL
    if interval < 1:
        raise ValueError(f"interval must be >= 1, got {interval}")
    _FLUSH_INTERVAL = interval


def deferred_scalar(name: str, value: Any, **kwargs: Any) -> None:
    """Queue a scalar (a tensor, a number, or a closure returning either) for the next
    :func:`flush_deferred_summaries`, at the current step."""
    if _WRITER is None or not include_summary(name):
        return
    _DEFERRED.append(("scalar", name, value, _STEP, kwargs))


def deferred_histogram(name: str, values: Any, **kwargs: Any) -> None:
    """Histogram form of :func:`deferred_scalar`."""
    if _WRITER is None or not include_summary(name):
        return
    _DEFERRED.append(("histogram", name, values, _STEP, kwargs))


def deferred_scalar_vector(names: list, values: Any, **kwargs: Any) -> None:
    """Queue one scalar per entry of ``names`` from the matching element of the 1-D
    tensor ``values``, with no indexing of the tensor now: it rides the packed read of
    the flush and is split on the host."""
    if _WRITER is None:
        return
    kept = [(i, n) for i, n in enumerate(names) if include_summary(n)]
    if kept:
        _DEFERRED.append(("scalar_vector", kept, values, _STEP, kwargs))


def _fetch_packed(resolved: list) -> None:
    """Replace every tensor among the resolved values by its numpy value: one
    ``torch.cat`` of the flattened float32 values and one ``.cpu()`` per device."""
    by_device: dict = {}
    for i, entry in enumerate(resolved):
        if isinstance(entry[2], torch.Tensor):
            by_device.setdefault(entry[2].device, []).append(i)
    for indices in by_device.values():
        flat = torch.cat([resolved[i][2].detach().reshape(-1).to(torch.float32) for i in indices])
        host = flat.cpu().numpy()  # the one transfer
        host_read("summaries.fetch")
        offset = 0
        for i in indices:
            kind, name, v, step, kwargs = resolved[i]
            resolved[i] = (kind, name, host[offset:offset + v.numel()].reshape(v.shape), step,
                           kwargs)
            offset += v.numel()


def flush_deferred_summaries(force: bool = False) -> None:
    """Evaluate and write the queued summaries at the steps they were queued at. The
    queued tensors of a device are read in one packed transfer. With
    :func:`set_deferred_flush_interval` above 1, only every so many calls flush, unless
    ``force``."""
    global _DEFERRED, _FLUSHES_SKIPPED
    if not force and _FLUSH_INTERVAL > 1:
        _FLUSHES_SKIPPED += 1
        if _FLUSHES_SKIPPED < _FLUSH_INTERVAL:
            return
    _FLUSHES_SKIPPED = 0
    pending, _DEFERRED = _DEFERRED, []
    if _WRITER is None or not pending:
        return
    with span("summaries.flush", entries=len(pending)):
        _flush(pending)


def _flush(pending: list) -> None:
    """Resolve, fetch and write the entries :func:`flush_deferred_summaries` took."""
    resolved = []
    for kind, name, value, step, kwargs in pending:
        try:
            resolved.append((kind, name, _evaluate(value), step, kwargs))
        except Exception as e:  # noqa: BLE001 - a summary never stops the loop
            print(f"failed to log {kind} {name}: {e}")
    try:
        _fetch_packed(resolved)
    except Exception as e:  # noqa: BLE001
        print(f"failed to batch-fetch deferred summaries: {e}")
    for kind, name, v, step, kwargs in resolved:
        try:
            if kind == "scalar":
                _WRITER.add_scalar(name, float(_host(v)), step, **kwargs)
            elif kind == "scalar_vector":
                flat = _host(v).reshape(-1)
                for i, n in name:  # name holds [(index, name), ...]
                    _WRITER.add_scalar(n, float(flat[i]), step, **kwargs)
            else:
                _WRITER.add_histogram(name, _host(v), step, **kwargs)
        except Exception as e:  # noqa: BLE001
            print(f"failed to log {kind} {name}: {e}")


# -- immediate summaries ----------------------------------------------------------------


def scalar(name: str, value: Any, **kwargs: Any) -> None:
    """Write a scalar now, if a writer is set and the filter passes; a closure is
    evaluated only then."""
    if _WRITER is None or not include_summary(name):
        return
    try:
        _WRITER.add_scalar(name, float(_host(_evaluate(value))), _STEP, **kwargs)
    except Exception as e:  # noqa: BLE001
        print(f"failed to log scalar {name}: {e}")


def histogram(name: str, values: Any, **kwargs: Any) -> None:
    if _WRITER is None or not include_summary(name):
        return
    try:
        _WRITER.add_histogram(name, _host(_evaluate(values)), _STEP, **kwargs)
    except Exception as e:  # noqa: BLE001
        print(f"failed to log histogram {name}: {e}")


def text(name: str, value: Union[str, Callable[[], str]], **kwargs: Any) -> None:
    if _WRITER is None or not include_summary(name):
        return
    try:
        _WRITER.add_text(name, str(_evaluate(value)), _STEP, **kwargs)
    except Exception as e:  # noqa: BLE001
        print(f"failed to log text {name}: {e}")


def pyplot(name: str, fig_or_fn: Any, **kwargs: Any) -> None:
    """Write a matplotlib figure, if the writer takes figures, and close it."""
    if _WRITER is None or not include_summary(name):
        return
    try:
        fig = _evaluate(fig_or_fn)
        if hasattr(_WRITER, "add_figure"):
            _WRITER.add_figure(name, fig, _STEP, **kwargs)
        plt = sys.modules.get("matplotlib.pyplot")  # loaded if pyplot made the figure
        if plt is not None:  # release the figure whether or not the writer took it
            plt.close(fig)
    except Exception as e:  # noqa: BLE001
        print(f"failed to log figure {name}: {e}")


class SummaryFilterPatterns:
    """A filter from glob patterns: names that match ``include`` and not ``exclude``."""

    def __init__(self, include: str = "*", exclude: str = "_*"):
        self._include = include
        self._exclude = exclude

    def __call__(self, name: str) -> bool:
        return fnmatch.fnmatch(name, self._include) and not fnmatch.fnmatch(
            name, self._exclude
        )

"""Spans, counters, device traces and compile counts (counterpart of
:mod:`trieste_tpu.profiling`, which has no spans or counters).

**Spans.** :func:`span` marks a phase of the program where the work happens: an Ask/Tell
step, a fit, an acquisition's pool score and runs, a posterior cache build, an L-BFGS call
and the three phases of each of its lockstep iterations. While recording is off, the
default, a span checks two flags and returns. It records while a :func:`tracing` block is
open or a ``torch.profiler`` session runs (:func:`trace`, or the caller's own profiler):
then each span keeps a :class:`Record` (name, start and end on ``time.perf_counter_ns``,
parent, step, the explicit host reads inside it, attributes) and, under a profiler, opens
``torch.profiler.record_function(name)``, so that the profiler's trace shows the program's
phases on the same clock and thread as the device's kernels. A span never synchronises the
device: it times the host, and where it ends on a read the code makes anyway (each L-BFGS
loop test does), the device has caught up too. The spans of one Ask/Tell step share its
step identifier, :func:`next_step`.

**Counters** are always on: module-level ints in the module that does the work, each one
an increment with no device read and no lock (the port drives its loops from one thread;
threads that run loops at once may lose counts). :func:`counters` returns them all by
name. Every
explicit device-to-host read on a step's path calls :func:`host_read`, which counts it and,
while recording, counts it by site too (:func:`host_reads_by_site`).

**Traces.** :func:`trace` records a ``torch.profiler`` trace of the enclosed block, the
host's operators, the program's spans and, where a CUDA device is present, the kernels on
it, as a Chrome trace (viewable in Perfetto or ``chrome://tracing``).

**Compile counts.** What compiles in the port is the CUDA kernel library of the fused
prediction path, built with ``nvcc`` at first use and loaded once per process
(:mod:`trieste_tpu_torch.ops.fused_predict`). Eager PyTorch compiles nothing else: its
operators are built ahead of time, so a BO step cannot trigger a compilation the way a
new shape retraces a jitted JAX function. :func:`compile_cache_sizes` reports the builds
and loads, and :func:`assert_no_recompiles` asserts that a block adds none, as the JAX
package asserts that steps after the first hit its executable caches.
"""
from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Deque, Dict, Iterator, List, Mapping, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

RECENT = 1 << 15
"""How many of the newest records :func:`recent_records` keeps."""

host_reads = 0
"""Explicit device-to-host reads on the program's path (:func:`host_read`)."""

_sinks: List[List["Record"]] = []  # the record lists of the open tracing() blocks
_recent: Deque["Record"] = collections.deque(maxlen=RECENT)
_reads_by_site: Dict[str, int] = {}
_ids = itertools.count()
_steps = itertools.count()
_local = threading.local()  # each thread's stack of open spans


class _Off:
    """The span while recording is off: it does nothing and gives ``None``."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> None:
        return None


_OFF = _Off()


class Record:
    """One span: ``end_ns`` is 0 while it is open; ``host_reads`` counts the explicit
    device-to-host reads inside it once it has closed; ``parent`` is the ``id`` of the
    innermost span open on the same thread when it opened; ``step`` is the Ask/Tell step it
    belongs to (its own or its parent's)."""

    __slots__ = ("name", "id", "parent", "step", "start_ns", "end_ns", "host_reads", "attrs")

    def __init__(self, name: str, id: int, parent: Optional[int], step: Optional[int],
                 attrs: Dict[str, Any]):
        self.name, self.id, self.parent, self.step, self.attrs = name, id, parent, step, attrs
        self.start_ns = self.end_ns = self.host_reads = 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Span:
    __slots__ = ("_name", "_step", "_attrs", "_record", "_function")

    def __init__(self, name: str, step: Optional[int], attrs: Dict[str, Any]):
        self._name, self._step, self._attrs = name, step, attrs
        self._function = None

    def __enter__(self) -> Record:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        step = self._step if self._step is not None or parent is None else parent.step
        record = self._record = Record(
            self._name, next(_ids), None if parent is None else parent.id, step, self._attrs)
        stack.append(record)
        for sink in _sinks:
            sink.append(record)
        _recent.append(record)
        if _autograd_profiler._is_profiler_enabled:
            self._function = torch.profiler.record_function(self._name)
            self._function.__enter__()
        record.host_reads = host_reads
        record.start_ns = time.perf_counter_ns()
        return record

    def __exit__(self, *exc: Any) -> None:
        record = self._record
        record.end_ns = time.perf_counter_ns()
        record.host_reads = host_reads - record.host_reads
        if self._function is not None:
            self._function.__exit__(*exc)
        _local.stack.pop()


def span(name: str, step: Optional[int] = None, **attrs: Any):
    """A context manager that records the enclosed block as span ``name`` with ``attrs``
    while recording is on, and does nothing otherwise. ``as`` gives the live
    :class:`Record` (attributes known only at the end go into its ``attrs``), or ``None``
    when recording is off. ``step`` sets the step identifier; a span without one takes its
    parent's."""
    if not _sinks and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, step, attrs)


@contextmanager
def tracing() -> Iterator[List[Record]]:
    """Record spans for the enclosed block; yields the list the block's records are
    appended to, in the order they open. Blocks nest: an inner block's records are also
    the outer block's."""
    records: List[Record] = []
    _sinks.append(records)
    try:
        yield records
    finally:
        _sinks.remove(records)


def recent_records() -> List[Record]:
    """The newest :data:`RECENT` records of this process, from every block and profiler
    session that recorded, in the order they opened."""
    return list(_recent)


def next_step() -> int:
    """A new step identifier, unique in this process."""
    return next(_steps)


def host_read(site: str) -> None:
    """Count one explicit device-to-host read at ``site``; call it beside the read."""
    global host_reads
    host_reads += 1
    if _sinks or _autograd_profiler._is_profiler_enabled:
        _reads_by_site[site] = _reads_by_site.get(site, 0) + 1


def host_reads_by_site() -> Mapping[str, int]:
    """The explicit reads :func:`host_read` counted while recording, by site, since the
    process started."""
    return dict(_reads_by_site)


def counters() -> Mapping[str, int]:
    """Every program counter by name, as it stands now (they only grow)."""
    from .models.gp import gpr
    from .ops import fused_predict, lbfgs

    return {
        "host_reads": host_reads,
        "lbfgs.iterations": lbfgs.iterations,
        "lbfgs.line_search_turns": lbfgs.line_search_turns,
        "lbfgs.line_search_blocks": lbfgs.line_search_blocks,
        "lbfgs.block_rows": lbfgs.block_rows,
        "lbfgs.rows_evaluated": lbfgs.rows_evaluated,
        "lbfgs.rows_active": lbfgs.rows_active,
        "posterior.cache_builds": gpr.cache_builds,
        "fused_predict.launches": fused_predict.launches,
        "fused_predict.builds": fused_predict.builds,
        "fused_predict.loads": fused_predict.loads,
    }


@contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block and write its Chrome trace into ``logdir`` (one new
    ``trace.<pid>.<ns>.json`` per call), the program's spans among the host's events;
    yields the profiler, whose ``key_averages()`` the caller may read after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


def compile_cache_sizes() -> Mapping[str, int]:
    """How often this process has compiled and loaded the fused prediction kernel."""
    from .ops import fused_predict

    return {"fused_predict_builds": fused_predict.builds, "fused_predict_loads": fused_predict.loads}


@contextmanager
def assert_no_recompiles() -> Iterator[None]:
    """Raise ``AssertionError`` if the enclosed block compiles or loads the kernel
    library. Use around the steps after the first of a loop::

        with assert_no_recompiles():
            optimizer.tell(observer(optimizer.ask()))
    """
    before = dict(compile_cache_sizes())
    yield
    after = dict(compile_cache_sizes())
    grown = {k: (before[k], after[k]) for k in before if after[k] > before[k]}
    if grown:
        raise AssertionError(f"unexpected recompilations: {grown}")

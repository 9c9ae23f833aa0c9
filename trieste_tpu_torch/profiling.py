"""Device traces and compile counts (counterpart of :mod:`trieste_tpu.profiling`).

:func:`trace` records a ``torch.profiler`` trace of the enclosed block, the host's
operators and, where a CUDA device is present, the kernels on it, as a Chrome trace
(viewable in Perfetto or ``chrome://tracing``).

What compiles in the port is the CUDA kernel library of the fused prediction path, built
with ``nvcc`` at first use and loaded once per process
(:mod:`trieste_tpu_torch.ops.fused_predict`). Eager PyTorch compiles nothing else: its
operators are built ahead of time, so a BO step cannot trigger a compilation the way a
new shape retraces a jitted JAX function. :func:`compile_cache_sizes` reports the builds
and loads, and :func:`assert_no_recompiles` asserts that a block adds none, as the JAX
package asserts that steps after the first hit its executable caches.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Iterator, Mapping

import torch

from .ops import fused_predict


@contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block and write its Chrome trace into ``logdir`` (one new
    ``trace.<pid>.<ns>.json`` per call); yields the profiler, whose ``key_averages()``
    the caller may read after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


def compile_cache_sizes() -> Mapping[str, int]:
    """How often this process has compiled and loaded the fused prediction kernel."""
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

"""The traced run's device trace, reduced by the benchmark itself with ``torch.profiler``
(not the program's wrapper of it): the device's busy time as the union of the kernel and
memory-copy intervals, each kernel's device time by name, and the idle gaps between
device intervals, each put down to the innermost host operator that was running when the
device went idle."""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch

WINDOW_SPAN = "benchmark.profiled_window"
PYTHON = "python between operators"  # the device idles while no host operator is open
TOP = 10


@dataclass
class Profile:
    window_s: float  # the profiled window, from its host span
    busy_s: float  # union of device intervals inside it
    kernels: Dict[str, List[float]] = field(default_factory=dict)  # name -> durations (s)
    idle_by_host_op: Dict[str, float] = field(default_factory=dict)  # name -> seconds
    device_events: int = 0
    reduce_s: float = 0.0  # host seconds spent reducing the trace

    def device_ops(self) -> List[List]:
        totals = sorted(((sum(v), k) for k, v in self.kernels.items()), reverse=True)
        return [[k, s] for s, k in totals[:TOP]]

    def idle_gaps(self) -> List[List]:
        totals = sorted(((v, k) for k, v in self.idle_by_host_op.items()), reverse=True)
        return [[k, s] for s, k in totals[:TOP]]


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def reduce_events(events) -> Profile:
    """Reduce the profiler's raw (kineto) events to a :class:`Profile`."""
    span = [e for e in events if e.name() == WINDOW_SPAN and not _is_device(e)]
    if not span:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
    w0, w1 = span[0].start_ns(), span[0].end_ns()
    thread = span[0].start_thread_id()
    device, host = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if t <= w0 or s >= w1:
            continue
        if _is_device(e):
            if not e.is_user_annotation():  # kernels, copies and fills; not ranges
                device.append((max(s, w0), min(t, w1), e.name()))
        elif e.start_thread_id() == thread and e is not span[0]:
            host.append((s, t, e.name()))
    device.sort()
    host.sort()
    kernels: Dict[str, List[float]] = collections.defaultdict(list)
    for s, t, name in device:
        kernels[name].append((t - s) * 1e-9)
    # the union of the device intervals, and the gaps between its pieces
    busy, gaps, cur_s, cur_t = 0, [], None, None
    for s, t, _ in device:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
                gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += cur_t - cur_s
    # each gap goes to the innermost host operator open when the device went idle: a
    # sweep over the thread's operators, which nest, keeping the open ones on a stack
    idle: Dict[str, float] = collections.defaultdict(float)
    stack: List[tuple] = []
    i = 0
    for g0, g1 in gaps:  # in time order
        while i < len(host) and host[i][0] <= g0:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < g0:
            stack.pop()
        idle[stack[-1][2] if stack else PYTHON] += (g1 - g0) * 1e-9
    return Profile(
        window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, kernels=dict(kernels),
        idle_by_host_op=dict(idle), device_events=len(device),
    )


def profile_steps(step: Callable[[], object], count: int, device: torch.device) -> Profile:
    """Run ``step`` ``count`` times under ``torch.profiler`` (host and device activity)
    inside one host span, and reduce the trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    with torch.profiler.record_function(WINDOW_SPAN):
        for _ in range(count):
            step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    prof.stop()
    profile = reduce_events(prof.profiler.kineto_results.events())
    profile.reduce_s = time.perf_counter() - t0
    return profile

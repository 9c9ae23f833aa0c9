"""The program's own spans (``trieste_tpu_torch.profiling``), for the readers of the
per-layer metrics that count inside the program. The program records its spans while a
``torch.profiler`` session runs, so the traced run's profiled steps have them: a step's
records are those that opened and closed inside its interval on the host clock (the
spans' ``perf_counter_ns`` against the step's ``perf_counter``). A program without spans
(an older commit) gives ``None``, and so does an untraced run."""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional


def steps(run) -> Optional[List[list]]:
    """The records of each of the run's steps that has any, in step order."""
    if not run.trace:
        return None
    from trieste_tpu_torch import profiling

    recent = getattr(profiling, "recent_records", None)
    if recent is None or getattr(profiling, "tracing", None) is None:
        return None
    records = sorted((r for r in recent() if r.end_ns), key=lambda r: r.start_ns)
    starts = [r.start_ns for r in records]
    out = []
    for step in run.all_steps:
        lo, hi = round(step.start * 1e9), round(step.end * 1e9)
        inside = [r for r in records[bisect.bisect_left(starts, lo):bisect.bisect_right(starts, hi)]
                  if r.end_ns <= hi]
        if inside:
            out.append(inside)
    return out or None


def within(records: list, name: str, outer: str) -> List:
    """The records called ``name`` that have an ancestor called ``outer``."""
    by_id: Dict[int, object] = {r.id: r for r in records}

    def inside(r) -> bool:
        while r.parent is not None and r.parent in by_id:
            r = by_id[r.parent]
            if r.name == outer:
                return True
        return False

    return [r for r in records if r.name == name and inside(r)]


def self_seconds(record, records: Iterable) -> float:
    """The record's seconds less those of its children."""
    return record.seconds - sum(r.seconds for r in records if r.parent == record.id)


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def lbfgs_iterations(run, outer: str) -> Optional[float]:
    """Mean over the recorded steps of the lockstep iterations of the ``lbfgs.minimize``
    spans inside ``outer`` spans; ``None`` where no step has an ``outer`` span."""
    recorded = steps(run)
    if recorded is None:
        return None
    per_step = [sum(r.attrs["iterations"] for r in within(rs, "lbfgs.minimize", outer))
                for rs in recorded if any(r.name == outer for r in rs)]
    return mean(per_step)

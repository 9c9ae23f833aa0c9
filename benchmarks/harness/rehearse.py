"""A cell's loop at a tiny size on the CPU, for the tests: the same set-up, window,
check and result line as a run on the card, with the configuration shrunk where its
sizes would not fit a test, and a window of ``steps`` steps instead of seconds. The
command itself refuses the CPU.

How a configuration shrinks is data of its own, ``rehearsal/<config>.json``: its
``overrides`` are laid over the configuration. A configuration without that file is not
rehearsed, so that none runs at full size on the CPU by default."""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import torch

from . import check, loop, report, spec


def overrides(config: str) -> Dict[str, Any]:
    """The rehearsal's overrides of configuration ``config``."""
    path = spec.BENCH_DIR / "rehearsal" / f"{config}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {path}: say how the configuration {config!r} shrinks "
                                "for a CPU rehearsal")
    return spec.load_json(path)["overrides"]


def rehearse(name: str, seed: int = 2**31 + 7, steps: int = 4, trace: bool = False,
             limits: Optional[Dict[str, float]] = None) -> Tuple[Dict[str, Any], Any, Any]:
    """Run cell ``name`` of ``BENCHMARK.json`` for ``steps`` steps on the CPU; returns the
    result line, the :class:`~benchmarks.harness.loop.Run` and the verdict."""
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    config = {w["name"]: w["config"] for w in bench["workloads"]}[name]
    cell = spec.load_cell(name, bench, overrides=overrides(config))
    return rehearse_cell(cell, seed, steps, trace, limits)


def rehearse_cell(cell: spec.Cell, seed: int = 2**31 + 7, steps: int = 4, trace: bool = False,
                  limits: Optional[Dict[str, float]] = None) -> Tuple[Dict[str, Any], Any, Any]:
    """:func:`rehearse` of a cell already loaded (with its rehearsal's overrides), such as
    one that a test builds."""
    run = loop.run_cell(cell, seed, 0.0, trace, torch.device("cpu"), time.perf_counter(),
                        max_steps=steps, log=lambda s: None)
    verdict = check.judge(run, limits or cell.limits)
    return report.result(run, verdict), run, verdict

"""The result line a run prints last on standard output, and the check for JAX modules."""
from __future__ import annotations

import math
import sys
from typing import Any, Dict, List

import torch

from .spec import metric_reader

FORBIDDEN = ("jax", "jaxlib", "flax", "trieste_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the JAX
    package's (``trieste_tpu_torch`` is neither)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _number(x: float):
    return x if math.isfinite(x) else None


def metrics(run) -> Dict[str, Dict[str, Any]]:
    """The cell's end-to-end metrics (untraced) or per-layer ones (traced), each by its
    reader; a reader that finds nothing leaves its metric out."""
    wanted = run.cell.per_layer if run.trace else run.cell.end_to_end
    out = {}
    for m in wanted:
        value = metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(run, verdict) -> Dict[str, Any]:
    device: Dict[str, Any] = {
        "platform": "gpu" if run.device.type == "cuda" else run.device.type,
        "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
        "count": run.cell.chips,
        "memory_peak_bytes": int(run.peak_bytes),
    }
    line: Dict[str, Any] = {
        "correct": verdict.correct,
        "attempted": len(run.all_steps),
        "failed": len(verdict.failed_steps),
        "metrics": metrics(run),
        "device": device,
    }
    if run.profile is not None:
        device["busy_s"] = run.profile.busy_s
        device["window_s"] = run.profile.window_s
        line["breakdown"] = {"device_ops": run.profile.device_ops(),
                             "idle_gaps": run.profile.idle_gaps()}
    line["checks"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                      for k, v in verdict.as_json().items()}
    return line

"""What a cell is made of, found by the names in ``BENCHMARK.json``: the configuration
``configs/<config>.json``, the traffic mix ``traffic/<traffic>.json``, the limits of the
comparison ``limits/<cell>.json``, the rule ``rules/<rule>.py`` and its plain version
``reference/<rule>.py``, the model family ``models/<builder>.py`` and its plain version
``reference/<builder>.py`` (``builder`` is the configuration's ``model.builder``), the
objective ``objectives/<objective>.py``, and one reader ``metrics/<metric>.py`` per
metric. Adding a cell, a mix, a family, a rule or a metric adds files and entries;
nothing here names one."""
from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(folder: str, name: str):
    """``benchmarks/<folder>/<name>.py`` as a module; a name may hold ``.`` and ``-``.
    Each file is executed once per process."""
    return _load_path(BENCH_DIR / folder / f"{name}.py", f"benchmarks.{folder}.{name}")


@functools.lru_cache(maxsize=None)
def _load_path(path: Path, qualified: str):
    spec = importlib.util.spec_from_file_location(qualified, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def num_query_points(self) -> int:
        return int(self.traffic["num_query_points"])

    @property
    def num_initial_samples(self) -> Optional[int]:
        """The seed pool of the acquisition optimizer: the mix's own where it names one
        (``null`` for the program's default), else the configuration's."""
        if "num_initial_samples" in self.traffic:
            return self.traffic["num_initial_samples"]
        return self.config.get("num_initial_samples")

    def rule_module(self):
        return load_module("rules", self.traffic["rule"])

    def reference_module(self):
        return load_module("reference", self.traffic["rule"])

    def family_module(self):
        """The program's side of the configuration's model family."""
        return load_module("models", self.config["model"]["builder"])

    def family_reference(self):
        """The plain side of the configuration's model family."""
        return load_module("reference", self.config["model"]["builder"])

    def objective(self):
        return load_module("objectives", self.config["objective"]).objective


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Optional[Dict[str, Any]] = None,
              overrides: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``benchmark``), with ``overrides``
    laid over its configuration (the CPU rehearsals shrink sizes so)."""
    bench = benchmark if benchmark is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(load_json(ROOT / configs[w["config"]]["file"]))
    config.update(overrides or {})
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def metric_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    return load_module("metrics", name).read

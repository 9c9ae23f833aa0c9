"""The port's tutorials (``examples_torch/``) on the CPU.

Each of the JAX package's 14 examples has a counterpart of the same file name. Test (a)
holds its imports: no ``jax`` and nothing of ``trieste_tpu``, only torch, numpy, the
standard library and ``trieste_tpu_torch``, and every name the JAX example imports from
``trieste_tpu.X`` imported by the same name from ``trieste_tpu_torch.X``, so the two read
side by side. Test (b) runs the example in-process at its smallest budget, ``main(1,
device="cpu")`` (``main(device="cpu")`` for the two without a budget), and holds what it
returns to the example's own checks; without a CUDA device it must refuse to run on its
default device.
"""
from __future__ import annotations

import ast
import importlib.util
import sys
import tempfile
from pathlib import Path

import pytest
import torch
from chip_smoke import EXAMPLES, EXAMPLES_WITHOUT_BUDGET, example_checks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# third-party modules an example may import besides the standard library; matplotlib
# only behind the optional plot's ImportError guard
ALLOWED = {"torch", "numpy", "trieste_tpu_torch", "matplotlib"}


def _imports(path: Path) -> tuple[set, set, set]:
    """``(top-level modules, (module, name) pairs of from-imports, (module, alias) pairs of
    plain imports)`` of a script."""
    tops, names, plain = set(), set(), set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
            names.update((node.module, a.name) for a in node.names)
        elif isinstance(node, ast.Import):
            for a in node.names:
                tops.add(a.name.split(".")[0])
                plain.add((a.name, a.asname))
    return tops, names, plain


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  ROOT / "examples_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_examples_mirror_the_jax_package():
    """One port example per JAX example, and the card's phase 32 runs them all."""
    assert sorted(p.stem for p in (ROOT / "examples").glob("*.py")) == sorted(EXAMPLES)
    assert sorted(p.stem for p in (ROOT / "examples_torch").glob("*.py")) == sorted(EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_mirror_jax(name):
    port = ROOT / "examples_torch" / f"{name}.py"
    assert port.exists()
    tops, names, plain = _imports(port)
    assert "jax" not in tops and "trieste_tpu" not in tops
    assert tops <= ALLOWED | set(sys.stdlib_module_names), tops - ALLOWED
    _, jax_names, jax_plain = _imports(ROOT / "examples" / f"{name}.py")
    for module, imported in jax_names:
        if module.split(".")[0] == "trieste_tpu":
            assert ("trieste_tpu_torch" + module[len("trieste_tpu"):], imported) in names
    for module, alias in jax_plain:
        if module.split(".")[0] == "trieste_tpu":
            assert ("trieste_tpu_torch" + module[len("trieste_tpu"):], alias) in plain


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_at_its_smallest_budget(name, monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the logging example's logdir
    module = _load(name)
    args = () if name in EXAMPLES_WITHOUT_BUDGET else (1,)
    if not torch.cuda.is_available():  # the default device is the card: no quiet CPU run
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(*args)
    out = module.main(*args, device="cpu")
    # what the card's phase 32 holds: every number finite, the Ask/Tell resume bit for bit,
    # the flaky run an Err and its resume Ok, the constrained point feasible, the EHVI front
    # non-dominated, the mixed space's point on its grid
    fault = example_checks(name, out)
    assert fault is None, f"{fault}: {out}"

    if name == "inequality_constraints":
        assert all(0.0 <= x <= 1.0 for x in out["explicit_point"])
    elif name == "multi_objective_ehvi":
        assert len(out["front"]) >= 1 and all(len(y) == 2 for y in out["front"])
        assert 0.0 < out["hypervolume"] <= out["ideal_hypervolume"]
    elif name == "active_learning":
        assert out["points_collected"] == 7 and 0.0 <= out["level_set_accuracy"] <= 1.0
    elif name == "visualizing_and_logging":
        assert "events.jsonl" in out["log_files"] and len(out["regret"]) == 2
        assert out["plot_written"] == (importlib.util.find_spec("matplotlib") is not None)
    elif name == "multi_chip_scaling":
        assert out["ranks"] == 1

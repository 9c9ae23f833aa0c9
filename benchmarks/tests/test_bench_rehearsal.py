"""Each cell's loop rehearsed at a tiny size on the CPU: the result line's schema, the
check passing on the sound program, and coming out false with the timed path broken
underneath and with the control in the program's place."""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from benchmarks.harness import check, rehearse, spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def assert_schema(line, trace):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and 0 <= line["failed"] <= line["attempted"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["checks"]) == set(check.NUMBERS)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(line, allow_nan=False))


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct(cell):
    line, run, verdict = rehearse.rehearse(cell, steps=4)
    assert_schema(line, trace=False)
    assert line["correct"], (verdict.numbers, verdict.failed_steps)
    assert {m["name"] for m in spec.load_cell(cell, BENCH).end_to_end} - set(line["metrics"]) \
        <= {"peak_mem_gib", "step_p90_s"}  # a CPU run has no card memory; 4 steps no tail
    assert len(run.episodes) == 2  # the tiny episodes hold 3 steps: one restart


@pytest.mark.parametrize("cell", CELLS[:1])
def test_traced_rehearsal(cell):
    line, run, _ = rehearse.rehearse(cell, steps=3, trace=True)
    assert_schema(line, trace=True)
    assert {"tell_s", "ask_s", "step_mfu_pct"} <= set(line["metrics"])
    # no device on the CPU: its metrics are left out, never reported as 0
    assert "device_idle_pct" not in line["metrics"]
    assert len(run.profiled) == 2


def test_fault_state_unchanged(monkeypatch):
    """A tell() that leaves the model as it was: no update, no fit."""
    from trieste_tpu_torch.ask_tell_optimization import AskTellOptimizer

    monkeypatch.setattr(AskTellOptimizer, "update_model", lambda self, model, dataset: None)
    line, _, verdict = rehearse.rehearse(CELLS[0], steps=3)
    assert not line["correct"], verdict.numbers


@pytest.mark.parametrize("cell", CELLS)
def test_fault_answer_altered(monkeypatch, cell):
    """The posterior's variance inflated where it is produced: by the fused kernel or the
    exact path for single points, whichever the program takes, and by the joint path for
    batches of points."""
    from trieste_tpu_torch.models.gp import posterior
    from trieste_tpu_torch.ops import fused_predict

    exact, plain = posterior._predict_f_flat_reference, fused_predict.fused_predict_reference
    joint = posterior.predict_joint

    def inflated(produce):
        def altered(*args):
            mean, var = produce(*args)
            return mean, 1.5 * var
        return altered

    monkeypatch.setattr(posterior, "_predict_f_flat_reference", inflated(exact))
    monkeypatch.setattr(fused_predict, "fused_predict_reference", inflated(plain))
    monkeypatch.setattr(posterior, "predict_joint", inflated(joint))
    line, run, verdict = rehearse.rehearse(cell, steps=3)
    assert not line["correct"], verdict.numbers
    assert verdict.numbers["pool_err"] > verdict.limits["pool_err"]


@pytest.mark.parametrize("cell", CELLS)
def test_fault_asked_point_altered(monkeypatch, cell):
    """The asked points moved after the optimizer chose them."""
    from trieste_tpu_torch.ask_tell_optimization import AskTellOptimizerABC

    original = AskTellOptimizerABC.ask
    monkeypatch.setattr(AskTellOptimizerABC, "ask", lambda self: original(self) * 0.999)
    line, _, _ = rehearse.rehearse(cell, steps=2)
    assert not line["correct"] and line["failed"] == line["attempted"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    """The reference in TF32 in the program's place fails at least one limit."""
    _, run, verdict = rehearse.rehearse(cell, steps=3)
    control = check.control_numbers(run)
    assert any(control[k] > verdict.limits[k] for k in check.NUMBERS), control


def test_kept_records_are_a_bounded_sample_with_the_last():
    """However many steps a window holds, the records kept on the device for the check
    stay at ``KEPT_RECORDS``, the last step's among them."""
    import numpy as np

    from benchmarks.harness import loop

    cell = spec.load_cell(CELLS[0], BENCH)
    run = loop.Run(cell, torch.device("cpu"), False, seed=1)
    sample = np.random.default_rng(0)
    for i in range(100):
        run.add(loop.Step(0, i, None, record=loop.AskRecord()), sample)
        kept = [s for s in run.steps if s.record is not None]
        assert len(kept) == min(i + 1, loop.KEPT_RECORDS) and kept[-1] is run.steps[-1]
    assert kept[0].n != 0  # the reservoir moved on from the first steps


def test_command_refuses_the_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload", CELLS[0], "--seed",
         "3", "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_jax_is_loaded():
    """The harness and a rehearsal load neither JAX nor the JAX package; top-level names
    compared whole, so the port itself passes."""
    code = (
        "import sys; from benchmarks.harness import rehearse, report;"
        f"rehearse.rehearse({CELLS[-1]!r}, steps=1);"
        "tops = {m.split('.')[0] for m in sys.modules};"
        "assert 'trieste_tpu_torch' in tops, tops;"
        "print(report.forbidden_modules())"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload", CELLS[0], "--seed",
         "5", "--seconds", "3", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert_schema(line, trace=False)
    assert line["correct"] and line["device"]["platform"] == "gpu"

"""The per-layer metrics read from the program's own spans: reported with finite values by
a traced rehearsal, absent from an untraced one, and left out by every reader where the
program has no spans (an older commit)."""
import math

import pytest

from benchmarks.harness import rehearse, spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
CELL = BENCH["workloads"][0]["name"]
PROGRAM_METRICS = ["fit_lbfgs_iters", "ask_lbfgs_iters", "host_reads_per_step",
                   "lbfgs_active_pct", "posterior_s"]


@pytest.fixture(scope="module")
def traced():
    return rehearse.rehearse(CELL, steps=3, trace=True)


def test_traced_rehearsal_reports_the_program_metrics(traced):
    line, run, _ = traced
    for name in PROGRAM_METRICS:
        assert math.isfinite(line["metrics"][name]["value"]), name
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["fit_lbfgs_iters"] >= 1 and m["ask_lbfgs_iters"] >= 1
    assert 0 < m["lbfgs_active_pct"] <= 100
    # at least each call's first test and one test per iteration, in both loops
    assert m["host_reads_per_step"] >= 2 * (m["fit_lbfgs_iters"] + m["ask_lbfgs_iters"])
    assert 0 < m["posterior_s"] < max(s.tell_s for s in run.all_steps)


def test_the_readers_count_the_profiled_steps(traced):
    _, run, _ = traced
    recorded = spec.load_module("metrics", "program").steps(run)
    assert len(recorded) == len(run.profiled)  # the window runs without the program's tracing
    for records in recorded:
        assert {"ask_tell.ask", "ask_tell.tell", "model.fit", "lbfgs.minimize"} <= {
            r.name for r in records}


def test_untraced_rehearsal_reports_none_of_them():
    line, _, _ = rehearse.rehearse(CELL, steps=2)
    assert not set(PROGRAM_METRICS) & set(line["metrics"])


@pytest.mark.parametrize("name", PROGRAM_METRICS)
@pytest.mark.parametrize("missing", ["tracing", "recent_records"])
def test_reader_gives_none_without_the_program_spans(traced, monkeypatch, name, missing):
    from trieste_tpu_torch import profiling

    _, run, _ = traced
    assert spec.metric_reader(name)(run) is not None
    monkeypatch.delattr(profiling, missing)
    assert spec.metric_reader(name)(run) is None

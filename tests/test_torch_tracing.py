"""The port's spans and counters (``trieste_tpu_torch.profiling``): nothing recorded while
tracing is off and the counters counting all the same; the span tree of one Ask/Tell step
with its step identifier and cache builds; the L-BFGS counters on a quadratic whose every
number is worked out by hand, and on a batch against the line search one halving at a time
(``test_torch_ops.sequential_minimize_lbfgs``); the loop held bit for bit to that search,
its form before it counted; the spans in a Chrome trace."""
import json
from typing import Tuple

import pytest
import torch

from trieste_tpu_torch import AskTellOptimizer, Box, Dataset, logging, profiling
from trieste_tpu_torch.acquisition import (
    EfficientGlobalOptimization,
    ExpectedImprovement,
    generate_continuous_optimizer,
)
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.ops.lbfgs import minimize_lbfgs

from test_torch_ops import block_schedule, sequential_minimize_lbfgs

F64 = torch.float64


def delta(before, after):
    return {k: after[k] - before[k] for k in after}


def objective(x: torch.Tensor) -> torch.Tensor:
    return ((x - 0.3) ** 2).sum(-1, keepdim=True) + torch.sin(5.0 * x).sum(-1, keepdim=True)


def ask_tell_optimizer() -> AskTellOptimizer:
    space = Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu")
    x = torch.rand(5, 2, dtype=F64, generator=torch.Generator().manual_seed(1))
    data = Dataset.from_arrays(x, objective(x))
    model = build_gpr(data, space, likelihood_variance=1e-7, trainable_likelihood=False)
    rule = EfficientGlobalOptimization(
        ExpectedImprovement(), optimizer=generate_continuous_optimizer(200, 4))
    return AskTellOptimizer(space, data, model, rule, generator=torch.Generator().manual_seed(2))


def step(at: AskTellOptimizer) -> None:
    points = at.ask()
    at.tell(Dataset.from_arrays(points, objective(points)))


def names_by_parent(records):
    """``{(parent's name, name): count}`` over ``records``; roots have parent ``None``."""
    by_id = {r.id: r for r in records}
    out = {}
    for r in records:
        key = (by_id[r.parent].name if r.parent in by_id else None, r.name)
        out[key] = out.get(key, 0) + 1
    return out


def test_tracing_off_records_nothing_and_counters_count():
    newest = profiling.recent_records()[-1:]
    before = dict(profiling.counters())
    with profiling.span("anything", n=1) as record:
        assert record is None
    at = ask_tell_optimizer()
    step(at)
    grown = delta(before, profiling.counters())
    assert profiling.recent_records()[-1:] == newest
    assert grown["lbfgs.iterations"] > 0 and grown["host_reads"] > 0
    assert grown["lbfgs.rows_active"] <= grown["lbfgs.rows_evaluated"]
    assert grown["posterior.cache_builds"] > 0
    assert set(profiling.counters()) >= {
        "fused_predict.launches", "fused_predict.builds", "fused_predict.loads"}


def test_one_ask_tell_step_gives_the_span_tree():
    at = ask_tell_optimizer()
    before = dict(profiling.counters())
    with profiling.tracing() as records:
        step(at)
    grown = delta(before, profiling.counters())
    tree = names_by_parent(records)
    ask_iters = sum(r.attrs["iterations"] for r in records if r.name == "lbfgs.minimize"
                    and r.attrs["R"] == 4)
    fit_iters = sum(r.attrs["iterations"] for r in records if r.name == "lbfgs.minimize"
                    and r.attrs["R"] == 10)
    assert tree == {
        (None, "ask_tell.ask"): 1,
        ("ask_tell.ask", "acquisition.optimize"): 1,
        ("acquisition.optimize", "acquisition.pool_score"): 1,
        ("acquisition.optimize", "acquisition.runs"): 1,
        ("acquisition.runs", "lbfgs.minimize"): 1,
        (None, "ask_tell.tell"): 1,
        ("ask_tell.tell", "posterior.build_cache"): 2,
        ("ask_tell.tell", "model.fit"): 1,
        ("model.fit", "lbfgs.minimize"): 1,
        ("lbfgs.minimize", "lbfgs.direction"): ask_iters + fit_iters,
        ("lbfgs.minimize", "lbfgs.line_search"): ask_iters + fit_iters,
        ("lbfgs.minimize", "lbfgs.gradient"): ask_iters + fit_iters,
    }
    assert len({r.step for r in records}) == 1  # the ask's step, shared by the tell
    optimize = next(r for r in records if r.name == "acquisition.optimize")
    assert optimize.attrs == {"N": 200, "R": 4, "V": 1, "D": 2}
    assert next(r for r in records if r.name == "acquisition.pool_score").attrs == {"rows": 200}
    assert next(r for r in records if r.name == "model.fit").attrs == {"R": 10, "P": 4}
    assert {r.attrs["n"] for r in records if r.name == "posterior.build_cache"} == {6}
    assert grown["posterior.cache_builds"] == 2  # the update's build, then the fit's
    assert grown["lbfgs.iterations"] == ask_iters + fit_iters
    # every explicit read of the step lies inside its two outer spans
    roots = [r for r in records if r.parent is None]
    assert sum(r.host_reads for r in roots) == grown["host_reads"]
    for r in records:
        assert 0 < r.start_ns <= r.end_ns
        parent = next((p for p in records if p.id == r.parent), None)
        if parent is not None:
            assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns


def test_steps_get_new_identifiers_and_a_tell_keeps_its_ask_s():
    at = ask_tell_optimizer()
    with profiling.tracing() as records:
        step(at)
        step(at)
    asks = [r for r in records if r.name == "ask_tell.ask"]
    tells = [r for r in records if r.name == "ask_tell.tell"]
    assert [a.step for a in asks] == [t.step for t in tells]
    assert asks[0].step < asks[1].step
    other = ask_tell_optimizer()  # a tell with no ask before it opens a step of its own
    x = torch.tensor([[0.5, 0.5]], dtype=F64)
    with profiling.tracing() as records:
        other.tell(Dataset.from_arrays(x, objective(x)))
    (tell,) = [r for r in records if r.name == "ask_tell.tell"]
    assert tell.step > asks[1].step


def test_summaries_flush_is_a_span_of_the_tell_and_its_read_is_counted():
    class Writer:
        def __init__(self):
            self.names = []

        def add_scalar(self, name, value, step):
            self.names.append(name)

    at = ask_tell_optimizer()
    writer = Writer()
    with logging.tensorboard_writer(writer), profiling.tracing() as records:
        before = dict(profiling.host_reads_by_site())
        step(at)
        sites = delta({k: before.get(k, 0) for k in profiling.host_reads_by_site()},
                      profiling.host_reads_by_site())
    (flush,) = [r for r in records if r.name == "summaries.flush"]
    tell = next(r for r in records if r.name == "ask_tell.tell")
    assert flush.parent == tell.id and flush.attrs["entries"] >= 1
    assert "model.training_loss" in writer.names
    assert sites["summaries.fetch"] == 1


def test_tracing_blocks_nest():
    with profiling.tracing() as outer:
        with profiling.span("a"):
            with profiling.tracing() as inner:
                with profiling.span("b", step=7, k=1) as b:
                    b.attrs["later"] = 2
    assert [r.name for r in outer] == ["a", "b"] and [r.name for r in inner] == ["b"]
    assert inner[0].parent == outer[0].id and inner[0].step == 7
    assert inner[0].attrs == {"k": 1, "later": 2}
    assert inner[0] in profiling.recent_records()


def test_reads_by_site_count_only_while_recording():
    before = profiling.host_reads_by_site().get("test.site", 0)
    total = profiling.counters()["host_reads"]
    profiling.host_read("test.site")
    assert profiling.host_reads_by_site().get("test.site", 0) == before
    with profiling.tracing():
        profiling.host_read("test.site")
    assert profiling.host_reads_by_site()["test.site"] == before + 1
    assert profiling.counters()["host_reads"] == total + 2


def quadratic(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


def test_lbfgs_counters_on_a_quadratic_known_by_hand():
    """f(x) = x² from 1, 0 and 3. The row at 0 has converged before the loop. The others
    take one iteration: the first direction is −g = −2x, the full step lands on −x with the
    same value and fails Armijo's test. The two rows still searching take the next
    ⌊2 · 3 / 2⌋ = 3 halvings in one call of 6 rows; the first of them, the half step, lands
    on 0 exactly, where the gradient vanishes. So 1 iteration and 2 line-search calls (the
    full step and 1 block of 6 rows); 4 evaluations for each moving row, as a search one
    halving at a time counts them, and 1 for the other: 9, of 3 (the start) + 3 (the full
    step) + 6 (the block) + 3 (the gradient) = 15 rows given to the objective. Reads: the
    loop's test before and after the iteration, the rows still searching after the full
    step and after the block (its last halving is the 3rd of 24), and the evaluations' sum
    at the end: 5."""
    x0 = torch.tensor([[1.0], [0.0], [3.0]], dtype=F64)
    before = dict(profiling.counters())
    with profiling.tracing() as records:
        res = minimize_lbfgs(quadratic, x0)
    grown = delta(before, profiling.counters())
    assert res.x.flatten().tolist() == [0.0, 0.0, 0.0]
    assert res.num_iters.tolist() == [1, 0, 1] and res.num_fun_evals.tolist() == [4, 1, 4]
    assert grown["lbfgs.iterations"] == 1 == int(res.num_iters.max())
    assert grown["lbfgs.line_search_turns"] == 2
    assert grown["lbfgs.line_search_blocks"] == 1
    assert grown["lbfgs.block_rows"] == 6
    assert grown["lbfgs.rows_active"] == 9 == int(res.num_fun_evals.sum())
    assert grown["lbfgs.rows_evaluated"] == 15
    assert grown["host_reads"] == 5
    (call,) = [r for r in records if r.name == "lbfgs.minimize"]
    assert call.attrs == {"R": 3, "n": 1, "iterations": 1, "line_search_turns": 2,
                          "line_search_blocks": 1, "block_rows": 6,
                          "rows_evaluated": 15, "rows_active": 9}
    assert call.host_reads == 5
    assert [r.name for r in records] == [
        "lbfgs.minimize", "lbfgs.direction", "lbfgs.line_search", "lbfgs.gradient"]


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_lbfgs_counters_match_the_results(dtype):
    """On a batch of runs that end at different iterations: the iterations the longest run
    took and the evaluations the runs counted; per iteration a full step, a gradient and
    two reads (the loop's test and the rows still searching after the full step); the
    blocks, their rows and the reads after them as the rule ``K = min(halvings left,
    ⌊2R / S⌋)`` takes them over the searches one halving at a time; 6 rows for the start,
    each full step and each gradient; and the read at the start and the one at the end."""
    A, x0, lower, upper = problem(dtype)
    searches = []
    sequential_minimize_lbfgs(lambda x: bowl(A, x), x0, lower, upper, max_iters=40,
                              searches=searches)
    blocks, rows, reads = block_schedule(searches, 6)
    before = dict(profiling.counters())
    with profiling.tracing() as records:
        res = minimize_lbfgs(lambda x: bowl(A, x), x0, lower, upper, max_iters=40)
    grown = delta(before, profiling.counters())
    (call,) = [r for r in records if r.name == "lbfgs.minimize"]
    iters = grown["lbfgs.iterations"]
    assert iters == int(res.num_iters.max()) == call.attrs["iterations"] == len(searches)
    assert grown["lbfgs.rows_active"] == int(res.num_fun_evals.sum()) == call.attrs["rows_active"]
    assert grown["lbfgs.line_search_blocks"] == blocks == call.attrs["line_search_blocks"] > 0
    assert grown["lbfgs.block_rows"] == rows == call.attrs["block_rows"]
    assert grown["lbfgs.line_search_turns"] == iters + blocks == call.attrs["line_search_turns"]
    assert grown["host_reads"] == 2 * iters + reads + 2 == call.host_reads
    assert grown["lbfgs.rows_evaluated"] == 6 * (1 + 2 * iters) + rows
    assert grown["lbfgs.rows_active"] < grown["lbfgs.rows_evaluated"]  # the runs end apart


def problem(dtype) -> Tuple[torch.Tensor, ...]:
    g = torch.Generator().manual_seed(3)
    A = torch.randn(3, 3, generator=g, dtype=dtype)
    A = A @ A.T + 0.1 * torch.eye(3, dtype=dtype)
    x0 = 1.5 * torch.randn(6, 3, generator=g, dtype=dtype)
    return A, x0, torch.full((3,), -1.0, dtype=dtype), torch.full((3,), 2.0, dtype=dtype)


def bowl(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One function of each row: a quadratic form with ripples, and a non-finite region."""
    value = (x[:, :, None] * A * x[:, None, :]).sum((-2, -1)) + torch.sin(3.0 * x).sum(-1)
    return torch.where(x[:, 0] > 1.9, torch.nan, value)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("bounded", [False, True])
def test_lbfgs_is_bit_for_bit_the_loop_before_counting(dtype, bounded):
    A, x0, lower, upper = problem(dtype)
    bounds = (lower, upper) if bounded else (None, None)
    with profiling.tracing():
        new = minimize_lbfgs(lambda x: bowl(A, x), x0, *bounds, max_iters=40, memory=4)
    old = sequential_minimize_lbfgs(lambda x: bowl(A, x), x0, *bounds, max_iters=40, memory=4)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_chrome_trace_holds_the_spans(tmp_path):
    A, x0, lower, upper = problem(F64)
    with profiling.trace(str(tmp_path / "trace")):
        minimize_lbfgs(lambda x: bowl(A, x), x0, lower, upper, max_iters=5)
    (path,) = (tmp_path / "trace").iterdir()
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"lbfgs.minimize", "lbfgs.direction", "lbfgs.line_search", "lbfgs.gradient"} <= names

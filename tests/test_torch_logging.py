"""The port's summary logging, model summaries, profiling, the remaining single objectives
and small helpers on the CPU, against the JAX package in float64.

The loop with a writer: two EGO steps of an exact GP on ScaledBranin in both packages
(the JAX run's seed pools replayed into the port's, one fit start so that no restart is
drawn) write the same summary names at the same steps, and the same values at rtol 1e-6
(the flush packs device values as float32 in both packages; wall clocks excepted), and
those names are the ones ``chip_smoke.py`` holds the card's run to. The model summaries
of a GP at rtol 1e-9; the writer, step and filter state, the flush interval, the packed
read; ``profiling``; every new objective at numpy-seeded points at rtol 1e-12, with its
minimizers, minima and box; ``map_is_finite``, ``to_numpy`` and the version.
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trieste_tpu as jt
import trieste_tpu.logging as jlog
from trieste_tpu import observer as jobserver
from trieste_tpu import space as jsp
from trieste_tpu import version as jversion
from trieste_tpu.acquisition import optimizer as jopt
from trieste_tpu.acquisition import rule as jrule
from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models import utils as jutils
from trieste_tpu.models.gp import build_gpr as jbuild_gpr
from trieste_tpu.objectives import single_objectives as jobj
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu_torch import BayesianOptimizer, Dataset, logging, observer, profiling
from trieste_tpu_torch import space as tsp
from trieste_tpu_torch import version
from trieste_tpu_torch.acquisition import optimizer as topt
from trieste_tpu_torch.acquisition import rule as trule
from trieste_tpu_torch.models import utils as tutils
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.objectives import single_objectives as tobj
from trieste_tpu_torch.ops import fused_predict
from trieste_tpu_torch.ops.kernels import stationary
from trieste_tpu_torch.utils.misc import to_numpy

torch.set_num_threads(1)

F64 = torch.float64
SUMMARY_RTOL = 1e-6  # both packages round device values to float32 in the flush
OBJECTIVE_RTOL = 1e-12


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=F64)


class Recorder:
    """A summary writer that keeps every event as ``(kind, name, step, value)``."""

    def __init__(self):
        self.events = []

    def add_scalar(self, name, value, step):
        self.events.append(("scalar", name, step, np.asarray(value, dtype=float)))

    def add_histogram(self, name, values, step):
        self.events.append(("histogram", name, step, np.asarray(values, dtype=float)))

    def add_text(self, name, value, step):
        self.events.append(("text", name, step, value))

    def names(self):
        return sorted((step, name) for _, name, step, _ in self.events)

    def values(self):
        return {(step, name): value for kind, name, step, value in self.events
                if kind != "text" and not name.startswith("wallclock/")}


@pytest.fixture(scope="module", autouse=True)
def quick_jax_compiles():
    """XLA's optimizations off while this module runs: compiling dominates the JAX side's
    time, and the results agree to the same tolerances."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(autouse=True)
def _fresh_logging_state():
    """Each test starts with no writer, step 0 and the default filter, in both packages."""
    for module in (logging, jlog):
        module.set_tensorboard_writer(None)
        module.set_step_number(0)
        module.set_summary_filter(module.default_summary_filter)
        module.set_deferred_flush_interval(1)
    yield
    for module in (logging, jlog):
        module.set_tensorboard_writer(None)
        module.set_step_number(0)
        module.set_summary_filter(module.default_summary_filter)
        module.set_deferred_flush_interval(1)


# -- the loop with a writer ------------------------------------------------------------------


@pytest.fixture
def jax_pools(monkeypatch):
    """Record the uniforms of the JAX package's box samples; the port's box samples scale
    them."""
    pools = []
    sample = jsp.Box.sample

    def record(self, key, n):
        pools.append(np.asarray(jax.random.uniform(key, (n, self.dimension), dtype=jnp.float64)))
        return sample(self, key, n)

    def replay(self, generator, n):
        u = pools.pop(0)
        assert u.shape == (n, self.dimension)
        return self._scale(_t(u))

    monkeypatch.setattr(jsp.Box, "sample", record)
    monkeypatch.setattr(tsp.Box, "sample", replay)
    return pools


def _quickstart_in_both(num_steps, jax_pools):
    """``num_steps`` EGO steps of ``build_gpr`` (one fit start) on ScaledBranin from 5
    points in both packages, each with a :class:`Recorder` from step 0."""
    X = np.random.default_rng(3).uniform(size=(5, 2))
    jspace = jsp.Box([0.0, 0.0], [1.0, 1.0])
    tspace = tsp.Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu")
    jds = JDataset.from_arrays(jnp.asarray(X), jobj.scaled_branin(jnp.asarray(X)))
    tds = Dataset.from_arrays(_t(X), _t(jds.trimmed_observations))
    asked = []

    def jobs(qp):
        y = jobj.scaled_branin(qp)
        asked.append((np.asarray(qp), np.asarray(y)))
        return JDataset.from_arrays(qp, y)

    def tobs(qp):
        x, y = asked.pop(0)
        np.testing.assert_allclose(qp.numpy(), x, atol=1e-6)
        return Dataset.from_arrays(_t(x), _t(y))

    jrec, trec = Recorder(), Recorder()
    with jlog.tensorboard_writer(jrec):
        jresult = jt.BayesianOptimizer(jobs, jspace).optimize(
            num_steps, jds, jbuild_gpr(jds, jspace, num_kernel_samples=1),
            jrule.EfficientGlobalOptimization(optimizer=jopt.generate_continuous_optimizer(200, 2)),
            key=jax.random.PRNGKey(5), track_state=False,
        )
    with logging.tensorboard_writer(trec):
        tresult = BayesianOptimizer(tobs, tspace).optimize(
            num_steps, tds, build_gpr(tds, tspace, num_kernel_samples=1),
            trule.EfficientGlobalOptimization(optimizer=topt.generate_continuous_optimizer(200, 2)),
            track_state=False,
        )
    assert jresult.is_ok and tresult.is_ok, tresult.final_result
    assert not jax_pools and not asked
    return jrec, trec


def test_the_loop_writes_the_summaries_of_the_jax_loop(jax_pools):
    """Two steps: the same names at the same steps and the same values; and the names are
    those that ``chip_smoke.QUICKSTART_SUMMARIES_*`` hold the card's quickstart to (at step
    0, and at each step after it)."""
    from chip_smoke import QUICKSTART_SUMMARIES_AT_STEP_0, QUICKSTART_SUMMARIES_PER_STEP

    jrec, trec = _quickstart_in_both(2, jax_pools)
    assert trec.names() == jrec.names()
    jvalues, tvalues = jrec.values(), trec.values()
    assert tvalues.keys() == jvalues.keys()
    for key, want in jvalues.items():
        np.testing.assert_allclose(tvalues[key], want, rtol=SUMMARY_RTOL, atol=1e-9, err_msg=str(key))
    assert jrec.names() == sorted([(0, n) for n in QUICKSTART_SUMMARIES_AT_STEP_0]
                                  + [(s, n) for s in (1, 2) for n in QUICKSTART_SUMMARIES_PER_STEP])


# -- model summaries ---------------------------------------------------------------------------


def _gpr_pair(n=7, seed=0):
    X = np.random.default_rng(seed).uniform(size=(n, 2))
    Y = np.sin(3 * X[:, :1]) + X[:, 1:] ** 2
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y))
    tds = Dataset.from_arrays(_t(X), _t(Y))
    jm = jbuild_gpr(jds, jsp.Box([0.0, 0.0], [1.0, 1.0]), likelihood_variance=1e-3)
    tm = build_gpr(tds, tsp.Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu"), likelihood_variance=1e-3)
    return (jm, jds), (tm, tds)


def test_model_summaries_match_jax():
    """The GP's ``log`` with its data, the data-based metrics under a prefix, and the kernel
    and likelihood writers (ARD and one lengthscale): the same names, steps and values."""
    (jm, jds), (tm, tds) = _gpr_pair()
    recorders = []
    for log, model, ds, utils, kern in ((jlog, jm, jds, jutils, jstationary("rbf", 2.0, [0.3, 0.4])),
                                        (logging, tm, tds, tutils, stationary("rbf", 2.0, [0.3, 0.4], device="cpu"))):
        rec = Recorder()
        with log.tensorboard_writer(rec), log.step_number(4):
            model.log(ds)
            utils.write_summary_data_based_metrics(ds, model, prefix="m.")
            utils.write_summary_kernel_parameters(kern)
            utils.write_summary_kernel_parameters(kern.replace(lengthscales=kern.lengthscales[:1]), prefix="iso.")
            utils.write_summary_likelihood_parameters(0.01 if log is jlog else torch.tensor(0.01))
            log.flush_deferred_summaries()
        recorders.append(rec)
    jrec, trec = recorders
    assert trec.names() == jrec.names() and len(trec.events) == 2 * 14 + 4 + 3 + 2 + 1
    assert {n for _, n in trec.names()} >= {"m.accuracy/z_residuals_std", "kernel.lengthscales[1]",
                                          "iso.kernel.lengthscales", "kernel.lengthscale[1]"}
    for key, want in jrec.values().items():
        np.testing.assert_allclose(trec.values()[key], want, rtol=SUMMARY_RTOL, atol=1e-9, err_msg=str(key))


def test_data_based_metrics_are_the_plain_formulas():
    """The eight scalars against numpy on the model's own predictions, at rtol 1e-9 (the
    float32 packing aside: read here from the tensors the metrics queue)."""
    (_, _), (tm, tds) = _gpr_pair(n=9, seed=1)
    mean, var, scalars, abs_diffs, z, verr = (t.numpy() for t in tutils._metrics(tm, *tds.astuple()))
    y = tds.trimmed_observations.numpy()
    d = y - mean
    want = [mean.mean(), var.mean(), y.mean(), y.var(), np.sqrt((d**2).mean()), np.abs(d).mean(),
            (d / np.sqrt(var)).std(), np.sqrt(((var - d**2) ** 2).mean())]
    np.testing.assert_allclose(scalars, want, rtol=1e-9)
    np.testing.assert_allclose(abs_diffs, np.abs(d), rtol=1e-12)


def test_no_summaries_without_a_writer_or_with_no_data():
    (_, _), (tm, tds) = _gpr_pair()
    tm.log(tds)
    tutils.write_summary_data_based_metrics(tds, tm)
    assert logging._DEFERRED == []
    rec = Recorder()
    with logging.tensorboard_writer(rec):
        empty = Dataset.from_arrays(torch.zeros(0, 2, dtype=F64), torch.zeros(0, 1, dtype=F64))
        tutils.write_summary_data_based_metrics(empty, tm)
        logging.flush_deferred_summaries()
    assert rec.events == []


# -- writers, steps, filters and the flush ------------------------------------------------------


def _read_events(logdir):
    with open(Path(logdir) / "events.jsonl") as f:
        return [json.loads(line) for line in f]


def test_jsonl_writer_event_shapes(tmp_path):
    w = logging.JsonlSummaryWriter(str(tmp_path))
    with logging.tensorboard_writer(w), logging.step_number(3):
        logging.scalar("loss", 1.5)
        logging.histogram("qp", torch.arange(10.0))
        logging.histogram("empty", np.zeros(0))
        logging.text("meta", "hello")
    w.close()
    events = _read_events(tmp_path)
    assert [e["tag"] for e in events] == ["loss", "qp", "empty", "meta"]
    assert all(e["step"] == 3 for e in events)
    assert events[0]["value"] == 1.5
    h = events[1]["histogram"]
    assert h["count"] == 10 and h["min"] == 0.0 and h["max"] == 9.0 and h["mean"] == 4.5
    assert events[2]["histogram"]["count"] == 0
    assert events[3]["text"] == "hello"


@pytest.mark.parametrize("name", ["a/b", "a/_b", "_a", "wallclock/step", "other", "x/y/_z", ""])
def test_filters_match_jax(name):
    assert logging.default_summary_filter(name) == jlog.default_summary_filter(name)
    for include, exclude in (("*", "_*"), ("wallclock*", "_*"), ("a*", "*b")):
        assert (logging.SummaryFilterPatterns(include, exclude)(name)
                == jlog.SummaryFilterPatterns(include, exclude)(name))


def test_underscore_summaries_are_filtered_and_a_custom_filter_applies(tmp_path):
    w = logging.JsonlSummaryWriter(str(tmp_path))
    with logging.tensorboard_writer(w):
        logging.scalar("_hidden", 1.0)
        logging.scalar("group/_hidden", 2.0)
        logging.scalar("visible", 3.0)
        logging.set_summary_filter(logging.SummaryFilterPatterns(include="wallclock*"))
        assert logging.get_summary_filter()("wallclock/x") and not logging.include_summary("visible")
        logging.scalar("visible", 4.0)
        logging.scalar("wallclock/x", 5.0)
    w.close()
    assert [e["tag"] for e in _read_events(tmp_path)] == ["visible", "wallclock/x"]


def test_closures_are_not_evaluated_without_a_writer_or_when_filtered():
    calls = []

    def closure():
        calls.append(1)
        return 1.0

    logging.scalar("x", closure)
    logging.deferred_scalar("x", closure)
    logging.deferred_histogram("x", closure)
    logging.deferred_scalar_vector(["x"], closure)
    logging.flush_deferred_summaries()

    class Refuses:
        def add_scalar(self, *args, **kwargs):
            raise AssertionError("a filtered summary was written")

    with logging.tensorboard_writer(Refuses()):
        logging.set_summary_filter(lambda name: False)
        logging.deferred_scalar("excluded", closure)
        logging.deferred_scalar_vector(["excluded"], closure)
        logging.scalar("excluded", closure)
        logging.flush_deferred_summaries()
    assert calls == []


def test_errors_are_printed_and_swallowed_per_entry(tmp_path, capsys):
    w = logging.JsonlSummaryWriter(str(tmp_path))
    with logging.tensorboard_writer(w), logging.step_number(2):
        logging.scalar("bad", lambda: 1 / 0)
        logging.text("bad text", lambda: 1 / 0)
        logging.deferred_scalar("bad deferred", lambda: 1 / 0)
        logging.deferred_histogram("no histogram", "not numbers")
        logging.deferred_scalar("good", torch.tensor(2.5, dtype=F64))
        logging.flush_deferred_summaries()
    w.close()
    out = capsys.readouterr().out
    for name in ("scalar bad", "text bad text", "scalar bad deferred", "histogram no histogram"):
        assert f"failed to log {name}" in out
    assert [(e["tag"], e["value"]) for e in _read_events(tmp_path)] == [("good", 2.5)]


def test_make_summary_writer_prefers_tensorboard_and_falls_back(tmp_path, monkeypatch):
    """TensorBoard's writer where ``torch.utils.tensorboard`` imports (a stand-in module
    here: the real import is slow), the JSON-lines writer where it does not or where it is
    not preferred."""
    import sys
    import types

    class SummaryWriter:
        def __init__(self, logdir):
            self.logdir = logdir

    jl = logging.make_summary_writer(str(tmp_path / "jl"), prefer_tensorboard=False)
    assert isinstance(jl, logging.JsonlSummaryWriter)
    jl.close()
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=SummaryWriter))
    tb = logging.make_summary_writer(str(tmp_path / "tb"))
    assert isinstance(tb, SummaryWriter) and tb.logdir == str(tmp_path / "tb")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the import fails
    fallback = logging.make_summary_writer(str(tmp_path / "fallback"))
    assert isinstance(fallback, logging.JsonlSummaryWriter)
    fallback.close()


def test_writer_and_step_contexts_restore_and_validate():
    rec, other = Recorder(), Recorder()
    logging.set_step_number(7)
    with logging.tensorboard_writer(rec), logging.step_number(2):
        assert logging.get_tensorboard_writer() is rec and logging.get_step_number() == 2
        with logging.tensorboard_writer(other):
            assert logging.get_tensorboard_writer() is other
        assert logging.get_tensorboard_writer() is rec
    assert logging.get_tensorboard_writer() is None and logging.get_step_number() == 7
    with pytest.raises(ValueError):
        logging.set_step_number(-1)
    with pytest.raises(ValueError):
        logging.set_deferred_flush_interval(0)


def test_deferred_values_are_read_at_the_flush_with_their_queued_steps():
    calls = []
    rec = Recorder()
    with logging.tensorboard_writer(rec):
        logging.set_step_number(4)
        logging.deferred_scalar("hot/improvement", lambda: calls.append(1) or torch.tensor(3.5))
        logging.deferred_histogram("hot/points", torch.arange(5.0, dtype=F64))
        logging.deferred_scalar_vector(["v[0]", "_v[1]", "v[2]"], torch.tensor([1.0, 2.0, 3.0]))
        assert calls == [] and rec.events == []
        logging.set_step_number(5)
        logging.flush_deferred_summaries()
    assert calls == [1]
    got = {name: (step, value) for _, name, step, value in rec.events}
    assert set(got) == {"hot/improvement", "hot/points", "v[0]", "v[2]"}
    assert all(step == 4 for step, _ in got.values())
    assert got["hot/improvement"][1] == 3.5 and got["v[2]"][1] == 3.0
    np.testing.assert_array_equal(got["hot/points"][1], np.arange(5.0))


def test_the_flush_reads_every_tensor_in_one_packed_transfer(monkeypatch):
    """Scalars, vectors, histograms and closures of tensors come back through one
    ``.cpu()`` of one concatenated float32 vector, each with its shape."""
    reads = []
    cpu = torch.Tensor.cpu

    def counting(self, *args, **kwargs):
        reads.append(tuple(self.shape))
        return cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    rec = Recorder()
    with logging.tensorboard_writer(rec):
        logging.deferred_scalar("s", torch.tensor(1.25, dtype=F64))
        logging.deferred_scalar("closure", lambda: torch.tensor([2.0]).sum())
        logging.deferred_scalar_vector(["a", "b"], torch.tensor([3.0, 4.0]))
        logging.deferred_histogram("h", torch.arange(6.0).reshape(2, 3))
        logging.deferred_scalar("host", 7.0)
        logging.flush_deferred_summaries()
    assert reads == [(1 + 1 + 2 + 6,)]
    got = {name: value for _, name, _, value in rec.events}
    assert got["s"] == 1.25 and got["closure"] == 2.0 and got["a"] == 3.0 and got["b"] == 4.0
    assert got["host"] == 7.0 and got["h"].shape == (2, 3) and got["h"][1, 2] == 5.0


def test_the_flush_interval_and_detaching_the_writer():
    rec = Recorder()
    logging.set_tensorboard_writer(rec)
    logging.set_deferred_flush_interval(3)
    for step in range(1, 3):
        logging.set_step_number(step)
        logging.deferred_scalar("x", float(step))
        logging.flush_deferred_summaries()
    assert rec.events == []
    logging.set_step_number(3)
    logging.deferred_scalar("x", 3.0)
    logging.flush_deferred_summaries()
    assert [(s, float(v)) for _, _, s, v in rec.events] == [(1, 1.0), (2, 2.0), (3, 3.0)]
    logging.deferred_scalar("x", 4.0)
    logging.flush_deferred_summaries(force=True)
    assert len(rec.events) == 4
    logging.deferred_scalar("x", 5.0)
    logging.set_tensorboard_writer(None)  # detaching flushes to the outgoing writer
    assert len(rec.events) == 5 and logging._DEFERRED == []


def test_pyplot_saves_a_figure_where_the_writer_takes_figures(tmp_path):
    class Figure:
        def savefig(self, path, dpi):
            Path(path).write_bytes(b"png")

    w = logging.JsonlSummaryWriter(str(tmp_path))
    with logging.tensorboard_writer(w), logging.step_number(3):
        logging.pyplot("OBJECTIVE.observations/pairplot", Figure())
        logging.pyplot("OBJECTIVE.observations/_pairplot", Figure())  # filtered
    w.close()
    (event,) = _read_events(tmp_path)
    assert event["figure"].endswith("OBJECTIVE.observations_pairplot.0003.png")
    assert Path(event["figure"]).read_bytes() == b"png"
    with logging.tensorboard_writer(Recorder()):  # no add_figure: nothing written, no error
        logging.pyplot("fig", Figure)


def test_ego_defers_its_query_point_histogram():
    (_, _), (tm, tds) = _gpr_pair()
    rec = Recorder()
    with logging.tensorboard_writer(rec), logging.step_number(3):
        rule = trule.EfficientGlobalOptimization(optimizer=topt.generate_continuous_optimizer(32, 2))
        points = rule.acquire_single(tsp.Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu"), tm, tds,
                                     generator=torch.Generator().manual_seed(0))
        assert [e[1] for e in rec.events] == ["spo_af_evaluations"]
        logging.flush_deferred_summaries()
    hist = {name: value for _, name, _, value in rec.events}
    np.testing.assert_allclose(hist["EGO.query_points"], points.numpy().astype(np.float32))
    assert "spo_improvement_on_initial_samples" in hist


# -- profiling ---------------------------------------------------------------------------------


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.rand(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    (path,) = (tmp_path / "trace").iterdir()
    trace = json.loads(path.read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_compile_counts_and_assert_no_recompiles(monkeypatch):
    sizes = profiling.compile_cache_sizes()
    assert set(sizes) == {"fused_predict_builds", "fused_predict_loads"}
    with profiling.assert_no_recompiles():
        torch.rand(8).sum()
    with pytest.raises(AssertionError, match="unexpected recompilations"):
        with profiling.assert_no_recompiles():
            monkeypatch.setattr(fused_predict, "builds", fused_predict.builds + 1)


# -- objectives and small helpers ---------------------------------------------------------------

NEW_PROBLEMS = ("GramacyLee", "LogarithmicGoldsteinPrice", "Hartmann3", "Shekel4", "Levy8",
                "Rosenbrock4", "Ackley5", "Michalewicz2", "Michalewicz5", "Michalewicz10", "Trid10")
RAW_FUNCTIONS = ("gramacy_lee", "logarithmic_goldstein_price", "hartmann_3", "shekel_4", "levy_8",
                 "rosenbrock_4", "ackley_5", "levy", "rosenbrock", "michalewicz", "michalewicz_2",
                 "michalewicz_5", "michalewicz_10", "trid", "trid_10", "hartmann_6")


@pytest.mark.parametrize("name", NEW_PROBLEMS)
def test_new_objectives_match_jax(name):
    jp, tp = getattr(jobj, name), getattr(tobj, name)
    assert tp.name == jp.name and tp.dim == jp.dim
    lower, upper = np.asarray(jp.search_space.lower), np.asarray(jp.search_space.upper)
    np.testing.assert_array_equal(tp.search_space.to("cpu", F64).lower.numpy(), lower)
    np.testing.assert_array_equal(tp.search_space.to("cpu", F64).upper.numpy(), upper)
    np.testing.assert_allclose(tp.minimizers, np.asarray(jp.minimizers), rtol=OBJECTIVE_RTOL)
    np.testing.assert_allclose(tp.minimum, np.asarray(jp.minimum), rtol=OBJECTIVE_RTOL)
    x = lower + (upper - lower) * np.random.default_rng(7).uniform(size=(3, 4, tp.dim))
    for points in (x, tp.minimizers):
        got = tp.objective(_t(points)).numpy()
        assert got.shape == points.shape[:-1] + (1,)
        np.testing.assert_allclose(got, np.asarray(jax.jit(jp.objective)(jnp.asarray(points))),
                                   rtol=OBJECTIVE_RTOL, atol=1e-13)
    at_min = tp.objective(_t(tp.minimizers)).numpy()
    np.testing.assert_allclose(at_min, np.broadcast_to(tp.minimum, at_min.shape), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", RAW_FUNCTIONS)
def test_raw_objective_functions_match_jax(name):
    d = {"gramacy_lee": 1, "logarithmic_goldstein_price": 2, "hartmann_3": 3, "shekel_4": 4,
         "levy_8": 8, "rosenbrock_4": 4, "ackley_5": 5, "hartmann_6": 6}.get(name, 5)
    x = np.random.default_rng(11).uniform(0.5, 1.0, size=(6, d))
    np.testing.assert_allclose(getattr(tobj, name)(_t(x)).numpy(),
                               np.asarray(jax.jit(getattr(jobj, name))(jnp.asarray(x))), rtol=OBJECTIVE_RTOL)


def test_check_objective_shapes():
    checked = tobj.check_objective_shapes(2)(tobj.branin)
    assert checked(torch.zeros(3, 2)).shape == (3, 1)
    with pytest.raises(ValueError, match="expects"):
        checked(torch.zeros(3, 3))
    with pytest.raises(ValueError, match="returned"):
        tobj.check_objective_shapes(2)(lambda x: x)(torch.zeros(3, 2))


def test_map_is_finite_matches_jax():
    X = np.random.default_rng(0).uniform(size=(5, 2))
    Y = np.array([[1.0, 2.0], [np.nan, 0.0], [3.0, np.inf], [0.0, 0.0], [-np.inf, 1.0]])
    got, want = observer.map_is_finite(_t(X), _t(Y)), jobserver.map_is_finite(jnp.asarray(X), jnp.asarray(Y))
    np.testing.assert_array_equal(got.trimmed_observations.numpy(), np.asarray(want.trimmed_observations))
    np.testing.assert_array_equal(got.trimmed_query_points.numpy(), X)
    assert got.trimmed_observations.dtype == F64


def test_to_numpy_and_the_version():
    x = torch.arange(4.0, requires_grad=True) * 2
    np.testing.assert_array_equal(to_numpy(x), [0.0, 2.0, 4.0, 6.0])
    assert version.VERSION == version.__version__ == jversion.VERSION

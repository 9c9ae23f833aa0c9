"""The port's experimental plotting and the loop's pairplot summaries on the CPU, against
the JAX package.

The data each function plots is held to the JAX function's on the same inputs: a recording
axis takes the place of matplotlib's and keeps every call with its arrays (the grid, the
point markers, the feasibility mask, the Pareto front, the pairplot's groups). Every figure
of the port builds with the Agg backend, and a GIF round-trips through PIL. The plotly
functions raise ``ImportError`` without plotly, which is not installed here. The loop's two
pairplot branches write, with a filter that admits ``_pairplot``, the names at the steps the
JAX loop writes on the same run (two steps of random sampling on a two-output problem, the
JAX draws replayed) and nothing with the default filter.
"""
from __future__ import annotations

import importlib
import io
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402

import trieste_tpu as jt  # noqa: E402
import trieste_tpu.logging as jlog  # noqa: E402
from trieste_tpu import space as jsp  # noqa: E402
from trieste_tpu.acquisition import rule as jrule  # noqa: E402
from trieste_tpu.data import Dataset as JDataset  # noqa: E402
from trieste_tpu.experimental import plotting as jplot  # noqa: E402
from trieste_tpu.experimental.plotting import plotting_plotly as jplotly  # noqa: E402
from trieste_tpu_torch import BayesianOptimizer, Dataset, logging  # noqa: E402
from trieste_tpu_torch import bayesian_optimizer as tbo  # noqa: E402
from trieste_tpu_torch import space as tsp  # noqa: E402
from trieste_tpu_torch.acquisition import rule as trule  # noqa: E402
from trieste_tpu_torch.experimental import plotting as tplot  # noqa: E402
from trieste_tpu_torch.experimental.plotting import plotting_plotly as tplotly  # noqa: E402

# the packages' ``pairplot`` names their function, which hides the module of that name
jpair = importlib.import_module("trieste_tpu.experimental.plotting.pairplot")
tpair = importlib.import_module("trieste_tpu_torch.experimental.plotting.pairplot")
tplotting = importlib.import_module("trieste_tpu_torch.experimental.plotting.plotting")

F64 = torch.float64


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=F64)


class RecordingAxis:
    """An axis that keeps each call as ``(method, args, kwargs)``, arrays as numpy."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args, **kwargs):
            self.calls.append((name, [np.asarray(a) for a in args], kwargs))

        return record


def _same_calls(got: RecordingAxis, want: RecordingAxis):
    assert [c[0] for c in got.calls] == [c[0] for c in want.calls]
    for (name, args, kwargs), (_, wargs, wkwargs) in zip(got.calls, want.calls):
        assert kwargs == wkwargs, name
        assert len(args) == len(wargs), name
        for a, w in zip(args, wargs):
            if np.issubdtype(w.dtype, np.number) or w.dtype == bool:
                np.testing.assert_allclose(a.astype(float), w.astype(float), rtol=1e-12, err_msg=name)
            else:
                np.testing.assert_array_equal(a, w, err_msg=name)


@pytest.fixture(scope="module", autouse=True)
def quick_jax_compiles():
    """XLA's optimizations off while this module runs: the JAX loop's time is compiling."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def test_create_grid_matches_jax():
    for mins, maxs, density in (([0.0, -1.0], [1.0, 2.0], 7), ([-5.0, 0.0], [10.0, 15.0], 30)):
        for got, want in zip(tplot.create_grid(_t(mins), _t(maxs), density),
                             jplot.create_grid(jnp.asarray(mins), jnp.asarray(maxs), density)):
            np.testing.assert_array_equal(got, want)


def test_format_point_markers_match_jax():
    fail = np.array([0, 0, 1, 0, 0, 1], bool)
    for kwargs in (dict(num_init=2, idx_best=[5], mask_fail=fail), dict(num_init=0),
                   dict(num_init=6, idx_best=[0, 3])):
        for got, want in zip(tplot.format_point_markers(6, **kwargs),
                             jplot.format_point_markers(6, **kwargs)):
            np.testing.assert_array_equal(got, want)
    got = tplot.format_point_markers(6, num_init=2, mask_fail=torch.as_tensor(fail))
    np.testing.assert_array_equal(got[1], jplot.format_point_markers(6, num_init=2, mask_fail=fail)[1])
    for kwargs in (dict(num_init=2, idx_best=4, mask_fail=fail), dict(num_init=3)):
        for got, want in zip(tplotly.format_point_markers(6, **kwargs),
                             jplotly.format_point_markers(6, **kwargs)):
            np.testing.assert_array_equal(got, want)


def _constrained_boxes():
    A, lb, ub = np.array([[1.0, 1.0], [1.0, -2.0]]), np.array([0.5, -1.0]), np.array([1.5, 0.3])
    jspace = jsp.Box([0.0, 0.0], [1.0, 1.0], constraints=[jsp.LinearConstraint(A, lb, ub)])
    tspace = tsp.Box([0.0, 0.0], [1.0, 1.0], [tsp.LinearConstraint(A, lb, ub)], dtype=F64,
                     device="cpu")
    return jspace, tspace


def test_the_feasibility_mask_matches_jax():
    jspace, tspace = _constrained_boxes()
    got, want = RecordingAxis(), RecordingAxis()
    tplot.plot_feasible_region_2d(tspace, got, grid_density=41)
    jplot.plot_feasible_region_2d(jspace, want, grid_density=41)
    _same_calls(got, want)
    mask = got.calls[0][1][2]
    assert mask.shape == (41, 41) and 0 < mask.mean() < 1


def test_the_pareto_front_matches_jax():
    obs = np.random.default_rng(0).uniform(size=(30, 2))
    for reference in (None, np.array([1.1, 1.1])):
        got, want = RecordingAxis(), RecordingAxis()
        tplot.plot_pareto_front_2d(_t(obs), got, reference_point=reference)
        jplot.plot_pareto_front_2d(obs, want, reference_point=reference)
        _same_calls(got, want)
    got, want = RecordingAxis(), RecordingAxis()
    tplot.plot_mobo_points_in_obj_space(_t(obs), ax=got)
    jplot.plot_mobo_points_in_obj_space(obs, ax=want)
    _same_calls(got, want)


def test_observation_groups_and_the_pairplot_match_jax():
    mask = np.array([1, 0, 0, 1, 0, 1, 1], bool)
    for args in ((2, 3, 2), (0, 0, 4), (7, 0, 0)):
        assert tpair.observation_groups(*args) == jpair.observation_groups(*args)
        n = sum(args)
        assert tpair.observation_groups(*args, mask[:n]) == jpair.observation_groups(*args, mask[:n])
    data = np.random.default_rng(1).uniform(size=(7, 3))
    groups = jpair.observation_groups(2, 3, 2, mask)
    got, want = tpair.pairplot(_t(data), groups), jpair.pairplot(data, groups)
    assert len(got.axes) == len(want.axes) == 9
    for a, w in zip(got.axes, want.axes):
        for ca, cw in zip(a.collections, w.collections):
            np.testing.assert_array_equal(ca.get_offsets(), cw.get_offsets())
    assert ([t.get_text() for t in got.legends[0].get_texts()]
            == [t.get_text() for t in want.legends[0].get_texts()])


class _Sim:
    threshold = 0.5

    @staticmethod
    def objective(x):
        return torch.sum(torch.square(x - 0.3), dim=-1, keepdim=True)

    @staticmethod
    def constraint(x):
        return x[..., :1] + 0.2 * x[..., 1:]


class _Sim2(_Sim):
    @staticmethod
    def objective(x):
        return torch.cat([_Sim.objective(x), x[..., :1]], dim=-1)


def test_the_grid_goes_to_the_device_of_its_bounds():
    """Tensor bounds keep their device and dtype; other bounds send the grid to ``cuda``, as
    the search spaces send arrays, so on a machine without a card the call raises."""
    points = tplot.create_grid([0.0, 0.0], [1.0, 1.0], 3)[0]
    grid = tplotting._on_device_of(points, _t([0.0, 0.0]))
    assert grid.device.type == "cpu" and grid.dtype == F64
    f32 = tplotting._on_device_of(points, torch.zeros(2, dtype=torch.float32))
    assert f32.dtype == torch.float32
    if torch.cuda.is_available():
        assert tplotting._on_device_of(points, [0.0, 0.0]).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tplotting._on_device_of(points, np.zeros(2))
        with pytest.raises((AssertionError, RuntimeError)):
            tplot.plot_function_2d(lambda x: x.sum(-1), [0.0, 0.0], [1.0, 1.0], grid_density=3)


def test_every_figure_builds_and_a_gif_round_trips():
    from PIL import Image

    from trieste_tpu_torch.models.gp import build_gpr
    from trieste_tpu_torch.objectives import ScaledBranin

    _, tspace = _constrained_boxes()
    mins, maxs = _t([0.0, 0.0]), _t([1.0, 1.0])
    rng = np.random.default_rng(2)
    X = _t(rng.uniform(size=(8, 2)))
    data = Dataset.from_arrays(X, ScaledBranin.objective(X))
    fig, axes = plt.subplots(2, 3)
    tplot.plot_regret(data.trimmed_observations, axes[0][0], num_init=3, minimum=-1.05)
    tplot.plot_bo_points(X, axes[0][1], num_init=3, idx_best=4)
    points, XX, YY = tplot.create_grid(mins, maxs, 12)
    assert tplot.plot_surface(XX, YY, (points**2).sum(-1), axes[0][2], contour=True, fill=True)
    tplot.plot_mobo_history(_t(rng.uniform(size=(10, 2))), lambda o: float(o.min()), 3, axes[1][0])
    tplot.plot_feasible_region_2d(tspace, axes[1][1], grid_density=20)
    tplot.plot_pareto_front_2d(_t(rng.uniform(size=(10, 2))), axes[1][2], reference_point=_t([1.0, 1.0]))
    frames = [tplot.convert_figure_to_frame(fig)]
    model = build_gpr(data, tsp.Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu"))
    made = [
        tplot.plot_function_2d(ScaledBranin.objective, mins, maxs, grid_density=10, title="f")[0],
        tplot.plot_gp_2d(model, mins, maxs, grid_density=10)[0],
        tplot.plot_acq_function_2d(lambda x: -model.predict(x[..., 0, :])[0], mins, maxs,
                                   grid_density=10, title="acq")[0],
        tplot.plot_constrained_objective_2d(tspace, lambda x: (x**2).sum(-1), grid_density=20)[0],
        tplot.plot_trust_region_history_2d(
            ScaledBranin.objective, mins, maxs,
            [SimpleNamespace(acquisition_state=SimpleNamespace(
                subspaces=[SimpleNamespace(lower=_t([0.2, 0.2]), upper=_t([0.6, 0.5]))]),
                datasets={"OBJECTIVE": data})], num_init=3)[0],
        tplot.plot_mobo_points_in_obj_space(_t(rng.uniform(size=(10, 2)))).figure,
        tplot.plot_objective_and_constraints(tspace, _Sim),
        tplot.plot_init_query_points(tspace, _Sim, torch.cat([X, data.trimmed_observations], -1),
                                     torch.cat([X, _Sim.constraint(X)], -1),
                                     (X[:2], _Sim.constraint(X[:2]))),
        *tplot.plot_2obj_cst_query_points(tspace, _Sim2, torch.cat([X, X[:, :1]], -1),
                                          torch.cat([X, _Sim.constraint(X)], -1)),
        tpair.pairplot(X),
    ]
    assert all(isinstance(f, matplotlib.figure.Figure) for f in made)
    frames.append(tplot.convert_figure_to_frame(made[0]))
    assert frames[0].ndim == 3 and frames[0].shape[-1] == 3
    assert frames[0].shape == frames[1].shape
    gif = tplot.convert_frames_to_gif(frames, duration=400)
    image = Image.open(io.BytesIO(gif.read()))
    assert image.format == "GIF" and image.n_frames == 2 and image.size == frames[0].shape[1::-1]


def test_the_plotly_figures_raise_without_plotly():
    assert not tplotly.PLOTLY_AVAILABLE and not jplotly.PLOTLY_AVAILABLE
    for call in (lambda: tplotly.add_surface_plotly(np.eye(2), np.eye(2), np.eye(2), fig=None),
                 lambda: tplotly.plot_function_plotly(lambda x: x, [0.0, 0.0], [1.0, 1.0]),
                 lambda: tplotly.plot_model_predictions_plotly(None, [0.0, 0.0], [1.0, 1.0]),
                 lambda: tplotly.add_bo_points_plotly(np.zeros(2), np.zeros(2), np.zeros(2), None)):
        with pytest.raises(ImportError, match="plotly"):
            call()
    assert tplot.PLOTLY_AVAILABLE is False and "format_point_markers" in dir(tplotly)


# -- the loop's pairplot branches ------------------------------------------------------------


class Recorder:
    """A summary writer that keeps ``(kind, name, step)`` and each figure's legend."""

    def __init__(self):
        self.events = []
        self.legends = {}

    def add_scalar(self, name, value, step):
        self.events.append(("scalar", name, step))

    def add_histogram(self, name, values, step):
        self.events.append(("histogram", name, step))

    def add_text(self, name, value, step):
        self.events.append(("text", name, step))

    def add_figure(self, name, figure, step):
        self.events.append(("figure", name, step))
        self.legends[(step, name)] = [t.get_text() for t in figure.legends[0].get_texts()]

    def names(self):
        return sorted((step, name) for _, name, step in self.events)


class _Idle:
    """A model the random rule never asks: nothing to fit, nothing to log."""

    def update(self, dataset):
        pass

    def optimize(self, dataset):
        return None

    def log(self, dataset=None):
        pass


def _two_objectives(x):
    return np.stack([np.sum(np.square(x - 0.3), -1), np.sum(np.square(x - 0.7), -1)], -1)


@pytest.fixture
def summary_state():
    for module in (logging, jlog):
        module.set_tensorboard_writer(None)
        module.set_step_number(0)
    yield
    for module in (logging, jlog):
        module.set_tensorboard_writer(None)
        module.set_step_number(0)
        module.set_summary_filter(module.default_summary_filter)


def _loops(monkeypatch, admit_pairplots: bool):
    """Two steps of random sampling (3 points each) on a two-output problem from 5 points,
    in both packages with a :class:`Recorder`; the JAX box draws are replayed."""
    pools = []
    sample = jsp.Box.sample

    def record(self, key, n):
        pools.append(np.asarray(jax.random.uniform(key, (n, self.dimension), dtype=jnp.float64)))
        return sample(self, key, n)

    monkeypatch.setattr(jsp.Box, "sample", record)
    monkeypatch.setattr(tsp.Box, "sample", lambda self, generator, n: self._scale(_t(pools.pop(0))))
    for module in (logging, jlog):
        module.set_summary_filter((lambda name: True) if admit_pairplots else module.default_summary_filter)
    X = np.random.default_rng(4).uniform(size=(5, 2))
    jrec, trec = Recorder(), Recorder()
    with jlog.tensorboard_writer(jrec):
        jresult = jt.BayesianOptimizer(
            lambda x: JDataset.from_arrays(x, jnp.asarray(_two_objectives(np.asarray(x)))),
            jsp.Box([0.0, 0.0], [1.0, 1.0]),
        ).optimize(2, JDataset.from_arrays(jnp.asarray(X), jnp.asarray(_two_objectives(X))),
                   _Idle(), jrule.RandomSampling(3), key=jax.random.PRNGKey(1), track_state=False)
    with logging.tensorboard_writer(trec):
        tresult = BayesianOptimizer(
            lambda x: Dataset.from_arrays(x, _t(_two_objectives(x.numpy()))),
            tsp.Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu"),
        ).optimize(2, Dataset.from_arrays(_t(X), _t(_two_objectives(X))), _Idle(),
                   trule.RandomSampling(3), track_state=False)
    assert jresult.is_ok and tresult.is_ok, tresult.final_result
    assert not pools
    return jrec, trec


def test_the_pairplot_branches_write_what_the_jax_loop_writes(monkeypatch, summary_state):
    jrec, trec = _loops(monkeypatch, admit_pairplots=True)
    assert trec.names() == jrec.names()
    figures = sorted((step, name) for kind, name, step in trec.events if kind == "figure")
    assert figures == [(s, n) for s in (1, 2)
                       for n in ("OBJECTIVE.observations/_pairplot", "OBJECTIVE.query_points/_pairplot")]
    assert trec.legends == jrec.legends
    assert "initial (non-dominated)" in trec.legends[(2, "OBJECTIVE.observations/_pairplot")]
    assert trec.legends[(2, "OBJECTIVE.query_points/_pairplot")] == ["initial", "old"]


def test_the_default_filter_hides_the_pairplots(monkeypatch, summary_state):
    jrec, trec = _loops(monkeypatch, admit_pairplots=False)
    assert trec.names() == jrec.names()
    assert not any("_pairplot" in name for _, name in trec.names())


def test_only_an_absent_matplotlib_is_passed_over(monkeypatch, summary_state):
    """Without matplotlib the branches write nothing; a fault in the plotting code ends
    the run as an error (the JAX package's branches swallow both)."""
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        rec = Recorder()
        logging.set_summary_filter(lambda name: True)
        with logging.tensorboard_writer(rec):
            data = Dataset.from_arrays(_t(np.eye(3)[:, :2]), _t(np.eye(3)[:, :2]))
            tbo.write_summary_query_points({"OBJECTIVE": data}, {"OBJECTIVE": 1})
            tbo.write_summary_observations({"OBJECTIVE": data}, {}, {}, SimpleNamespace(time=0.0))
            logging.flush_deferred_summaries()
        assert rec.events and not any(kind == "figure" for kind, _, _ in rec.events)

    def broken(*args, **kwargs):
        raise ValueError("a fault in the pairplot")

    monkeypatch.setattr(tpair, "pairplot", broken)
    rec = Recorder()
    logging.set_summary_filter(lambda name: True)
    with logging.tensorboard_writer(rec):
        result = BayesianOptimizer(
            lambda x: Dataset.from_arrays(x, _t(_two_objectives(x.numpy()))),
            tsp.Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu"),
        ).optimize(1, Dataset.from_arrays(_t(np.eye(3)[:, :2]), _t(_two_objectives(np.eye(3)[:, :2]))),
                   _Idle(), trule.RandomSampling(2), track_state=False,
                   generator=torch.Generator().manual_seed(0))
    assert result.is_err and "a fault in the pairplot" in str(result.final_result.error)

"""``BENCHMARK.json`` against the rules of its format, and every cell resolved to its
files by name."""
import json
import math
import re

import pytest
import torch

from benchmarks.harness import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["command"] == ["python3", "benchmarks/run.py"]
    assert BENCH["paths"] == ["benchmarks"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check of 24 cells must fit its 43200 seconds
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(BENCH["configs"]) <= 24


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["source"] in SOURCES and m["better"] in ("lower", "higher")
        assert UNIT.match(m["unit"])
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)


def test_end_to_end_and_per_layer_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        # every cell the metric lists reports the end-to-end metric it moves
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", CELLS)) <= set(moved.get("workloads", CELLS))
        if m["name"].endswith("_roofline") or m["name"].endswith("_roofline_pct"):
            assert m["unit"] == "%"
    for cell in CELLS:
        reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)]
        assert {"setup_s"} < {m["name"] for m in reported}
        assert any(cell in m.get("workloads", CELLS) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.load_cell(cell, BENCH)
    assert callable(c.rule_module().build) and callable(c.rule_module().flops)
    assert callable(c.reference_module().score)
    family, reference = c.family_module(), c.family_reference()
    assert all(callable(getattr(family, f)) for f in ("build", "theta", "flops"))
    assert all(callable(getattr(reference, f)) for f in ("episode", "posterior", "fit_gap"))
    assert callable(c.objective())
    assert set(c.limits) == {"pool_err", "point_err", "fit_gap"}
    assert all(0 < v < math.inf for v in c.limits.values())
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_rehearsal_files(config):
    """Every configuration says how it shrinks for a CPU rehearsal, in a file of its own."""
    from benchmarks.harness import rehearse

    base = spec.load_json(spec.ROOT / config["file"])
    shrink = rehearse.overrides(config["name"])
    assert shrink and set(shrink) <= set(base)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = spec.ROOT / config["file"]
    assert path.is_relative_to(spec.BENCH_DIR)
    data = spec.load_json(path)
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] and "assumed" in data
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    assert data["dtype"] == "float32" and data["tf32"] is False


def build_gpr_program_defaults():
    """The program's values of the ``build_gpr`` family's ``DEFAULTS``."""
    import inspect

    from trieste_tpu_torch.models.gp import builders, priors
    from trieste_tpu_torch.models.gp.gpr import GaussianProcessRegression
    from trieste_tpu_torch.utils.misc import jitter_for

    init = inspect.signature(GaussianProcessRegression.__init__).parameters
    return {
        "signal_noise_ratio": builders.SIGNAL_NOISE_RATIO_LIKELIHOOD,
        "lengthscale_factor": builders.KERNEL_LENGTHSCALE,
        "prior_scale": priors.KERNEL_PRIOR_SCALE,
        "squeeze_log_range": priors.SQUEEZE_LOG_RANGE,
        "cholesky_jitter": jitter_for(torch.float32),
        "num_kernel_samples": init["num_kernel_samples"].default,
        "max_optimize_iters": init["max_optimize_iters"].default,
        "num_rff_features": init["num_rff_features"].default,
    }


PROGRAM_DEFAULTS = {"build_gpr": build_gpr_program_defaults}


@pytest.mark.parametrize("builder", sorted(PROGRAM_DEFAULTS))
def test_family_files_state_the_builders_defaults(builder):
    """The family's file states the builder's defaults it relies on, and they are the
    program's."""
    stated = spec.load_module("models", builder).DEFAULTS
    program = PROGRAM_DEFAULTS[builder]()
    assert set(stated) == set(program)
    for key, value in stated.items():
        assert value == pytest.approx(program[key], rel=1e-15), key


@pytest.mark.parametrize(
    "config", [c for c in BENCH["configs"]
               if spec.load_json(spec.ROOT / c["file"])["model"]["builder"] == "build_gpr"],
    ids=lambda c: c["name"])
def test_model_constants_are_build_gprs_defaults(config):
    """The reference's constants in a ``build_gpr`` configuration are the program's
    defaults, as the family's file states them."""
    defaults = spec.load_module("models", "build_gpr").DEFAULTS
    m = spec.load_json(spec.ROOT / config["file"])["model"]
    for key in ("signal_noise_ratio", "lengthscale_factor", "prior_scale", "cholesky_jitter",
                "num_kernel_samples", "max_optimize_iters"):
        assert m[key] == defaults[key], key
    assert m["squeeze_log_range"] == pytest.approx(defaults["squeeze_log_range"], rel=1e-15)
    assert m.get("num_rff_features", defaults["num_rff_features"]) == defaults["num_rff_features"]
    noise = m.get("likelihood_variance")
    assert noise is None or (isinstance(noise, float) and noise > 0)


@pytest.mark.parametrize("name,problem", [("scaled_branin", "ScaledBranin")])
def test_frozen_objectives_equal_the_programs(name, problem):
    from trieste_tpu_torch import objectives

    ours = spec.load_module("objectives", name).objective
    theirs = getattr(objectives, problem)
    x = torch.rand(257, theirs.search_space.dimension, dtype=torch.float64)
    torch.testing.assert_close(ours(x), theirs.objective(x), rtol=1e-13, atol=1e-13)

"""Model families and rules found by name: the exact GP's cell reproducing, bit for bit,
what it read before the family files existed; the vectorized rule ``pcts`` rehearsed on
the quickstart's configuration, correct, and caught with each fault planted in its timed
path; a family and a vectorized rule supplied as new files alone."""
import dataclasses
import json
import shutil
import types
from pathlib import Path

import pytest
import torch

from benchmarks.harness import check, loop, rehearse, spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
LOCK = spec.load_json(spec.BENCH_DIR / "tests" / "ei_rehearsal_lock.json")
CONFIG = "scaledbranin_gpr_quickstart"
PCTS = f"{CONFIG}.pcts4"
EI_LIMITS = spec.load_json(spec.BENCH_DIR / "limits" / f"{CONFIG}.ei.json")


def with_cell(bench, name, config, traffic):
    workload = {"name": name, "config": config, "traffic": traffic, "chips": 1,
                "why": "a cell built by a test"}
    return dict(bench, workloads=bench["workloads"] + [workload])


def pcts_cell(overrides=None):
    """``pcts4`` on the quickstart's configuration, shrunk as its rehearsal says unless
    ``overrides`` are given, under the limits of the configuration's EI cell: no cell of
    ``BENCHMARK.json`` takes the mix yet, so it has no file of limits of its own."""
    bench = with_cell(BENCH, PCTS, CONFIG, "pcts4")
    ei = spec.load_cell(f"{CONFIG}.ei", bench,
                        rehearse.overrides(CONFIG) if overrides is None else overrides)
    return dataclasses.replace(
        ei, name=PCTS, traffic=spec.load_json(spec.BENCH_DIR / "traffic" / "pcts4.json"))


@pytest.mark.parametrize("seed", sorted(LOCK["seeds"]))
def test_ei_rehearsal_reproduces_its_readings_bit_for_bit(seed):
    """The asked points, the three numbers and each step's FLOPs of the EI cell's
    rehearsal, as the harness read them before the model family moved into
    ``models/build_gpr.py`` and ``reference/build_gpr.py``."""
    want = LOCK["seeds"][seed]
    _, run, verdict = rehearse.rehearse(LOCK["cell"], seed=int(seed), steps=LOCK["steps"])
    flops = spec.load_module("metrics", "flops")
    assert [s.asked.tolist() for s in run.all_steps] == want["asked"]
    assert verdict.numbers == want["numbers"]
    assert [flops.step_flops(s, run.cell) for s in run.all_steps] == want["step_flops"]


@pytest.fixture(scope="module")
def pcts_run():
    return rehearse.rehearse_cell(pcts_cell(), seed=2**33 + 17, steps=4)


def test_pcts_rehearsal_is_correct(pcts_run):
    line, run, verdict = pcts_run
    assert line["correct"], (verdict.numbers, verdict.failed_steps)
    for step in run.all_steps:
        assert step.asked.shape == (4, 2) and step.slices == 4
        assert step.record is None or step.record.pool[0].shape[1:] == (4, 2)
    kept = [s for s in run.all_steps if s.record is not None]
    assert kept and all(s.record.draws is not None for s in kept)
    assert 0 < verdict.numbers["pool_err"] < verdict.limits["pool_err"]


@pytest.mark.parametrize("rule", ["ei", "pcts4"])
def test_step_flops_by_hand(rule):
    """One step of the quickstart's configuration at its full size (D = 2, 25 points at
    the ask, a pool of 5000 rows, 20 runs, 1000 features), counted by hand: the family's
    fit of ten restarts and its cache on the told data, and the rule's pool and runs."""
    flops = spec.load_module("metrics", "flops")
    if rule == "ei":
        cell = spec.load_cell(f"{CONFIG}.ei", BENCH)
        step = loop.Step(0, 25, None, pool_rows=5000, slices=1, final_rows=20)
        n = 26  # told: 25 + 1
        pool = 2 * 5000 * 25 * 2 + 2 * 5000 * 25 + 5000 * 25 * 26 + 2 * 5000 * 25  # one pass
        runs = 20 * 3 * (2 * 25 * 2 + 2 * 25 + 25 * 25 + 2 * 25)  # a solve a point
    else:
        cell = pcts_cell(overrides={})
        step = loop.Step(0, 25, None, pool_rows=5000, slices=4, final_rows=20)
        n = 29  # told: 25 + 4
        m, V = 1000, 4
        draw = (2 * 25 * m * 2 + 2 * 25 * 25 * m + 25**3 / 3  # features, Gram, Cholesky
                + 2 * V * 25 * m + 2 * V * 25 * 25 + 2 * V * 25 * m)  # residuals, solves, update
        evaluate = V * (2 * m * 2 + 2 * m)  # one point of every slice
        pool = draw + 5000 * evaluate  # the draw counted once an ask
        runs = 20 * 3 * evaluate
    fit = 10 * (2 * n * n * 2 + n**3 / 3 + 2 * n * n + 2 * n**3 / 3 + 2 * n * n * 3)
    cache = 2 * n * n * 2 + 2 * n**3 / 3 + 2 * n * n
    assert flops.step_flops(step, cell) == pytest.approx(pool + fit + cache + runs, rel=1e-15)


def test_posterior_counts_by_hand():
    """The family's counts under its reference posterior's names, at sizes where each
    branch is taken: the trajectory's draw on more points than features, and the joint."""
    family = spec.load_module("models", "build_gpr")
    cell = pcts_cell(overrides={"model": dict(pcts_cell({}).config["model"],
                                              num_rff_features=8)})
    step = loop.Step(0, 25, None)
    m, V = 8, 4  # n = 25 > m: the normal equations
    assert family.trajectory_draw_flops(step, cell, V) == pytest.approx(
        2 * 25 * m * 2 + 2 * 25 * m * m + m**3 / 3 + 2 * 25 * m + 2 * m * m + V * m * m,
        rel=1e-15)
    assert family.trajectory_flops(step, cell, 7, V) == 7 * V * (2 * m * 2 + 2 * m)
    assert family.marginal_flops(step, cell, 3) == 3 * (2 * 25 * 2 + 2 * 25 + 25 * 25 + 2 * 25)
    B, S = 3, 2000
    assert family.joint_flops(step, cell, B, S) == pytest.approx(
        2 * B * 25 * 2 + 2 * B * 25 + B * 25 * 25 + 2 * B * B * 25 + 2 * B * B * 2 + B**3 / 3
        + 2 * B * B * S, rel=1e-15)


def test_pcts_control_fails_the_limits(pcts_run):
    """The reference in TF32, trajectories included, in the program's place."""
    _, run, verdict = pcts_run
    control = check.control_numbers(run)
    assert any(control[k] > verdict.limits[k] for k in check.NUMBERS), control


def test_fault_slice_point_moved_to_another_slices_best(monkeypatch):
    """Slice 1's asked point replaced by slice 0's: it is none of slice 1's points."""
    from trieste_tpu_torch.ask_tell_optimization import AskTellOptimizerABC

    original = AskTellOptimizerABC.ask

    def moved(self):
        points = original(self)
        return torch.cat([points[:1], points[:1], points[2:]])

    monkeypatch.setattr(AskTellOptimizerABC, "ask", moved)
    line, _, verdict = rehearse.rehearse_cell(pcts_cell(), seed=5, steps=2)
    assert not line["correct"] and line["failed"] == line["attempted"]
    assert all("slice 1" in why for _, why in verdict.failed_steps), verdict.failed_steps


def test_fault_trajectory_update_weights_scaled(monkeypatch):
    """The pathwise update of every trajectory's weights made 1% larger where the
    trajectories are drawn."""
    from trieste_tpu_torch.models.gp import sampler

    original = sampler.rff_trajectory_from_draws

    def scaled(params, cache, observations, features, eps, eps_n=None):
        t = original(params, cache, observations, features, eps, eps_n)
        return dataclasses.replace(t, theta=eps + 1.01 * (t.theta - eps))

    monkeypatch.setattr(sampler, "rff_trajectory_from_draws", scaled)
    line, _, verdict = rehearse.rehearse_cell(pcts_cell(), seed=6, steps=3)
    assert not line["correct"], verdict.numbers
    assert verdict.numbers["pool_err"] > verdict.limits["pool_err"]


def test_fault_family_posterior_inflates_the_variance(monkeypatch):
    """A family's reference whose posterior inflates the variance, supplied through the
    family lookup: the EI cell's scores part from the program's."""
    real = spec.load_module("reference", "build_gpr")

    def posterior(*args):
        post = real.posterior(*args)
        marginal = post.marginal
        post.marginal = lambda x: (lambda m, v: (m, 1.5 * v))(*marginal(x))
        return post

    fake = types.SimpleNamespace(episode=real.episode, fit_gap=real.fit_gap,
                                 posterior=posterior)
    monkeypatch.setattr(spec.Cell, "family_reference", lambda self: fake)
    line, _, verdict = rehearse.rehearse(f"{CONFIG}.ei", seed=7, steps=3)
    assert not line["correct"], verdict.numbers
    assert verdict.numbers["pool_err"] > verdict.limits["pool_err"]


def _step(pool, final, asked):
    return loop.Step(0, 5, None, asked=asked, asks=1,
                     record=loop.AskRecord(pool=pool, final=final))


def test_asked_failure_judges_each_slice_alone():
    """Each asked point against its own slice's rows and scores, not the batch's."""
    lo, hi = torch.zeros(2, dtype=torch.float64), torch.ones(2, dtype=torch.float64)
    rows = torch.tensor([[[0.1, 0.1], [0.2, 0.2]], [[0.3, 0.3], [0.4, 0.4]]])  # [N=2, V=2, D]
    scores = torch.tensor([[1.0, 5.0], [2.0, 3.0]])  # slice 0's best row 1, slice 1's row 0
    final = (torch.tensor([[[0.5, 0.5], [0.6, 0.6]]]), torch.tensor([[1.5, 4.0]]))
    best = torch.tensor([[0.3, 0.3], [0.2, 0.2]])
    assert check.asked_failure(_step((rows, scores), final, best), lo, hi) is None
    # slice 1 asks slice 0's best point: none of slice 1's rows
    why = check.asked_failure(_step((rows, scores), final, best[[0, 0]]), lo, hi)
    assert why and "slice 1" in why and "none" in why
    # slice 1 asks its own run's end point, which scored below its best row
    why = check.asked_failure(_step((rows, scores), final, torch.tensor([[0.3, 0.3], [0.6, 0.6]])),
                              lo, hi)
    assert why and "slice 1" in why and "below" in why
    # one function of the whole batch: the batch is one row, as before
    flat = (rows.reshape(2, 1, 4), scores[:, :1])
    assert check.asked_failure(_step(flat, None, torch.tensor([[0.3, 0.3], [0.4, 0.4]])),
                               lo, hi) is None


NEW_FAMILY = '''"""A family supplied as a new file: the exact GP under another name, counting its
builds."""
from benchmarks.harness.spec import load_module

_gpr = load_module("models", "build_gpr")
BUILT = []
DEFAULTS, theta, flops = _gpr.DEFAULTS, _gpr.theta, _gpr.flops
marginal_flops, joint_flops = _gpr.marginal_flops, _gpr.joint_flops
trajectory_draw_flops, trajectory_flops = _gpr.trajectory_draw_flops, _gpr.trajectory_flops
trajectory_draws = _gpr.trajectory_draws


def build(cell, data, space, theta=None):
    BUILT.append(len(data))
    return _gpr.build(cell, data, space, theta)
'''
NEW_FAMILY_REFERENCE = '''"""The plain side of the family supplied as a new file."""
from benchmarks.harness.spec import load_module

_gpr = load_module("reference", "build_gpr")
episode, posterior, fit_gap = _gpr.episode, _gpr.posterior, _gpr.fit_gap
'''
NEW_RULE = '''"""A vectorized rule supplied as a new file: one Thompson-sampling trajectory a slice."""


def build(traffic, optimizer, generator):
    from trieste_tpu_torch.acquisition import EfficientGlobalOptimization
    from trieste_tpu_torch.acquisition.function.continuous_thompson_sampling import (
        ParallelContinuousThompsonSampling,
    )

    return EfficientGlobalOptimization(ParallelContinuousThompsonSampling(generator=generator),
                                       optimizer=optimizer,
                                       num_query_points=traffic["num_query_points"])


def draws(family, model, state, traffic):
    return family.trajectory_draws(model, state, traffic["num_query_points"])


def flops(step, cell, family):
    return (family.trajectory_draw_flops(step, cell, step.slices)
            + family.trajectory_flops(step, cell, step.pool_rows, step.slices),
            step.final_rows * 3.0 * family.trajectory_flops(step, cell, 1, step.slices))
'''
NEW_RULE_REFERENCE = '''"""The plain side of the rule supplied as a new file."""


def score(post, x, traffic, draws):
    return -post.trajectory(draws)(x)
'''


def test_a_new_family_and_a_vectorized_rule_need_only_new_files(tmp_path, monkeypatch):
    """A copy of the benchmark with new files alone, and no file that is there edited,
    runs a cell of a new family under a new vectorized rule, and it comes out correct."""
    root = tmp_path
    bench_dir = root / "benchmarks"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    config = dict(spec.load_json(spec.ROOT / BENCH["configs"][0]["file"]), name="alias")
    config["model"] = dict(config["model"], builder="gpr_alias")
    new = {
        "models/gpr_alias.py": NEW_FAMILY,
        "reference/gpr_alias.py": NEW_FAMILY_REFERENCE,
        "rules/vts.py": NEW_RULE,
        "reference/vts.py": NEW_RULE_REFERENCE,
        "traffic/vts3.json": json.dumps({"rule": "vts", "num_query_points": 3}),
        "configs/alias.json": json.dumps(config),
        "rehearsal/alias.json": json.dumps({"why": "a test's", "overrides": {"episode_steps": 3}}),
        "limits/alias.vts3.json": json.dumps(EI_LIMITS),
    }
    for path, text in new.items():
        assert not (bench_dir / path).exists()
        (bench_dir / path).write_text(text)
    copied = {p.relative_to(bench_dir) for p in bench_dir.rglob("*") if p.is_file()}
    for path in copied - {Path(p) for p in new}:
        assert (bench_dir / path).read_bytes() == (spec.BENCH_DIR / path).read_bytes(), path
    bench = dict(BENCH, configs=BENCH["configs"] + [
        dict(BENCH["configs"][0], name="alias", file="benchmarks/configs/alias.json")])
    bench = with_cell(bench, "alias.vts3", "alias", "vts3")
    monkeypatch.setattr(spec, "BENCH_DIR", bench_dir)
    monkeypatch.setattr(spec, "ROOT", root)
    cell = spec.load_cell("alias.vts3", bench, rehearse.overrides("alias"))
    line, run, verdict = rehearse.rehearse_cell(cell, seed=9, steps=3)
    assert line["correct"], (verdict.numbers, verdict.failed_steps)
    assert all(s.asked.shape == (3, 2) for s in run.all_steps)
    assert spec.load_module("models", "gpr_alias").BUILT  # the harness built the new family

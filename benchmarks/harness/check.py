"""Whether what the timed path produced is right, judged by the plain reference in
``benchmarks/reference/`` once the window has closed and the program's state is freed.

For every step of the run, the reference rebuilds that step's data from the episode's
design and told points (the benchmark made both), takes what the family judges (the
program's hyperparameters) as given, and works out again in float64 everything the
program derived from them, by the family's reference (``reference/<builder>.py``): what
an episode fixes (the noise and the priors from its initial observations), the
posterior, and from it, by the rule's reference (``reference/<rule>.py``), the
acquisition; a rule whose function rests on random draws gets the raw draws of the ask.
Three numbers, each the worst over the steps whose records the run kept
(``loop.KEPT_RECORDS``: a sample drawn from the seed, and the last step) or over a sample
of its fits:

- ``pool_err``: the seed pool's scores as the timed path computed them (through the fused
  kernel where the program takes it), against the reference's scores of the same points,
  as the largest absolute gap over the pool and every slice, in units of the posterior's
  ``scale`` (the fitted signal's standard deviation);
- ``point_err``: the same for the scores of the acquisition optimizer's last runs, among
  them the asked points;
- ``fit_gap``: the family's own number for its fit (for the exact GP, how far the MAP
  objective at the program's hyperparameters lies above the optimum a float64 fit reaches
  from them, per training point), for a sample of :data:`FIT_SAMPLE` of the run's fits
  (the initial fits and each ``tell()``) drawn from the seed, the last ``tell()`` always
  among them.

A step fails outright (``failed``) when an asked point is not finite, lies outside the
box, is not among the points the optimizer scored in its slice, or is not the best of
them by the program's own scores: the answer is then not the optimizer's, and no number
can say how far off it is.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

import numpy as np

from benchmarks.reference.precision import FP64, TF32, Precision

from .loop import subseed

NUMBERS = ("pool_err", "point_err", "fit_gap")
FIT_SAMPLE = 6


@dataclass
class Verdict:
    numbers: Dict[str, float]
    limits: Dict[str, float]
    failed_steps: List[Tuple[int, str]] = field(default_factory=list)
    checked_steps: int = 0

    @property
    def correct(self) -> bool:
        return not self.failed_steps and all(
            math.isfinite(self.numbers[k]) and self.numbers[k] <= self.limits[k]
            for k in NUMBERS
        )

    def lines(self) -> List[str]:
        return [f"{k} {self.numbers[k]!r} limit {self.limits[k]!r}" for k in NUMBERS]

    def as_json(self) -> Dict[str, Dict[str, float]]:
        return {k: {"value": self.numbers[k], "limit": self.limits[k]} for k in NUMBERS}


def _gap(program: torch.Tensor, reference: torch.Tensor, scale: float) -> float:
    """Largest ``|program − reference|`` over finite references, in units of ``scale``; a
    non-finite program value where the reference is finite counts as infinite."""
    p = program.reshape(-1).double()
    r = reference.reshape(-1).double()
    keep = torch.isfinite(r)
    d = torch.where(torch.isfinite(p), (p - r).abs(), torch.inf)[keep]
    return float(d.max()) / scale if d.numel() else 0.0


class Judge:
    """The reference's view of a run: one per cell and run, reused across steps."""

    def __init__(self, run):
        cell = run.cell
        self.config = cell.config
        self.family = cell.family_reference()
        self.reference = cell.reference_module()
        self.traffic = cell.traffic
        self.lower = torch.tensor(self.config["lower"], dtype=torch.float64, device=run.device)
        self.upper = torch.tensor(self.config["upper"], dtype=torch.float64, device=run.device)
        self.contexts: Dict[int, object] = {}

    def context(self, episode):
        """What the family fixes for an episode from its initial observations."""
        key = id(episode)
        if key not in self.contexts:
            Y0 = episode.Y[0][: episode.num_initial]
            self.contexts[key] = self.family.episode(self.config, Y0, self.lower, self.upper)
        return self.contexts[key]

    def fit_gap(self, fit, prec: Optional[Precision] = None) -> float:
        """``fit_gap`` of a fit ``(episode, n, theta)``; with ``prec``, of where a fit in
        that precision ends from ``theta`` instead."""
        episode, n, theta = fit
        context = self.context(episode)
        X, Y = (t.double() for t in episode.data(n))
        return self.family.fit_gap(self.config, context, X, Y, theta, prec)

    def posterior(self, episode, n: int, theta, prec: Precision):
        context = self.context(episode)
        X, Y = episode.data(n)
        return self.family.posterior(self.config, context, X.double(), Y.double(), theta, prec)

    def scores(self, post, x: torch.Tensor, draws) -> torch.Tensor:
        return self.reference.score(post, x, self.traffic, draws)


def _draws(record):
    return None if record.draws is None else record.draws()


def asked_failure(step, lower: torch.Tensor, upper: torch.Tensor) -> Optional[str]:
    """Why a step's asked points are not the optimizer's answer, or ``None``. Where the
    step's record was kept, the asked point of each slice ``v`` (the ``v``-th point; a
    function of the whole batch has one slice) must be among the points the optimizer
    scored in slice ``v`` and the best of them by the program's own scores."""
    x = step.asked
    if step.asks != 1:
        return f"{step.asks} optimizer calls in one ask"
    if x is None or not bool(torch.isfinite(x).all()):
        return "asked points not finite"
    xd = x.double()
    if not bool(((xd >= lower) & (xd <= upper)).all()):
        return "asked points outside the box"
    if step.record is None:
        return None
    if step.record.pool is None:
        return "no seed pool was scored"
    V = step.record.pool[0].shape[1]
    asked = x.reshape(V, -1)
    slices = torch.arange(V, device=x.device)
    best = torch.full((V,), -math.inf, dtype=torch.float64, device=x.device)
    found = best.clone()
    hit = torch.zeros(V, dtype=torch.bool, device=x.device)
    for rows, values in filter(None, (step.record.pool, step.record.final)):
        rows = rows.reshape(rows.shape[0], V, -1)
        v = torch.nan_to_num(values.reshape(rows.shape[0], V).double(), nan=-math.inf)
        best = torch.maximum(best, v.max(0).values)
        equal = (rows == asked).all(-1)  # [N, V]
        first = v[equal.to(torch.int8).argmax(0), slices]  # each slice's first equal row
        here = equal.any(0)
        found = torch.where(here, torch.maximum(found, first), found)
        hit |= here
    for s, (h, f, b) in enumerate(zip(hit.tolist(), found.tolist(), best.tolist())):
        where = "" if V == 1 else f" of slice {s}"
        if not h:
            return f"asked point{where} is none of the points scored there"
        if f < b:
            return f"asked point{where} scores {f!r}, below the best scored {b!r}"
    return None


def fits(run) -> list:
    """The sample of the run's fits that the check re-fits: ``(episode, n,
    hyperparameters)`` of the fit before each ask and of the last ``tell()``."""
    steps = run.all_steps
    every = [(run.episodes[s.episode], s.n, s.theta) for s in steps]
    if not steps:
        return every
    last = steps[-1]
    every.append((run.episodes[last.episode], last.n + run.cell.num_query_points,
                  last.theta_after))
    rng = np.random.default_rng(subseed(run.seed, 5))
    rest = rng.choice(len(every) - 1, size=min(FIT_SAMPLE - 1, len(every) - 1), replace=False)
    return [every[i] for i in sorted(rest)] + [every[-1]]


def judge(run, limits: Dict[str, float]) -> Verdict:
    """The three numbers over every step of ``run`` and the steps that failed outright."""
    j = Judge(run)
    numbers = {k: 0.0 for k in NUMBERS}
    failed: List[Tuple[int, str]] = []
    steps = run.all_steps
    for i, step in enumerate(steps):
        episode = run.episodes[step.episode]
        why = asked_failure(step, j.lower, j.upper)
        if why:
            failed.append((i, why))
            continue
        if step.record is None:
            continue
        post = j.posterior(episode, step.n, step.theta, FP64)
        draws = _draws(step.record)
        px, pv = step.record.pool
        numbers["pool_err"] = max(numbers["pool_err"],
                                  _gap(pv, j.scores(post, px, draws), post.scale))
        if step.record.final is not None:
            fx, fv = step.record.final
            numbers["point_err"] = max(numbers["point_err"],
                                       _gap(fv, j.scores(post, fx, draws), post.scale))
    for fit in fits(run):
        numbers["fit_gap"] = max(numbers["fit_gap"], j.fit_gap(fit))
    checked = sum(s.record is not None for s in steps)
    return Verdict(numbers, {k: float(limits[k]) for k in NUMBERS}, failed, checked)


def control_numbers(run, prec: Precision = TF32) -> Dict[str, float]:
    """The three numbers with the reference in ``prec`` put in the program's place, on the
    same steps, data and points: its scores of the pool and of the runs' end points at
    the program's hyperparameters, and ``fit_gap`` of where its own fit in ``prec`` ends
    from the program's hyperparameters. The benchmark's runs never compute these; the control tool and
    its test do."""
    j = Judge(run)
    numbers = {k: 0.0 for k in NUMBERS}
    for step in run.all_steps:
        if step.record is None or asked_failure(step, j.lower, j.upper):
            continue
        episode = run.episodes[step.episode]
        exact = j.posterior(episode, step.n, step.theta, FP64)
        low = j.posterior(episode, step.n, step.theta, prec)
        draws = _draws(step.record)
        for key, pair in (("pool_err", step.record.pool), ("point_err", step.record.final)):
            if pair is not None:
                x = pair[0]
                numbers[key] = max(numbers[key], _gap(j.scores(low, x, draws),
                                                      j.scores(exact, x, draws), exact.scale))
    for fit in fits(run):
        try:
            numbers["fit_gap"] = max(numbers["fit_gap"], j.fit_gap(fit, prec))
        except torch.linalg.LinAlgError:  # no Cholesky factor in this precision
            numbers["fit_gap"] = math.inf
    return numbers

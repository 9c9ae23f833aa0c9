"""Whether what the timed path produced is right, judged by the plain reference in
``benchmarks/reference/`` once the window has closed and the program's state is freed.

For every step of the run, the reference rebuilds that step's data from the episode's
design and told points (the benchmark made both), takes the program's hyperparameters as
the thing to judge, and works out again in float64 everything the program derived from
them: the fixed noise (the configuration's, or the default from the initial observations)
and the priors from the episode's initial observations, the
Cholesky factor, the posterior, the incumbent and the acquisition. Three numbers, each the
worst over the steps whose records the run kept (``loop.KEPT_RECORDS``: a sample drawn from
the seed, and the last step) or over a sample of its fits:

- ``pool_err``: the seed pool's scores as the timed path computed them (through the fused
  kernel where the program takes it), against the reference's scores of the same points,
  as the largest absolute gap over the pool in units of the fitted signal's standard
  deviation ``sqrt(s)``;
- ``point_err``: the same for the scores of the acquisition optimizer's last runs, among
  them the asked point;
- ``fit_gap``: how far the MAP objective (negative log marginal likelihood and log
  priors, float64) at the program's fitted hyperparameters lies above the optimum that a
  float64 fit reaches from them, per training point; for a sample of :data:`FIT_SAMPLE`
  of the run's fits (the initial fits and each ``tell()``) drawn from the seed, the last
  ``tell()`` always among them.

A step fails outright (``failed``) when its asked points are not finite, lie outside the
box, are not among the points the optimizer scored, or are not the best of them by the
program's own scores: the answer is then not the optimizer's, and no number can say how
far off it is.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

import numpy as np

from benchmarks.reference import gp as R

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


def _hyper(theta, noise: float, jitter: float) -> R.Hyper:
    """The program's hyperparameters as the reference's, in float64."""
    k = theta.kernel
    return R.Hyper(k.variance.double(), k.lengthscales.double().reshape(-1),
                   theta.mean_constant.double(), noise, jitter)


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
        c, m = cell.config, cell.config["model"]
        self.reference = cell.reference_module()
        self.traffic = cell.traffic
        self.lower = torch.tensor(c["lower"], dtype=torch.float64, device=run.device)
        self.upper = torch.tensor(c["upper"], dtype=torch.float64, device=run.device)
        self.m = m
        self.priors_cache: Dict[int, Tuple[float, R.Priors]] = {}

    def noise_and_priors(self, episode) -> Tuple[float, R.Priors]:
        key = id(episode)
        if key not in self.priors_cache:
            Y0 = episode.Y[0][: episode.num_initial]
            noise, priors = R.default_noise_and_priors(
                Y0, self.upper - self.lower, self.lower.shape[0], self.m["lengthscale_factor"],
                self.m["signal_noise_ratio"], self.m["prior_scale"], self.m["squeeze_log_range"],
                self.m.get("likelihood_variance"))
            priors = R.Priors(priors.var_loc, priors.ls_loc.to(self.lower.device),
                              priors.scale, priors.squeeze)
            self.priors_cache[key] = (noise, priors)
        return self.priors_cache[key]

    def fit_gap(self, fit, prec: Optional[R.Precision] = None) -> float:
        """``fit_gap`` of a fit ``(episode, n, hyperparameters)``; with ``prec``, of where
        a fit in that precision ends from those hyperparameters instead."""
        episode, n, theta = fit
        noise, priors = self.noise_and_priors(episode)
        X, Y = (t.double() for t in episode.data(n))
        h = _hyper(theta, noise, self.m["cholesky_jitter"])
        u = R.pack(h)
        if prec is not None:
            u = R.fit_local(u, X, Y, h, priors, prec)
            if not bool(torch.isfinite(u).all()):
                return math.inf
        return R.fit_gap(u, X, Y, h, priors)

    def posterior(self, episode, n: int, theta, prec: R.Precision) -> R.Posterior:
        noise, _ = self.noise_and_priors(episode)
        X, Y = episode.data(n)
        return R.Posterior(X.double(), Y.double(),
                           _hyper(theta, noise, self.m["cholesky_jitter"]), prec)

    def scores(self, post: R.Posterior, x: torch.Tensor) -> torch.Tensor:
        return self.reference.score(post, x, self.traffic)


def asked_failure(step, lower: torch.Tensor, upper: torch.Tensor) -> Optional[str]:
    """Why a step's asked points are not the optimizer's answer, or ``None``. Where the
    step's record was kept, the points must be among those the optimizer scored and the
    best of them by the program's own scores."""
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
    flat = x.reshape(-1)
    best, found = -math.inf, None
    for rows, values in filter(None, (step.record.pool, step.record.final)):
        rows = rows.reshape(rows.shape[0], -1)
        v = torch.nan_to_num(values.reshape(-1).double(), nan=-math.inf)
        best = max(best, float(v.max()))
        hit = (rows == flat).all(-1).nonzero()
        if hit.numel():
            found = max(found if found is not None else -math.inf, float(v[hit[0, 0]]))
    if found is None:
        return "asked points are none of the scored points"
    if found < best:
        return f"asked points score {found!r}, below the best scored {best!r}"
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
        post = j.posterior(episode, step.n, step.theta, R.FP64)
        scale = math.sqrt(float(post.h.variance))
        px, pv = step.record.pool
        numbers["pool_err"] = max(numbers["pool_err"], _gap(pv, j.scores(post, px), scale))
        if step.record.final is not None:
            fx, fv = step.record.final
            numbers["point_err"] = max(numbers["point_err"], _gap(fv, j.scores(post, fx), scale))
    for fit in fits(run):
        numbers["fit_gap"] = max(numbers["fit_gap"], j.fit_gap(fit))
    checked = sum(s.record is not None for s in steps)
    return Verdict(numbers, {k: float(limits[k]) for k in NUMBERS}, failed, checked)


def control_numbers(run, prec: R.Precision = R.TF32) -> Dict[str, float]:
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
        exact = j.posterior(episode, step.n, step.theta, R.FP64)
        low = j.posterior(episode, step.n, step.theta, prec)
        scale = math.sqrt(float(exact.h.variance))
        for key, pair in (("pool_err", step.record.pool), ("point_err", step.record.final)):
            if pair is not None:
                x = pair[0]
                numbers[key] = max(numbers[key], _gap(j.scores(low, x), j.scores(exact, x), scale))
    for fit in fits(run):
        try:
            numbers["fit_gap"] = max(numbers["fit_gap"], j.fit_gap(fit, prec))
        except torch.linalg.LinAlgError:  # no Cholesky factor in this precision
            numbers["fit_gap"] = math.inf
    return numbers

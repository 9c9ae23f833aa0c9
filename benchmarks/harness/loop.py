"""The closed loop the benchmark times: one client drives ``AskTellOptimizer`` of
``trieste_tpu_torch`` through ``ask()``, the objective and ``tell()``, each step waiting
for the one before it, in episodes the configuration bounds.

Every run does the same work in its own order. The designs are the same points in every
run, in an order the seed draws, and each step's acquisition draws its seed pool from a
generator seeded from the configuration's ``design_seed``, the episode and the step, so
that the seed does not change how much work the fits and the acquisitions do. The seed
draws the order of each design's points and the sample of steps and fits the check
compares. A configuration either keeps its design (``new_design_each_episode: false``):
set-up fits the model once, and every episode, the first included, starts from a model
with those fitted hyperparameters on that design; or draws a new design from
``design_seed`` and the episode's index for every episode (``true``), whose initial fit
then falls inside the window. An episode ends after ``episode_steps`` steps, or before a step that would take
the data past ``max_points``.

The model is the configuration's family (``models/<builder>.py``): it builds the model
and says what the check judges of it. The rule (``rules/<rule>.py``) optimizes one function
or a vector of V functions, one per slice of the batch; its random draws come from a
generator reseeded from ``design_seed``, the episode and the step before each ask.

Everything the check needs is kept by reference while the window runs (the program
replaces its tensors and never writes into them): what the family judges before each ask
and after each tell, the seed pool and its scores, the scores of the optimizer's last
runs, the asked points, and, for a rule that draws, the generator's state before the ask.
See :mod:`benchmarks.harness.check`.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .spec import Cell

PROFILED_STEPS = 2
"""Steps profiled after the traced run's window: the profiler's host cost stays out of
the spans."""

KEPT_RECORDS = 8
"""Steps whose seed pools and scores stay on the device for the check: a sample drawn
from the seed as the window runs (a reservoir), and the last step. Keeping every step's
would add to the peak memory with every step the window holds."""


def subseed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one purpose, drawn from the run's ``--seed`` and ``keys``."""
    state = np.random.SeedSequence([seed % 2**64, *keys]).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def generator(device: torch.device, seed: int, *keys: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *keys))


@dataclass
class AskRecord:
    """What one call of the acquisition optimizer scored: the seed pool ``[N, V, E]`` and
    its scores (``[N, V]``, or ``[N, 1]`` for one function), and the optimizer's last
    no-gradient call (its runs' end points ``[R, V, E]``) and their scores; for a rule
    that draws, ``draws()`` gives the raw draws of the ask (``rules/<rule>.py``'s
    ``draws``). Slice ``v`` of a vectorized function is the ``v``-th of the V points
    asked."""

    pool: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    final: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    draws: Optional[Callable[[], Dict[str, Any]]] = None


class Recorder:
    """Wraps an acquisition optimizer so that each call leaves an :class:`AskRecord`:
    the first call without gradients is the seed pool's score, the last one the score of
    the runs' end points. A vectorized function ``(f, V)`` is wrapped as one. Only
    references are kept; nothing is read to the host."""

    def __init__(self) -> None:
        self.calls = 0
        self.last: Optional[AskRecord] = None

    def wrap(self, optimizer: Callable) -> Callable:
        def optimize(space, f, generator=None):
            record = AskRecord()
            fn, V = f if isinstance(f, tuple) else (f, None)

            def scored(x: torch.Tensor) -> torch.Tensor:
                value = fn(x)
                if not torch.is_grad_enabled():
                    if record.pool is None:
                        record.pool = (x, value)
                    else:
                        record.final = (x, value)
                return value

            points = optimizer(space, scored if V is None else (scored, V), generator=generator)
            self.calls += 1
            self.last = record
            return points

        return optimize


@dataclass
class Step:
    episode: int
    n: int  # points in the data at the ask
    theta: Any  # what the family judges at the ask (its ``theta(model)``)
    start: float = 0.0
    ask_s: float = 0.0
    tell_s: float = 0.0
    end: float = 0.0
    asked: Optional[torch.Tensor] = None
    theta_after: Any = None
    record: Optional[AskRecord] = None
    asks: int = 0  # optimizer calls in this ask
    pool_rows: int = 0  # rows of the seed pool the ask scored
    slices: int = 1  # functions of a vectorized acquisition, one per point asked
    final_rows: int = 0  # end points of the optimizer's runs
    launches: int = 0  # fused-kernel launches in this step

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Episode:
    X: List[torch.Tensor]
    Y: List[torch.Tensor]
    num_initial: int

    def data(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return torch.cat(self.X)[:n], torch.cat(self.Y)[:n]


@dataclass
class Run:
    """What a run measured, for the metric readers and the check."""

    cell: Cell
    device: torch.device
    trace: bool
    seed: int = 0
    setup_s: float = 0.0
    window_start: float = 0.0
    window_end: float = 0.0
    steps: List[Step] = field(default_factory=list)  # the window's
    profiled: List[Step] = field(default_factory=list)  # after the window, traced runs only
    episodes: List[Episode] = field(default_factory=list)
    peak_bytes: int = 0
    profile: Any = None  # benchmarks.harness.trace.Profile
    counters: Dict[str, Any] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window_end - self.window_start

    def add(self, step: Step, sample: np.random.Generator, profiled: bool = False) -> None:
        """Append a step; the record of the step before it joins the reservoir of
        :data:`KEPT_RECORDS` − 1 records or is dropped."""
        steps = self.all_steps
        if steps:
            before = steps[-1]
            held = [s for s in steps[:-1] if s.record is not None]
            seen = len(steps) - 1  # records offered to the reservoir before this one
            if len(held) >= KEPT_RECORDS - 1:
                j = int(sample.integers(0, seen + 1))
                if j < len(held):
                    held[j].record = None
                else:
                    before.record = None
        (self.profiled if profiled else self.steps).append(step)

    @property
    def all_steps(self) -> List[Step]:
        return self.steps + self.profiled


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Campaign:
    """One client's Ask/Tell campaign over episodes."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, run: Run):
        from trieste_tpu_torch import AskTellOptimizer, Box, Dataset
        from trieste_tpu_torch.acquisition import generate_continuous_optimizer

        self._AskTellOptimizer, self._Dataset = AskTellOptimizer, Dataset
        self.family = cell.family_module()
        self.cell, self.seed, self.device, self.run = cell, seed, device, run
        c = cell.config
        self.space = Box(c["lower"], c["upper"], dtype=torch.float32, device=device)
        self.objective = cell.objective()
        self.q = cell.num_query_points
        self.recorder = Recorder()
        optimizer = self.recorder.wrap(
            generate_continuous_optimizer(num_initial_samples=cell.num_initial_samples)
        )
        self.ask_tell_generator = torch.Generator(device=device)  # reseeded before every ask
        self.rule_generator = torch.Generator(device=device)  # the rule's draws; reseeded too
        rule_module = cell.rule_module()
        self.rule = rule_module.build(cell.traffic, optimizer, self.rule_generator)
        self.draws = getattr(rule_module, "draws", None)
        self.at = None
        self.episode: Optional[Episode] = None
        self.episode_index = -1
        self.steps_in_episode = 0
        self.fitted = None  # (design, hyperparameters) of a kept design

    # -- data and models ------------------------------------------------------------

    def design(self, n: int, *keys: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``n`` points drawn uniformly in the box, and their observations. The points
        come from the configuration's ``design_seed`` and ``keys``, the same for every
        run; the run's seed puts them in its own order. The fits then face the same data
        in every run, and the seed does not change how much work they do."""
        c = self.cell.config
        lo = torch.tensor(c["lower"], dtype=torch.float32, device=self.device)
        hi = torch.tensor(c["upper"], dtype=torch.float32, device=self.device)
        g = generator(self.device, c["design_seed"], *keys)
        x = lo + (hi - lo) * torch.rand((n, lo.shape[0]), generator=g, device=self.device)
        order = torch.randperm(n, generator=generator(self.device, self.seed, 6, *keys),
                               device=self.device)
        x = x[order]
        return x, self.objective(x)

    def optimizer_on(self, x: torch.Tensor, y: torch.Tensor, theta=None):
        """An Ask/Tell optimizer on ``(x, y)`` with the family's model as the configuration
        states it: fitted on the spot, or given ``theta``, what the family judges."""
        data = self._Dataset.from_arrays(x, y)
        model = self.family.build(self.cell, data, self.space, theta)
        return self._AskTellOptimizer(self.space, data, model, self.rule,
                                      fit_model=theta is None, generator=self.ask_tell_generator)

    def new_episode(self) -> None:
        c = self.cell.config
        self.episode_index += 1
        if c["new_design_each_episode"]:
            x, y = self.design(c["num_initial_points"], 1, self.episode_index)
            self.at = self.optimizer_on(x, y)
        else:
            if self.fitted is None:
                x, y = self.design(c["num_initial_points"], 1, 0)
                at = self.optimizer_on(x, y)
                self.fitted = (x, y, self.family.theta(at.model))
            x, y, theta = self.fitted
            self.at = self.optimizer_on(x, y, theta=theta)
        self.episode = Episode([x], [y], x.shape[0])
        self.run.episodes.append(self.episode)
        self.steps_in_episode = 0

    def episode_over(self) -> bool:
        c = self.cell.config
        if self.at is None:
            return True
        if c.get("episode_steps") is not None and self.steps_in_episode >= c["episode_steps"]:
            return True
        limit = c.get("max_points")
        return limit is not None and len(self.at.dataset) + self.q > limit

    # -- one step -----------------------------------------------------------------

    def step(self, timed_spans: bool) -> Step:
        """``ask()``, the objective, ``tell()``, and a synchronise; with ``timed_spans`` a
        synchronise after ``ask()`` as well, for the spans of the traced run."""
        from trieste_tpu_torch.ops import fused_predict

        start = time.perf_counter()
        if self.episode_over():
            self.new_episode()
            if timed_spans:
                _sync(self.device)
        t_ask = time.perf_counter()
        launches = fused_predict.launches
        calls = self.recorder.calls
        at = self.at
        rec = Step(self.episode_index, len(at.dataset), self.family.theta(at.model), start=start)
        keys = (self.episode_index + 1, self.steps_in_episode)
        self.ask_tell_generator.manual_seed(subseed(self.cell.config["design_seed"], 3, *keys))
        self.rule_generator.manual_seed(subseed(self.cell.config["design_seed"], 4, *keys))
        draws = None if self.draws is None else self.draws(
            self.family, at.model, self.rule_generator.get_state(), self.cell.traffic)
        x = at.ask()
        if timed_spans:
            _sync(self.device)
        t_tell = time.perf_counter()
        y = self.objective(x)
        at.tell(self._Dataset.from_arrays(x, y))
        _sync(self.device)
        rec.end = time.perf_counter()
        rec.ask_s, rec.tell_s = t_tell - t_ask, rec.end - t_tell
        rec.asked, rec.theta_after = x, self.family.theta(at.model)
        rec.asks = self.recorder.calls - calls
        rec.record = self.recorder.last if rec.asks else None
        if rec.record is not None:
            rec.record.draws = draws
        if rec.record is not None and rec.record.pool is not None:
            rec.pool_rows, rec.slices = rec.record.pool[0].shape[:2]
        if rec.record is not None and rec.record.final is not None:
            rec.final_rows = rec.record.final[0].shape[0]
        rec.launches = fused_predict.launches - launches
        self.episode.X.append(x)
        self.episode.Y.append(y)
        self.steps_in_episode += 1
        return rec

    def warm_up(self) -> None:
        """One step before the window, on a design of the configuration's size drawn apart
        from the window's (a kept design warms up on itself), so that the program's
        kernels and library handles are loaded. Eager PyTorch builds nothing per shape: on
        the card the window's steps at later capacities read the same with this one step
        as with one at every capacity (``PERF.md``)."""
        c = self.cell.config
        if c["new_design_each_episode"]:
            x, y = self.design(c["num_initial_points"], 2, 0)
            self.at = self.optimizer_on(x, y)
            self.episode = Episode([x], [y], x.shape[0])
        else:
            self.new_episode()
        self.step(timed_spans=False)

    def release(self) -> None:
        """Drop the program's state: the models, the rule and the optimizer."""
        self.at = None
        self.rule = None
        self.fitted = None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             process_start: float, max_steps: Optional[int] = None,
             log: Callable[[str], None] = print) -> Run:
    """Set up, warm up, run the window and, traced, profile :data:`PROFILED_STEPS` more
    steps. ``max_steps`` ends the window after that many steps instead (the CPU
    rehearsals). The program's state is freed before this returns."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.init()  # the peak's counters need the context
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    from trieste_tpu_torch import profiling
    from trieste_tpu_torch.ops import fused_predict

    fused_predict.CPU_PLAIN = device.type == "cpu"  # the plain version serves CPU rehearsals
    run = Run(cell, device, trace, seed)
    campaign = Campaign(cell, seed, device, run)
    campaign.warm_up()
    run.episodes.clear()
    campaign.at = None
    campaign.episode_index = -1
    _sync(device)
    run.window_start = time.perf_counter()
    run.setup_s = run.window_start - process_start
    log(f"set-up {run.setup_s:.3f} s, one warm-up step; "
        f"compile cache {dict(profiling.compile_cache_sizes())}")
    sample = np.random.default_rng(subseed(seed, 7))
    while True:
        run.add(campaign.step(timed_spans=trace), sample)
        done = len(run.steps) >= max_steps if max_steps else (
            time.perf_counter() - run.window_start >= seconds)
        if done:
            break
    run.window_end = run.steps[-1].end
    if trace:
        from .trace import profile_steps

        run.profile = profile_steps(
            lambda: run.add(campaign.step(timed_spans=True), sample, profiled=True),
            PROFILED_STEPS, device)
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    run.counters = {
        "launches_per_step": [s.launches for s in run.all_steps],
        "compile_cache": dict(profiling.compile_cache_sizes()),
        "episodes": len(run.episodes),
    }
    campaign.release()
    del campaign
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run

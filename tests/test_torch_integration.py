"""The JAX package's integration envelope, held on the port.

``tests/integration/test_bayesian_optimization.py`` holds the JAX package to the
reference's central check: every rule solves SimpleQuadratic in at most 6 steps at
rtol 0.05 (``:44-141``). This file builds the same 18 rules from ``trieste_tpu_torch``
(its own copy of the table, which ``scripts/torch_run_envelopes.py`` also reads for the
slow ScaledBranin list) and holds each to that envelope: 5 initial points, an exact GP at
likelihood variance 1e-7, seed 0, float64 on the CPU, and ``stop_at_minimum`` as the early
stop.
"""
from __future__ import annotations

import math

import pytest
import torch

from trieste_tpu_torch import BayesianOptimizer
from trieste_tpu_torch.acquisition.function.continuous_thompson_sampling import (
    GreedyContinuousThompsonSampling,
    ParallelContinuousThompsonSampling,
)
from trieste_tpu_torch.acquisition.function.entropy import GIBBON, MinValueEntropySearch
from trieste_tpu_torch.acquisition.function.function import (
    AugmentedExpectedImprovement,
    BatchMonteCarloExpectedImprovement,
    MonteCarloExpectedImprovement,
    MultipleOptimismNegativeLowerConfidenceBound,
    NegativeLowerConfidenceBound,
)
from trieste_tpu_torch.acquisition.function.greedy_batch import Fantasizer, LocalPenalization
from trieste_tpu_torch.acquisition.optimizer import generate_continuous_optimizer
from trieste_tpu_torch.acquisition.rule import (
    AsynchronousOptimization,
    BatchHypervolumeSharpeRatioIndicator,
    DiscreteThompsonSampling,
    EfficientGlobalOptimization,
)
from trieste_tpu_torch.acquisition.trust_region import BatchTrustRegionBox, TREGOBox, TURBOBox
from trieste_tpu_torch.bayesian_optimizer import stop_at_minimum
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.objectives import SimpleQuadratic, mk_observer

torch.set_num_threads(1)

FAST_OPT = generate_continuous_optimizer(num_initial_samples=512, num_optimization_runs=8)
# the slow (ScaledBranin) runs use the reference's full optimizer budgets
FULL_OPT = generate_continuous_optimizer()
SIMPLE_QUADRATIC_STEPS = 6
SIMPLE_QUADRATIC_RTOL = 0.05


def _rules(opt=FAST_OPT):
    """The JAX test's table (``tests/integration/test_bayesian_optimization.py:44-102``),
    built from the port."""
    return {
        "ei": lambda space: EfficientGlobalOptimization(optimizer=opt),
        "aei": lambda space: EfficientGlobalOptimization(
            AugmentedExpectedImprovement(), optimizer=opt
        ),
        "nlcb": lambda space: EfficientGlobalOptimization(
            NegativeLowerConfidenceBound(1.96), optimizer=opt
        ),
        "mcei": lambda space: EfficientGlobalOptimization(
            MonteCarloExpectedImprovement(2000), optimizer=opt
        ),
        "qei": lambda space: EfficientGlobalOptimization(
            BatchMonteCarloExpectedImprovement(2000),
            optimizer=opt,
            num_query_points=3,
        ),
        "monlcb": lambda space: EfficientGlobalOptimization(
            MultipleOptimismNegativeLowerConfidenceBound(space),
            optimizer=opt,
            num_query_points=3,
        ),
        "dts": lambda space: DiscreteThompsonSampling(1000, 5),
        "async": lambda space: AsynchronousOptimization(
            BatchMonteCarloExpectedImprovement(1000),
            optimizer=opt,
            num_query_points=2,
        ),
        "mes": lambda space: EfficientGlobalOptimization(
            MinValueEntropySearch(space), optimizer=opt
        ),
        "gibbon": lambda space: EfficientGlobalOptimization(
            GIBBON(space), optimizer=opt, num_query_points=2
        ),
        "lp": lambda space: EfficientGlobalOptimization(
            LocalPenalization(space), optimizer=opt, num_query_points=3
        ),
        "fantasizer": lambda space: EfficientGlobalOptimization(
            Fantasizer(), optimizer=opt, num_query_points=3
        ),
        "pcts": lambda space: EfficientGlobalOptimization(
            ParallelContinuousThompsonSampling(), optimizer=opt, num_query_points=4
        ),
        "gcts": lambda space: EfficientGlobalOptimization(
            GreedyContinuousThompsonSampling(), optimizer=opt, num_query_points=2
        ),
        "trego": lambda space: BatchTrustRegionBox(
            init_subspaces=[TREGOBox(space)],
            rule=EfficientGlobalOptimization(optimizer=opt),
        ),
        "turbo": lambda space: BatchTrustRegionBox(
            init_subspaces=[TURBOBox(space)],
            rule=[EfficientGlobalOptimization(optimizer=opt)],
        ),
        "batch-tr": lambda space: BatchTrustRegionBox(init_subspaces=3),
        "qhsri": lambda space: BatchHypervolumeSharpeRatioIndicator(
            num_query_points=3, ga_population_size=50, ga_n_generations=15
        ),
    }


def _solve(problem, rule_factory, num_steps, seed, rtol, *, device="cpu",
           dtype=torch.float64, num_initial=5):
    """The JAX test's ``_solve`` on the port: one generator seeded with ``seed`` draws the
    initial points and drives the loop, which stops once ``stop_at_minimum`` holds.
    Returns ``(result, steps taken, relative error of the best observation)``; the error
    is ``inf`` where the run failed."""
    observer = mk_observer(problem.objective)
    space = problem.search_space.to(device, dtype)
    generator = torch.Generator(device=device).manual_seed(seed)
    initial = observer(space.sample(generator, num_initial))
    model = build_gpr(initial, space, likelihood_variance=1e-7, trainable_likelihood=False)
    stop = stop_at_minimum(problem.minimum, problem.minimizers, minimum_rtol=rtol)
    stops = []  # one entry per step begun: whether the loop stopped there

    def early_stop(datasets, models, state):
        stops.append(stop(datasets, models, state))
        return stops[-1]

    result = BayesianOptimizer(observer, space).optimize(
        num_steps, initial, model, rule_factory(space), generator=generator,
        track_state=False, early_stop_callback=early_stop,
    )
    steps = len(stops) - 1 if stops and stops[-1] else len(stops)
    if not result.is_ok:
        return result, steps, math.inf
    _, obs, _ = result.try_get_optimal_point()
    minimum = float(problem.minimum[0])
    return result, steps, abs(float(obs[0]) - minimum) / abs(minimum)


@pytest.mark.parametrize("rule_name", sorted(_rules()))
def test_all_rules_solve_simple_quadratic(rule_name):
    """Every rule solves SimpleQuadratic in at most 6 steps, rtol 0.05 (the JAX test's
    test of the same name, ``:133-141``)."""
    result, steps, rel_err = _solve(SimpleQuadratic, _rules()[rule_name],
                                    SIMPLE_QUADRATIC_STEPS, seed=0, rtol=SIMPLE_QUADRATIC_RTOL)
    assert result.is_ok, f"BO run errored: {result.final_result}"
    assert steps <= SIMPLE_QUADRATIC_STEPS
    assert rel_err < SIMPLE_QUADRATIC_RTOL, f"{rule_name}: rel err {rel_err} after {steps} steps"

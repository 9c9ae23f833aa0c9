"""Batch Bayesian optimization: qEI, local penalization, and fantasizing, on the port.

Counterpart of ``examples/batch_optimization.py`` for ``trieste_tpu_torch`` (reference
tutorial ``docs/notebooks/batch_optimization.pct.py``): three ways to acquire a batch of
query points per step, so several observations can run in parallel.

Run: ``python examples_torch/batch_optimization.py [num_steps] [--device cpu]``
"""
import argparse
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import trieste_tpu_torch as tt
from trieste_tpu_torch.acquisition import (
    BatchMonteCarloExpectedImprovement,
    Fantasizer,
    LocalPenalization,
)
from trieste_tpu_torch.acquisition.rule import EfficientGlobalOptimization
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.objectives import ScaledBranin, mk_observer


def run(rule_name: str, rule, num_steps: int, space) -> float:
    problem = ScaledBranin
    observer = mk_observer(problem.objective)
    generator = torch.Generator(device=space.device).manual_seed(0)
    initial_data = observer(space.sample(generator, 5))
    model = build_gpr(
        initial_data, space, likelihood_variance=1e-7, trainable_likelihood=False
    )
    result = tt.BayesianOptimizer(observer, space).optimize(
        num_steps, initial_data, model, rule, generator=generator, track_state=False
    )
    _, observation, _ = result.try_get_optimal_point()
    print(f"{rule_name:12s} best observation: {float(observation[0]):.6f}")
    return float(observation[0])


def main(num_steps: int = 8, *, device: Optional[str] = None) -> dict:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    dtype = torch.float32 if dev.type == "cuda" else torch.float64
    space = ScaledBranin.search_space.to(dev, dtype)
    return {
        "qEI": run(
            "qEI",
            EfficientGlobalOptimization(
                BatchMonteCarloExpectedImprovement(1000), num_query_points=3
            ),
            num_steps,
            space,
        ),
        "local-pen": run(
            "local-pen",
            EfficientGlobalOptimization(LocalPenalization(space), num_query_points=3),
            num_steps,
            space,
        ),
        "fantasizer": run(
            "fantasizer",
            EfficientGlobalOptimization(Fantasizer(), num_query_points=3),
            num_steps,
            space,
        ),
    }


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("num_steps", type=int, nargs="?", default=8)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(args.num_steps, device=args.device)

"""Active learning: uncertainty reduction and level-set estimation, on the port.

Counterpart of ``examples/active_learning.py`` for ``trieste_tpu_torch`` (reference
tutorial ``docs/notebooks/active_learning.pct.py``): query points to learn the function
everywhere (predictive variance) or to locate a feasibility boundary (Bichon expected
feasibility), rather than to find a minimum.

Run: ``python examples_torch/active_learning.py [num_steps] [--device cpu]``
"""
import argparse
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import trieste_tpu_torch as tt
from trieste_tpu_torch.acquisition.function.active_learning import (
    ExpectedFeasibility,
    PredictiveVariance,
)
from trieste_tpu_torch.acquisition.rule import EfficientGlobalOptimization
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.objectives import Branin, mk_observer


def main(num_steps: int = 10, *, device: Optional[str] = None) -> dict:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    dtype = torch.float32 if dev.type == "cuda" else torch.float64

    problem = Branin
    observer = mk_observer(problem.objective)
    space = problem.search_space.to(dev, dtype)
    generator = torch.Generator(device=dev).manual_seed(0)
    initial_data = observer(space.sample(generator, 6))
    model = build_gpr(initial_data, space, likelihood_variance=1e-5)

    # 1. global model improvement: maximize the joint predictive variance
    rule = EfficientGlobalOptimization(PredictiveVariance())
    result = tt.BayesianOptimizer(observer, space).optimize(
        num_steps, initial_data, model, rule, generator=generator, track_state=False
    )
    data = result.try_get_final_dataset()
    print(f"predictive-variance run collected {data.num_points} points")

    # 2. level-set estimation: learn the contour {x : f(x) = threshold}
    threshold = 80.0
    model2 = build_gpr(initial_data, space, likelihood_variance=1e-5)
    rule2 = EfficientGlobalOptimization(ExpectedFeasibility(threshold, delta=1))
    result2 = tt.BayesianOptimizer(observer, space).optimize(
        num_steps, initial_data, model2, rule2, generator=generator, track_state=False
    )
    final_model = result2.try_get_final_model()
    # how well is the level set located? check sign agreement on a grid
    grid = space.sample(torch.Generator(device=dev).manual_seed(7), 2000)
    truth_below = problem.objective(grid)[:, 0] < threshold
    pred_below = final_model.predict(grid)[0][:, 0] < threshold
    accuracy = float((truth_below == pred_below).double().mean())
    print(f"level-set sign accuracy after {num_steps} steps: {accuracy:.3f}")
    return {"points_collected": int(data.num_points), "level_set_accuracy": accuracy}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("num_steps", type=int, nargs="?", default=10)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(args.num_steps, device=args.device)

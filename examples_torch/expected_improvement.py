"""Introduction: Bayesian optimization with expected improvement, on the port.

Counterpart of ``examples/expected_improvement.py`` for ``trieste_tpu_torch`` (reference
tutorial ``docs/notebooks/expected_improvement.pct.py``): minimize the two-dimensional
ScaledBranin function with a GP surrogate and the default analytic-EI EGO rule.

Run: ``python examples_torch/expected_improvement.py [num_steps] [--device cpu]``
"""
import argparse
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import trieste_tpu_torch as tt
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.objectives import ScaledBranin, mk_observer


def main(num_steps: int = 15, *, device: Optional[str] = None) -> dict:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    dtype = torch.float32 if dev.type == "cuda" else torch.float64

    problem = ScaledBranin
    observer = mk_observer(problem.objective)
    space = problem.search_space.to(dev, dtype)

    generator = torch.Generator(device=dev).manual_seed(0)
    initial_data = observer(space.sample(generator, 5))
    # MAP-prior GPR surrogate; the classic low-noise deterministic-objective recipe
    model = build_gpr(
        initial_data, space, likelihood_variance=1e-7, trainable_likelihood=False
    )

    bo = tt.BayesianOptimizer(observer, space)
    result = bo.optimize(num_steps, initial_data, model, generator=generator)

    query_point, observation, _ = result.try_get_optimal_point()
    minimum = float(problem.minimum[0])
    rel_err = abs(float(observation[0]) - minimum) / abs(minimum)
    print(f"query point:   {query_point.tolist()}")
    print(f"observation:   {float(observation[0]):.6f}")
    print(f"true minimum:  {minimum:.6f}")
    print(f"relative error: {rel_err:.2e}")
    return {"query_point": query_point.tolist(), "observation": float(observation[0]),
            "true_minimum": minimum, "relative_error": rel_err}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("num_steps", type=int, nargs="?", default=15)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(args.num_steps, device=args.device)

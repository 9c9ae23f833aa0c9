"""Mixed continuous/discrete/categorical search spaces, on the port.

Counterpart of ``examples/mixed_search_spaces.py`` for ``trieste_tpu_torch`` (reference
tutorial ``docs/notebooks/mixed_search_spaces.pct.py``): optimize over a tagged product
of a continuous box and a discrete set; the acquisition optimizer freezes the discrete
dimensions of each run, optimizes the continuous ones, and returns valid members.

Run: ``python examples_torch/mixed_search_spaces.py [num_steps] [--device cpu]``
"""
import argparse
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import trieste_tpu_torch as tt
from trieste_tpu_torch.data import Dataset
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.objectives import ScaledBranin
from trieste_tpu_torch.space import Box, DiscreteSearchSpace, TaggedProductSearchSpace


def main(num_steps: int = 12, *, device: Optional[str] = None) -> dict:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    dtype = torch.float32 if dev.type == "cuda" else torch.float64

    # first Branin coordinate continuous, second restricted to a grid of 11 values
    continuous = Box([0.0], [1.0], dtype=dtype, device=dev)
    discrete = DiscreteSearchSpace(torch.linspace(0.0, 1.0, 11, dtype=dtype, device=dev)[:, None])
    space = TaggedProductSearchSpace([continuous, discrete], tags=["x1", "x2"])

    def observer(qp):
        return Dataset.from_arrays(qp, ScaledBranin.objective(qp))

    generator = torch.Generator(device=dev).manual_seed(0)
    initial_data = observer(space.sample(generator, 6))
    model = build_gpr(
        initial_data, space, likelihood_variance=1e-7, trainable_likelihood=False
    )
    result = tt.BayesianOptimizer(observer, space).optimize(
        num_steps, initial_data, model, generator=generator, track_state=False
    )
    qp, observation, _ = result.try_get_optimal_point()
    on_grid = bool(torch.isclose(discrete.points[:, 0], qp[1]).any())
    minimum = float(ScaledBranin.minimum[0])
    print(f"best point {qp.tolist()} (x2 on the grid: {on_grid})")
    print(f"best observation: {float(observation[0]):.6f} "
          f"(unrestricted minimum {minimum:.6f})")
    return {"best_point": qp.tolist(), "x2_on_grid": on_grid,
            "best_observation": float(observation[0]), "unrestricted_minimum": minimum}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("num_steps", type=int, nargs="?", default=12)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(args.num_steps, device=args.device)

"""Constrained Bayesian optimization: observed and explicit constraints, on the port.

Counterpart of ``examples/inequality_constraints.py`` for ``trieste_tpu_torch`` (reference
tutorials ``docs/notebooks/inequality_constraints.pct.py`` and
``docs/notebooks/explicit_constraints.pct.py``): (1) a black-box constraint modelled by
its own GP and folded into expected constrained improvement (Gardner et al.); (2) known
(explicit) linear constraints attached to the search space, respected by the acquisition
optimizer and feasible sampling.

Run: ``python examples_torch/inequality_constraints.py [num_steps] [--device cpu]``
"""
import argparse
import math
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import trieste_tpu_torch as tt
from trieste_tpu_torch.acquisition import (
    ExpectedConstrainedImprovement,
    ProbabilityOfFeasibility,
)
from trieste_tpu_torch.acquisition.rule import EfficientGlobalOptimization
from trieste_tpu_torch.data import Dataset
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.objectives import ScaledBranin, mk_observer
from trieste_tpu_torch.observer import OBJECTIVE
from trieste_tpu_torch.space import Box, LinearConstraint

CONSTRAINT = "CONSTRAINT"


def gardner_objective(x):
    a, b = x[..., -2], x[..., -1]
    return (torch.cos(2.0 * a) * torch.cos(b) + torch.sin(a))[..., None]


def gardner_constraint(x):
    a, b = x[..., -2], x[..., -1]
    return (torch.cos(a) * torch.cos(b) - torch.sin(a) * torch.sin(b))[..., None]


def observer(qp):
    return {
        OBJECTIVE: Dataset.from_arrays(qp, gardner_objective(qp)),
        CONSTRAINT: Dataset.from_arrays(qp, gardner_constraint(qp)),
    }


def black_box_constraint(num_steps: int, dev: torch.device, dtype: torch.dtype) -> float:
    """Gardner simulation 1: constraint observed alongside the objective."""
    space = Box([0.0, 0.0], [6.0, 6.0], dtype=dtype, device=dev)
    generator = torch.Generator(device=dev).manual_seed(3)
    initial_data = observer(space.sample(generator, 6))
    models = {
        OBJECTIVE: build_gpr(initial_data[OBJECTIVE], space),
        CONSTRAINT: build_gpr(initial_data[CONSTRAINT], space),
    }
    pof = ProbabilityOfFeasibility(threshold=0.5)
    rule = EfficientGlobalOptimization(
        ExpectedConstrainedImprovement(OBJECTIVE, pof.using(CONSTRAINT))
    )
    result = tt.BayesianOptimizer(observer, space).optimize(
        num_steps, initial_data, models, rule, generator=generator, track_state=False
    )
    data = result.final_result.unwrap().datasets[OBJECTIVE]
    best = float(data.trimmed_observations.min())
    print(f"black-box constraint: best {best:.4f} "
          f"(constrained minimum -2.0 at [{math.pi * 1.5:.3f}, 0])")
    return best


def explicit_constraint(num_steps: int, dev: torch.device, dtype: torch.dtype) -> dict:
    """A known linear constraint attached directly to the Box."""
    constraint = LinearConstraint(A=[[1.0, 1.0]], lb=[0.3], ub=[1.2])
    problem = ScaledBranin
    space = Box([0.0, 0.0], [1.0, 1.0], constraints=[constraint], dtype=dtype, device=dev)
    obs = mk_observer(problem.objective)
    generator = torch.Generator(device=dev).manual_seed(0)
    initial = obs(space.sample_feasible(generator, 6))
    model = build_gpr(initial, space, likelihood_variance=1e-7,
                      trainable_likelihood=False)
    result = tt.BayesianOptimizer(obs, space).optimize(
        num_steps, initial, model, generator=generator, track_state=False
    )
    qp, observation, _ = result.try_get_optimal_point()
    feasible = bool(space.is_feasible(qp[None]).all())
    print(f"explicit constraint: best {float(observation[0]):.4f} at {qp.tolist()} "
          f"(feasible: {feasible})")
    return {"explicit_best": float(observation[0]), "explicit_point": qp.tolist(),
            "explicit_feasible": feasible}


def main(num_steps: int = 12, *, device: Optional[str] = None) -> dict:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    dtype = torch.float32 if dev.type == "cuda" else torch.float64
    return {"black_box_best": black_box_constraint(num_steps, dev, dtype),
            **explicit_constraint(num_steps, dev, dtype)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("num_steps", type=int, nargs="?", default=12)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(args.num_steps, device=args.device)

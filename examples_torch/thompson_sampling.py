"""Thompson sampling: discrete and continuous (trajectory-based) variants, on the port.

Counterpart of ``examples/thompson_sampling.py`` for ``trieste_tpu_torch`` (reference
tutorials ``docs/notebooks/thompson_sampling.pct.py`` and
``docs/notebooks/scalable_thompson_sampling_using_sparse_gaussian_processes.pct.py``):
batch acquisition by sampling from the posterior, over a discrete candidate set or by
optimizing decoupled posterior trajectories; the sparse variant scales the surrogate
itself.

Run: ``python examples_torch/thompson_sampling.py [num_steps] [--device cpu]``
"""
import argparse
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import trieste_tpu_torch as tt
from trieste_tpu_torch.acquisition import ParallelContinuousThompsonSampling
from trieste_tpu_torch.acquisition.rule import (
    DiscreteThompsonSampling,
    EfficientGlobalOptimization,
)
from trieste_tpu_torch.models.gp import build_gpr, build_svgp
from trieste_tpu_torch.objectives import ScaledBranin, mk_observer


def run(name: str, model_factory, rule, num_steps: int, space) -> float:
    problem = ScaledBranin
    observer = mk_observer(problem.objective)
    generator = torch.Generator(device=space.device).manual_seed(0)
    initial_data = observer(space.sample(generator, 10))
    model = model_factory(initial_data, space)
    result = tt.BayesianOptimizer(observer, space).optimize(
        num_steps, initial_data, model, rule, generator=generator, track_state=False
    )
    _, observation, _ = result.try_get_optimal_point()
    print(f"{name:14s} best observation: {float(observation[0]):.6f}")
    return float(observation[0])


def main(num_steps: int = 10, *, device: Optional[str] = None) -> dict:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    dtype = torch.float32 if dev.type == "cuda" else torch.float64
    space = ScaledBranin.search_space.to(dev, dtype)

    gpr = lambda data, space: build_gpr(  # noqa: E731
        data, space, likelihood_variance=1e-7, trainable_likelihood=False
    )
    best = {}
    # sample the posterior at 1000 random candidates, keep the best 4
    best["discrete-TS"] = run(
        "discrete-TS", gpr, DiscreteThompsonSampling(1000, 4), num_steps, space
    )
    # optimize 4 decoupled posterior trajectories as a vectorized acquisition
    best["parallel-CTS"] = run(
        "parallel-CTS",
        gpr,
        EfficientGlobalOptimization(
            ParallelContinuousThompsonSampling(), num_query_points=4
        ),
        num_steps,
        space,
    )
    # the same rule over a sparse (inducing-point) surrogate for larger datasets
    svgp = lambda data, space: build_svgp(data, space, num_inducing_points=20)  # noqa: E731
    best["CTS-over-SVGP"] = run(
        "CTS-over-SVGP",
        svgp,
        EfficientGlobalOptimization(
            ParallelContinuousThompsonSampling(), num_query_points=4
        ),
        num_steps,
        space,
    )
    return best


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("num_steps", type=int, nargs="?", default=10)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(args.num_steps, device=args.device)

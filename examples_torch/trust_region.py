"""Trust-region Bayesian optimization: TREGO, TuRBO, and batched regions, on the port.

Counterpart of ``examples/trust_region.py`` for ``trieste_tpu_torch`` (reference tutorial
``docs/notebooks/trust_region.pct.py``): rules that restrict acquisition to adaptive
subregions of the space, which helps on multimodal or higher-dimensional problems.

Run: ``python examples_torch/trust_region.py [num_steps] [--device cpu]``
"""
import argparse
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import trieste_tpu_torch as tt
from trieste_tpu_torch.acquisition.rule import EfficientGlobalOptimization
from trieste_tpu_torch.acquisition.trust_region import (
    BatchTrustRegionBox,
    TREGOBox,
    TURBOBox,
)
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.objectives import ScaledBranin, mk_observer


def run(name: str, rule_factory, num_steps: int, space) -> float:
    problem = ScaledBranin
    observer = mk_observer(problem.objective)
    generator = torch.Generator(device=space.device).manual_seed(0)
    initial_data = observer(space.sample(generator, 5))
    model = build_gpr(
        initial_data, space, likelihood_variance=1e-7, trainable_likelihood=False
    )
    result = tt.BayesianOptimizer(observer, space).optimize(
        num_steps, initial_data, model, rule_factory(space), generator=generator,
        track_state=False,
    )
    _, observation, _ = result.try_get_optimal_point()
    print(f"{name:10s} best observation: {float(observation[0]):.6f}")
    return float(observation[0])


def main(num_steps: int = 10, *, device: Optional[str] = None) -> dict:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    dtype = torch.float32 if dev.type == "cuda" else torch.float64
    space = ScaledBranin.search_space.to(dev, dtype)
    return {
        "TREGO": run(
            "TREGO",
            lambda space: BatchTrustRegionBox(
                init_subspaces=[TREGOBox(space)], rule=EfficientGlobalOptimization()
            ),
            num_steps,
            space,
        ),
        "TuRBO": run(
            "TuRBO",
            lambda space: BatchTrustRegionBox(
                init_subspaces=[TURBOBox(space)], rule=[EfficientGlobalOptimization()]
            ),
            num_steps,
            space,
        ),
        # three independent local regions acquiring one point each per step
        "batch-TR": run(
            "batch-TR", lambda space: BatchTrustRegionBox(init_subspaces=3), num_steps, space
        ),
    }


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("num_steps", type=int, nargs="?", default=10)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(args.num_steps, device=args.device)

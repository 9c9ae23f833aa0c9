"""Non-GP surrogates: deep ensembles and deep Gaussian processes, on the port.

Counterpart of ``examples/deep_models.py`` for ``trieste_tpu_torch`` (reference tutorials
``docs/notebooks/deep_ensembles.pct.py`` and
``docs/notebooks/deep_gaussian_processes.pct.py``): neural-network and deep-GP surrogates
paired with trajectory-based Thompson sampling (the acquisition family that only needs
samples, not analytic posteriors). On the card each fit replays one CUDA graph of its
Adam step.

Run: ``python examples_torch/deep_models.py [num_steps] [--device cpu]``
"""
import argparse
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import trieste_tpu_torch as tt
from trieste_tpu_torch.acquisition import ParallelContinuousThompsonSampling
from trieste_tpu_torch.acquisition.rule import EfficientGlobalOptimization
from trieste_tpu_torch.models.deepgp import build_vanilla_deep_gp
from trieste_tpu_torch.models.ensembles import build_deep_ensemble
from trieste_tpu_torch.objectives import ScaledBranin, mk_observer


def run(name: str, model_factory, num_steps: int, space) -> float:
    problem = ScaledBranin
    observer = mk_observer(problem.objective)
    generator = torch.Generator(device=space.device).manual_seed(0)
    initial_data = observer(space.sample(generator, 15))
    model = model_factory(initial_data, space)
    rule = EfficientGlobalOptimization(
        ParallelContinuousThompsonSampling(), num_query_points=4
    )
    result = tt.BayesianOptimizer(observer, space).optimize(
        num_steps, initial_data, model, rule, generator=generator, track_state=False
    )
    _, observation, _ = result.try_get_optimal_point()
    print(f"{name:14s} best observation: {float(observation[0]):.6f}")
    return float(observation[0])


def main(num_steps: int = 8, *, device: Optional[str] = None) -> dict:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    dtype = torch.float32 if dev.type == "cuda" else torch.float64
    space = ScaledBranin.search_space.to(dev, dtype)
    return {
        "deep-ensemble": run(
            "deep-ensemble",
            lambda ds, space: build_deep_ensemble(ds, ensemble_size=5, num_train_steps=600),
            num_steps,
            space,
        ),
        "deep-GP": run(
            "deep-GP",
            lambda ds, space: build_vanilla_deep_gp(
                ds, space, num_layers=2, num_train_steps=800
            ),
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

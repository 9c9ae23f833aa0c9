"""Multi-objective optimization with expected hypervolume improvement, on the port.

Counterpart of ``examples/multi_objective_ehvi.py`` for ``trieste_tpu_torch`` (reference
tutorial ``docs/notebooks/multi_objective_ehvi.pct.py``): find the Pareto front of the
two-objective VLMOP2 problem with independent GP surrogates stacked per objective and the
EHVI acquisition.

Run: ``python examples_torch/multi_objective_ehvi.py [num_steps] [--device cpu]``
"""
import argparse
import math
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import trieste_tpu_torch as tt
from trieste_tpu_torch.acquisition.function.multi_objective import (
    ExpectedHypervolumeImprovement,
)
from trieste_tpu_torch.acquisition.multi_objective.pareto import Pareto, get_reference_point
from trieste_tpu_torch.acquisition.rule import EfficientGlobalOptimization
from trieste_tpu_torch.data import Dataset
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.models.interfaces import TrainableModelStack
from trieste_tpu_torch.objectives import VLMOP2, mk_observer
from trieste_tpu_torch.observer import OBJECTIVE


def main(num_steps: int = 15, *, device: Optional[str] = None) -> dict:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    dtype = torch.float32 if dev.type == "cuda" else torch.float64

    problem = VLMOP2
    observer = mk_observer(problem.objective)
    space = problem.search_space.to(dev, dtype)
    generator = torch.Generator(device=dev).manual_seed(0)
    initial_data = observer(space.sample(generator, 10))

    # one independent GPR per objective, stacked into a single multi-output model
    gprs = []
    for idx in range(2):
        single = Dataset.from_arrays(
            initial_data.trimmed_query_points,
            initial_data.trimmed_observations[:, idx : idx + 1],
        )
        gprs.append((build_gpr(single, space, likelihood_variance=1e-5), 1))
    model = TrainableModelStack(*gprs)

    rule = EfficientGlobalOptimization(
        ExpectedHypervolumeImprovement().using(OBJECTIVE)
    )
    result = tt.BayesianOptimizer(observer, space).optimize(
        num_steps, initial_data, model, rule, generator=generator, track_state=False
    )

    observations = result.final_result.unwrap().datasets[OBJECTIVE].trimmed_observations
    ideal_front = problem.gen_pareto_optimal_points(
        100, torch.Generator(device=dev).manual_seed(1)
    ).to(dtype)
    ref_point = get_reference_point(ideal_front)
    front = Pareto(observations).front
    observed_hv = float(Pareto(observations).hypervolume_indicator(ref_point))
    ideal_hv = float(Pareto(ideal_front).hypervolume_indicator(ref_point))
    log_hv_diff = math.log(max(ideal_hv - observed_hv, 1e-12))
    print(f"observed front size: {front.shape[0]}")
    print(f"hypervolume: {observed_hv:.4f} (ideal {ideal_hv:.4f})")
    print(f"log hypervolume difference: {log_hv_diff:.3f}")
    return {"front": front.tolist(), "hypervolume": observed_hv, "ideal_hypervolume": ideal_hv,
            "log_hypervolume_difference": log_hv_diff}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("num_steps", type=int, nargs="?", default=15)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(args.num_steps, device=args.device)

"""Scaling Bayesian optimization over the ranks of a ``torch.distributed`` group.

Counterpart of ``examples/multi_chip_scaling.py`` for ``trieste_tpu_torch`` (reference
tutorials ``docs/notebooks/asynchronous_greedy_multiprocessing.pct.py`` and
``asynchronous_nongreedy_batch_ray.pct.py``): install a pool mesh once and the whole
framework shards over it: the acquisition optimizer's candidate pool and multi-start
L-BFGS runs, the GP trainers' restart pools, and the fused scoring kernel (each rank
scores its own block of the pool), with the best-of reductions as the only traffic.

The port's mesh spans ranks, one process per device, not the devices of one process
(``trieste_tpu_torch.parallel.mesh``). Run alone, the example uses the one-rank mesh of
``create_mesh()``, which takes the unsharded path and calls no collective. Under
``torchrun`` (``WORLD_SIZE`` set) each rank first joins the launcher's group with
``initialize_multi_host``, from the launcher's ``MASTER_ADDR``, ``MASTER_PORT`` and
``RANK``; with ``--device cpu`` the ranks join by gloo:

``python examples_torch/multi_chip_scaling.py [num_steps] [--device cpu]``
``torchrun --nproc_per_node 4 examples_torch/multi_chip_scaling.py``
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
from trieste_tpu_torch.parallel import create_mesh, global_mesh, initialize_multi_host


def main(num_steps: int = 5, *, device: Optional[str] = None) -> dict:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    dtype = torch.float32 if dev.type == "cuda" else torch.float64

    launched = "WORLD_SIZE" in os.environ and not torch.distributed.is_initialized()
    if launched:  # one rank of a torchrun launch: cuda:$LOCAL_RANK becomes "cuda"
        initialize_multi_host(
            f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
            device="cpu" if dev.type == "cpu" else None,
        )
    try:
        mesh = create_mesh()  # one "pool" axis over every rank of the group
        print(f"running over {mesh.size} rank(s); this one is rank {mesh.rank} on {dev}")

        problem = ScaledBranin
        observer = mk_observer(problem.objective)
        space = problem.search_space.to(dev, dtype)
        generator = torch.Generator(device=dev).manual_seed(0)
        initial_data = observer(space.sample(generator, 5))

        with global_mesh(mesh):
            # everything below is IDENTICAL to the single-device quickstart: the installed
            # mesh shards model fitting and acquisition optimization transparently
            model = build_gpr(
                initial_data, space, likelihood_variance=1e-7, trainable_likelihood=False
            )
            result = tt.BayesianOptimizer(observer, space).optimize(
                num_steps, initial_data, model, generator=generator, track_state=False
            )
    finally:
        if launched:
            torch.distributed.destroy_process_group()

    _, observation, _ = result.try_get_optimal_point()
    minimum = float(problem.minimum[0])
    print(f"best observation: {float(observation[0]):.6f} "
          f"(true minimum {minimum:.6f})")
    return {"ranks": mesh.size, "best_observation": float(observation[0]),
            "true_minimum": minimum}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("num_steps", type=int, nargs="?", default=5)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(args.num_steps, device=args.device)

"""Asynchronous BO across worker processes through the port's Ask/Tell API.

The counterpart of ``scripts/async_multiprocessing_demo.py`` for ``trieste_tpu_torch``:
the main process owns an :class:`~trieste_tpu_torch.AskTellOptimizer` with an
``AsynchronousGreedy(LocalPenalization)`` rule, which keeps the points in flight as
pending points, and worker processes evaluate ScaledBranin with a random latency. A point
is handed out as soon as a worker is free, and the results are told back as they arrive,
out of order.

Usage: ``python scripts/torch_async_multiprocessing_demo.py [num_workers]
[num_observations] [--device cuda|cpu]`` (default 3 workers, 12 observations, ``cuda``).
It prints each observation and exits 0 if the run improved on the initial design.
"""
from __future__ import annotations

import math
import multiprocessing as mp
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def observer_worker(worker_id: int, point_queue, result_queue) -> None:
    """A remote evaluation: ScaledBranin at each point it is given, with random latency."""
    import random

    rng = random.Random(worker_id)
    while True:
        msg = point_queue.get()
        if msg is None:
            return
        idx, x = msg
        x0, x1 = 15.0 * x[0] - 5.0, 15.0 * x[1]
        y = ((x1 - 5.1 / (4 * math.pi**2) * x0**2 + 5 / math.pi * x0 - 6) ** 2
             + 10 * (1 - 1 / (8 * math.pi)) * math.cos(x0) + 10)
        time.sleep(rng.uniform(0.01, 0.1))
        result_queue.put((idx, x, (y - 54.8104) / 51.9496))


def main(num_workers: int = 3, num_observations: int = 12, device: str = "cuda") -> int:
    import torch

    from trieste_tpu_torch import AskTellOptimizer
    from trieste_tpu_torch.acquisition import (
        AsynchronousGreedy, LocalPenalization, generate_continuous_optimizer,
    )
    from trieste_tpu_torch.data import Dataset
    from trieste_tpu_torch.models.gp import build_gpr
    from trieste_tpu_torch.objectives import ScaledBranin, mk_observer
    from trieste_tpu_torch.observer import OBJECTIVE

    dtype = torch.float64 if device == "cpu" else torch.float32
    space = ScaledBranin.search_space.to(device, dtype)
    generator = torch.Generator(device=device).manual_seed(0)
    initial = mk_observer(ScaledBranin.objective)(space.sample(generator, 6))
    initial_best = float(initial.trimmed_observations.min())
    model = build_gpr(initial, space, likelihood_variance=1e-7, trainable_likelihood=False)
    rule = AsynchronousGreedy(
        LocalPenalization(space).using(OBJECTIVE),
        optimizer=generate_continuous_optimizer(num_initial_samples=512,
                                                num_optimization_runs=6),
    )
    optimizer = AskTellOptimizer(space, initial, model, rule, generator=generator)

    context = mp.get_context("spawn")
    point_queue, result_queue = context.Queue(), context.Queue()
    workers = [context.Process(target=observer_worker, args=(i, point_queue, result_queue),
                               daemon=True) for i in range(num_workers)]
    for w in workers:
        w.start()
    try:
        issued = 0
        for _ in range(min(num_workers, num_observations)):  # concurrent asks: pending points
            point_queue.put((issued, optimizer.ask().reshape(-1).tolist()))
            issued += 1
        for observed in range(1, num_observations + 1):
            idx, x, y = result_queue.get(timeout=120)
            optimizer.tell(Dataset.from_arrays(torch.tensor([x], dtype=dtype, device=device),
                                               torch.tensor([[y]], dtype=dtype, device=device)))
            best = float(optimizer.datasets[OBJECTIVE].trimmed_observations.min())
            print(f"observed #{observed} from task {idx}: y={y:.4f} best={best:.4f}", flush=True)
            if issued < num_observations:
                point_queue.put((issued, optimizer.ask().reshape(-1).tolist()))
                issued += 1
    finally:
        for _ in workers:
            point_queue.put(None)
        for w in workers:
            w.join(timeout=30)
            if w.is_alive():
                w.terminate()
    final_best = float(optimizer.datasets[OBJECTIVE].trimmed_observations.min())
    print(f"ASYNC DEMO DONE: initial best {initial_best:.4f} -> final best {final_best:.4f}")
    return 0 if final_best < initial_best else 1


if __name__ == "__main__":
    args = sys.argv[1:]
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i : i + 2]
    sys.exit(main(*(int(a) for a in args[:2]), device=device))

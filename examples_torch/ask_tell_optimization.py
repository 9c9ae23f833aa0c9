"""Driving the BO loop yourself with the Ask/Tell interface, on the port.

Counterpart of ``examples/ask_tell_optimization.py`` for ``trieste_tpu_torch`` (reference
tutorial ``docs/notebooks/ask_tell_optimization.pct.py``): the open-loop interface for
when the objective is evaluated outside the framework (lab hardware, another process, a
scheduler), including pausing and resuming through a state saved with ``torch.save``.
The resumed optimizer asks for the very point the uninterrupted one would have asked for.

Run: ``python examples_torch/ask_tell_optimization.py [num_steps] [--device cpu]``
"""
import argparse
import io
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from trieste_tpu_torch.ask_tell_optimization import AskTellOptimizer
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.objectives import ScaledBranin, mk_observer


def main(num_steps: int = 10, *, device: Optional[str] = None) -> dict:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    dtype = torch.float32 if dev.type == "cuda" else torch.float64

    problem = ScaledBranin
    observer = mk_observer(problem.objective)
    space = problem.search_space.to(dev, dtype)
    generator = torch.Generator(device=dev).manual_seed(0)
    data = observer(space.sample(generator, 5))
    model = build_gpr(data, space, likelihood_variance=1e-7, trainable_likelihood=False)

    ask_tell = AskTellOptimizer(space, data, model, generator=generator)
    for step in range(num_steps // 2):
        points = ask_tell.ask()
        ask_tell.tell(observer(points))  # observe however and wherever you like

    # pause: save everything, the generator's state included, to bytes (a file works the
    # same); resume later, or elsewhere, from them
    buffer = io.BytesIO()
    torch.save({"state": ask_tell.to_state(copy=True), "generator": generator.get_state()},
               buffer)
    buffer.seek(0)
    saved = torch.load(buffer, weights_only=False)
    resumed_generator = torch.Generator(device=dev)
    resumed_generator.set_state(saved["generator"])
    resumed = AskTellOptimizer.from_state(saved["state"], space, generator=resumed_generator)

    points = resumed.ask()
    # the paused optimizer, carried on, asks for the same point
    resumes_exactly = bool(torch.equal(points, ask_tell.ask()))
    for step in range(num_steps - num_steps // 2):
        if step:
            points = resumed.ask()
        resumed.tell(observer(points))

    best = float(resumed.dataset.trimmed_observations.min())
    minimum = float(problem.minimum[0])
    print(f"resumed run asks for the uninterrupted run's point: {resumes_exactly}")
    print(f"best observation after resume: {best:.6f} (true minimum {minimum:.6f})")
    return {"resumes_exactly": resumes_exactly, "best_observation": best,
            "true_minimum": minimum}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("num_steps", type=int, nargs="?", default=10)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(args.num_steps, device=args.device)

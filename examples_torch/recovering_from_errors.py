"""Failure handling: error capture, saved history, and resuming, on the port.

Counterpart of ``examples/recovering_from_errors.py`` for ``trieste_tpu_torch`` (reference
tutorial ``docs/notebooks/recovering_from_errors.pct.py``): when the observer (or any
step) raises, the loop returns an ``Err`` result that still carries the full history, so
no observations are lost, and ``continue_optimization`` resumes from it.

Run: ``python examples_torch/recovering_from_errors.py [--device cpu]``
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


class FlakyObserver:
    """Raises on one unlucky evaluation, then works again, like real lab hardware."""

    def __init__(self, fail_at_call: int):
        self.calls = 0
        self.fail_at_call = fail_at_call

    def __call__(self, qp):
        self.calls += 1
        if self.calls == self.fail_at_call:
            raise RuntimeError("simulated hardware failure")
        return Dataset.from_arrays(qp, ScaledBranin.objective(qp))


def main(*, device: Optional[str] = None) -> dict:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    dtype = torch.float32 if dev.type == "cuda" else torch.float64

    space = ScaledBranin.search_space.to(dev, dtype)
    observer = FlakyObserver(fail_at_call=4)
    generator = torch.Generator(device=dev).manual_seed(0)
    initial_data = observer(space.sample(generator, 5))
    model = build_gpr(initial_data, space, likelihood_variance=1e-7,
                      trainable_likelihood=False)

    bo = tt.BayesianOptimizer(observer, space)
    result = bo.optimize(10, initial_data, model, generator=generator, track_state=True)
    print(f"first run ok: {result.is_ok}; history length: {len(result.history)}")
    assert result.is_err  # the simulated failure surfaced as an Err, not a crash

    # every pre-failure step was recorded; resume from the saved history
    resumed = bo.continue_optimization(
        10, result, generator=torch.Generator(device=dev).manual_seed(1)
    )
    print(f"resumed run ok: {resumed.is_ok}")
    _, observation, _ = resumed.try_get_optimal_point()
    minimum = float(ScaledBranin.minimum[0])
    print(f"best observation after resume: {float(observation[0]):.6f} "
          f"(true minimum {minimum:.6f})")
    return {"first_run_ok": result.is_ok, "first_run_history": len(result.history),
            "resumed_ok": resumed.is_ok, "best_observation": float(observation[0]),
            "true_minimum": minimum}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(device=parser.parse_args().device)

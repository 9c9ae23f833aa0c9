"""Run the port's tutorials (``examples_torch/``) at their default budgets and time them.

Each example runs in this process, after ``np.random.seed(0)``, at the default budget of
its ``main`` (the JAX example's). One JSON line per example: its seconds, the BO steps it
took (loop steps and Ask/Tell asks, over all of its runs), seconds per step (initial fits
and set-up included), the fused kernel's launches and the dict the example returned. The
examples' own printing goes to stderr.

Usage: ``python scripts/torch_run_examples.py [--device cuda|cpu] [example ...]``
(default: every example on ``cuda``). Phase 32 of ``chip_smoke.py`` runs them at one step.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import inspect
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("examples", nargs="*")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    import numpy as np
    import torch

    from trieste_tpu_torch import bayesian_optimizer
    from trieste_tpu_torch.ask_tell_optimization import AskTellOptimizerABC
    from trieste_tpu_torch.ops import fused_predict as fp

    if args.device != "cpu" and not torch.cuda.is_available():
        print("torch_run_examples: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    steps = [0]

    def counted(f):
        def wrapper(*a, **k):
            steps[0] += 1
            return f(*a, **k)
        return wrapper

    # a loop step sets its step number once; an Ask/Tell step is one ask
    bayesian_optimizer.set_step_number = counted(bayesian_optimizer.set_step_number)
    AskTellOptimizerABC.ask = counted(AskTellOptimizerABC.ask)

    names = args.examples or sorted(p.stem for p in (REPO / "examples_torch").glob("*.py"))
    for name in names:
        spec = importlib.util.spec_from_file_location(
            f"examples_torch_{name}", REPO / "examples_torch" / f"{name}.py"
        )
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        budget = inspect.signature(module.main).parameters.get("num_steps")
        call_args = () if budget is None else (budget.default,)
        np.random.seed(0)
        steps[0], launches = 0, fp.launches
        if args.device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            out = module.main(*call_args, device=args.device)
        if args.device != "cpu":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        print(json.dumps({
            "example": name, "num_steps": call_args[0] if call_args else None,
            "seconds": seconds, "steps": steps[0],
            "s_per_step": seconds / steps[0] if steps[0] else None,
            "launches": fp.launches - launches, "result": out,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

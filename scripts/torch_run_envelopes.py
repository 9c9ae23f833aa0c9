"""The slow ScaledBranin envelope matrix, run on the port.

The counterpart of ``scripts/run_envelopes.py`` for ``trieste_tpu_torch``: each rule of the
reference's slow envelope list (``tests/integration/test_bayesian_optimization.py:143-155``,
14 rules and their step budgets) is built from the port's own table
(``tests/test_torch_integration.py``'s ``_rules``) at the reference's full optimizer budget
and run on ScaledBranin from 5 initial points, an exact GP at likelihood variance 1e-7,
stopped once the best observation is within rtol 0.005 of the minimum. One JSON line per
rule and seed: the budget, the steps used, the best observation, its relative error,
whether it passed and the seconds the run took. The last line sums up the pass rates.

Usage: ``python scripts/torch_run_envelopes.py [--seeds N] [--device cuda|cpu]
[--out FILE] [rule ...]``: seeds 0 to N-1 (default seed 0) on ``cuda`` in fp32
(fp64 on the CPU), every rule; ``--out`` appends the lines to ``FILE`` as well. Exits 1 if
a rule fails at a single seed, or passes on fewer than 80% of several seeds (the JAX
script's bar), else 0.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SLOW_BUDGETS = (
    ("ei", 20), ("nlcb", 25), ("qei", 20), ("monlcb", 30), ("dts", 25),
    ("async", 20), ("mes", 25), ("gibbon", 20), ("lp", 25), ("fantasizer", 20),
    ("pcts", 20), ("trego", 25), ("turbo", 30), ("batch-tr", 15),
)
RTOL = 0.005


def _integration_module():
    """``tests/test_torch_integration.py``, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        "test_torch_integration", REPO / "tests" / "test_torch_integration.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_one(integration, rule: str, budget: int, seed: int, device: str, dtype) -> dict:
    import numpy as np
    import torch

    from trieste_tpu_torch.objectives import ScaledBranin

    np.random.seed(0)  # as the test suite pins numpy's generator for each test
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    result, steps, rel_err = integration._solve(
        ScaledBranin, integration._rules(integration.FULL_OPT)[rule], budget, seed, RTOL,
        device=device, dtype=dtype,
    )
    if device != "cpu":
        torch.cuda.synchronize()
    row = {"rule": rule, "seed": seed, "budget_steps": budget, "steps_used": steps,
           "device": device, "dtype": str(dtype).removeprefix("torch."),
           "seconds": time.perf_counter() - t0}
    if not result.is_ok:
        return {**row, "passed": False, "error": repr(result.final_result.error)}
    _, obs, _ = result.try_get_optimal_point()
    return {**row, "final_best": float(obs[0]), "final_rel_err": rel_err,
            "passed": rel_err < RTOL}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("rules", nargs="*", help="a subset of the rules (default: all 14)")
    parser.add_argument("--seeds", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("torch_run_envelopes: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch.float64 if args.device == "cpu" else torch.float32
    integration = _integration_module()
    torch.set_num_threads(os.cpu_count() or 1)  # the test module pins one thread
    budgets = [(r, b) for r, b in SLOW_BUDGETS if not args.rules or r in args.rules]
    unknown = set(args.rules) - {r for r, _ in SLOW_BUDGETS}
    if unknown:
        parser.error(f"unknown rules {sorted(unknown)}")
    seeds = range(args.seeds)
    rates = {}
    for rule, budget in budgets:
        for seed in seeds:
            row = run_one(integration, rule, budget, seed, args.device, dtype)
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            rates.setdefault(rule, []).append(row["passed"])
    summary = {rule: f"{sum(p)}/{len(p)}" for rule, p in rates.items()}
    print(json.dumps({"pass_rates": summary, "seeds": list(seeds), "rtol": RTOL}))
    bar = 1.0 if args.seeds == 1 else 0.8
    return 0 if all(sum(p) / len(p) >= bar for p in rates.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

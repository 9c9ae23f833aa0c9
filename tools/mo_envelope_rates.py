#!/usr/bin/env python3
"""Per-design results of phase 16's VLMOP2 rules (``chip_smoke.py``): each run's log
hypervolume difference after the reference's step budget, and how many runs meet the
reference's envelope.

    python3 tools/mo_envelope_rates.py --rule EHVI --seeds 0 10 --designs generator
    python3 tools/mo_envelope_rates.py --rule EHVI --seeds 0 5 --designs jax --device cpu

``--designs generator`` draws each run's 10 initial points from a ``torch.Generator``
seeded with the run's seed on ``--design-device`` (default: the run's device), as the
other convergence phases do; ``--designs jax`` starts from the JAX package's test designs
that the smoke embeds (``VLMOP2_DESIGNS``, seeds 0 to 4). ``--no-kernel`` raises the
fused path's row threshold so that every prediction takes the exact path. Prints one JSON
line per run and one with the count. Runs on the card by default, float32.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (
        MULTI_OBJECTIVE_NOISE,
        VLMOP2_DESIGNS,
        log_hv_difference,
        stacked_model,
        vlmop2_rules,
    )
    from trieste_tpu_torch import BayesianOptimizer
    from trieste_tpu_torch.objectives import VLMOP2, mk_observer
    from trieste_tpu_torch.ops import fused_predict as fp

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rule", choices=("EHVI", "qEHVI", "HIPPO"), default="EHVI")
    parser.add_argument("--seeds", type=int, nargs=2, default=(0, 5))
    parser.add_argument("--designs", choices=("generator", "jax"), default="generator")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--design-device", default=None)
    parser.add_argument("--no-kernel", action="store_true")
    args = parser.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.no_kernel:
        fp.MIN_POINTS = 2**62
    _, make_rule, _, steps, envelope = next(r for r in vlmop2_rules() if r[0] == args.rule)
    space = VLMOP2.search_space.to(dev)
    observer = mk_observer(VLMOP2.objective)
    met = 0
    for seed in range(*args.seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        if args.designs == "jax":
            design = torch.tensor(VLMOP2_DESIGNS[seed], device=dev).reshape(10, 2)
        elif args.design_device in (None, args.device):
            design = space.sample(gen, 10)  # the run's own generator, as the other phases'
        else:
            design_dev = torch.device(args.design_device)
            design = space.to(design_dev).sample(
                torch.Generator(device=design_dev).manual_seed(seed), 10).to(dev)
        initial = observer(design)
        model = stacked_model(initial, space, likelihood_variance=MULTI_OBJECTIVE_NOISE)
        t0 = time.perf_counter()
        result = BayesianOptimizer(observer, space).optimize(
            steps, initial, model, make_rule(), generator=gen, track_state=False)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        diff = log_hv_difference(result.try_get_final_dataset().trimmed_observations, VLMOP2, dev)
        met += diff < envelope
        print(json.dumps({"rule": args.rule, "designs": args.designs, "seed": seed,
                          "device": str(dev), "kernel": not args.no_kernel,
                          "log_hv_difference": diff, "envelope": envelope,
                          "s_per_step": (time.perf_counter() - t0) / steps}), flush=True)
    print(json.dumps({"rule": args.rule, "designs": args.designs, "met": met,
                      "runs": args.seeds[1] - args.seeds[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

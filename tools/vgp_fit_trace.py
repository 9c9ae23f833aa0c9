#!/usr/bin/env python3
"""Trace the VGP classifier's fit alternation by alternation: the natural-gradient steps
taken, the ELBO after them and after the hyperparameter run, and the hyperparameters.

    python3 tools/vgp_fit_trace.py --n 1000 --dtype float32 float64
    python3 tools/vgp_fit_trace.py --n 200 --device cpu

The data is phase 23's of ``chip_smoke.py``: ``n`` points of [-1, 1]² from a generator
seeded 23 on the device, labelled ``sum(x²) > 0.5``, and ``build_vgp_classifier``. Each
alternation runs as ``fit_vgp`` runs it (five natural-gradient steps of 0.5, then 25
L-BFGS iterations on the log hyperparameters from where the last run ended). Prints one
JSON line per alternation.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=1000)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", nargs="+", default=["float32"], choices=["float32", "float64"])
    parser.add_argument("--alternations", type=int, default=10)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from chip_smoke import circle_observer
    from trieste_tpu_torch.models.gp import build_vgp_classifier
    from trieste_tpu_torch.models.gp import vgp as V
    from trieste_tpu_torch.models.gp.priors import log_prior_density
    from trieste_tpu_torch.ops.lbfgs import minimize_lbfgs
    from trieste_tpu_torch.space import Box

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.device.startswith("cuda"):
        print(torch.cuda.get_device_name(0))
    for name in args.dtype:
        dtype = getattr(torch, name)
        space = Box([-1.0, -1.0], [1.0, 1.0], dtype=dtype, device=args.device)
        data = circle_observer(space.sample(torch.Generator(device=args.device).manual_seed(23), args.n))
        model = build_vgp_classifier(data, space)
        X, Y, mask = data.query_points, data.observations, data.mask
        p, priors = model.params, model._priors
        u = V._hyper_pack(p, False)
        for alternation in range(args.alternations):
            taken = []
            for _ in range(5):
                p, ok = V.natural_gradient_step_with_status(p, X, Y, mask, 0.5)
                taken.append(bool(ok))
            elbo = float(V.vgp_elbo(p, X, Y, mask))

            def loss_fn(v, p=p):  # [k, n] -> [k], row by row
                def loss(row):
                    pv = V._hyper_unpack(row, p, False)
                    return -V.vgp_elbo(pv, X, Y, mask) - log_prior_density(pv.kernel, priors)

                return torch.stack([loss(row) for row in v])

            res = minimize_lbfgs(loss_fn, u[None], max_iters=25)
            finite = bool(torch.isfinite(res.fun[0]))
            if finite:
                u = res.x[0].detach()
                p = V._hyper_unpack(u, p, False)
            print(json.dumps({
                "dtype": name, "n": args.n, "alternation": alternation,
                "natural_gradient_steps_taken": sum(taken),
                "elbo_after_natural_gradient": elbo,
                "hyper_run_finite": finite,
                "elbo_after_hyper": float(V.vgp_elbo(p, X, Y, mask)),
                "kernel_variance": float(p.kernel.variance),
                "lengthscales": p.kernel.lengthscales.tolist(),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

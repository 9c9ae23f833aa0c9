#!/usr/bin/env python3
"""How far the deep GP's fit in fp32 stands from the same fit in fp64 on the card, from the
start on: the reading behind ``DGP_GRADIENT_ATOL`` in ``tests/test_torch_cuda.py``.

    python3 tools/deep_fp32_gap.py

The start and the data are the card test's: a two-layer deep GP with 16 inducing points
built in fp64 on 30 points at capacity 32 in 2-D (generators seeded 0 and 1) and cast to
fp32, 8 paths a step from fp64 noise seeded 3. It prints, for every parameter that the fit
trains, the largest gap between the fp32 and the fp64 gradient of the negative ELBO at the
start as a share of the largest fp64 element, and the number of elements whose signs
differ; then, after 1, 2, 5 and 10 Adam steps, the largest gap in a parameter and in the
mean of 16 paths at 64 points, and the deep ensemble's largest gap in its predicted mean
after 1 and 10 steps. Needs a CUDA device.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("variance", "lengthscales", "inducing_points", "q_mu", "q_sqrt")


def main() -> int:
    if not torch.cuda.is_available():
        print("deep_fp32_gap: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import test_torch_cuda as cards
    from trieste_tpu_torch.models.deepgp import deep_gp as dg
    from trieste_tpu_torch.models.ensembles import deep_ensemble as de

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
    grad32, grad64 = cards._dgp_gradient(dev, torch.float32), cards._dgp_gradient(dev, torch.float64)
    scale = max(float(g.abs().max()) for g in grad64)
    names = [f"layer {i} {n}" for i in range(len(grad64) // 5) for n in NAMES]
    for name, a, b in zip(names + ["noise_variance", "mean_constant"], grad32, grad64):
        gap = float((a.double() - b).abs().max()) / scale
        flips = int((a.double() * b < 0).sum())
        print(f"gradient at the start, {name}: largest fp64 element {float(b.abs().max()):.3e}, "
              f"gap {gap:.3e} of the largest over all, {flips} signs differ")

    def leaves(p):
        return [t for l in p.layers for t in (l.kernel.variance, l.kernel.lengthscales,
                                              l.inducing_points, l.q_mu, torch.tril(l.q_sqrt))]

    x = torch.rand(64, 2, generator=torch.Generator(device=dev).manual_seed(5),
                   dtype=torch.float64, device=dev)
    for steps in (1, 2, 5, 10):
        (r32, noise), (r64, _) = cards._dgp_fit(dev, torch.float32, steps), cards._dgp_fit(dev, torch.float64, steps)
        param_gap = max(float((a.double() - b).abs().max()) for a, b in zip(leaves(r32.params), leaves(r64.params)))
        mean32 = dg.dgp_propagate_from_noise(r32.params, x.float(), noise.float()).double().mean(0)
        mean64 = dg.dgp_propagate_from_noise(r64.params, x, noise).mean(0)
        print(f"deep GP after {steps} step{'s' * (steps > 1)}: largest parameter gap {param_gap:.3e}, largest gap "
              f"in the mean of 16 paths {float((mean32 - mean64).abs().max()):.3e}")
    for steps in (1, 10):
        r32, r64 = cards._ensemble_fit(dev, torch.float32, steps), cards._ensemble_fit(dev, torch.float64, steps)
        gap = (de.ensemble_predict(r32.params, x.float())[0].double() - de.ensemble_predict(r64.params, x)[0])
        print(f"deep ensemble after {steps} step{'s' * (steps > 1)}: largest gap in the mean {float(gap.abs().max()):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

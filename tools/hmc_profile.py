#!/usr/bin/env python3
"""Time one gradient evaluation of the fully-Bayesian GP's log posterior, as an HMC
transition makes it, eagerly and replayed from a CUDA graph, and show the device time by
operator.

    python3 tools/hmc_profile.py

Two shapes, those of ``chip_smoke.py`` phases 26 and 27: 20 points at capacity 32 in 2-D
with 3 chains, and 1000 points at capacity 1024 in 6-D with 4 chains (data from a
generator seeded 0 on the card, ``build_gpr_mcmc``'s prior). For each: the host-clock
milliseconds per evaluation over 50 eager calls after warm-up, the ``torch.profiler``
table of 10 calls, and the milliseconds per replay of a CUDA graph of one evaluation with
its largest difference from the eager result. Needs a CUDA device.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
REPS = 50


def main() -> int:
    if not torch.cuda.is_available():
        print("hmc_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from trieste_tpu_torch.data import Dataset
    from trieste_tpu_torch.models.gp import build_gpr_mcmc, mcmc
    from trieste_tpu_torch.models.gp.training import pack_params
    from trieste_tpu_torch.ops import hmc
    from trieste_tpu_torch.space import Box

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for n, capacity, chains, D in ((20, 32, 3, 2), (1000, 1024, 4, 6)):
        g = torch.Generator(device=dev).manual_seed(0)
        X = torch.rand(n, D, generator=g, device=dev)
        Y = torch.sin(5 * X[:, :1]) + X[:, 1:].sum(-1, keepdim=True)
        data = Dataset.from_arrays(X, Y, capacity=capacity)
        template = build_gpr_mcmc(data, Box([0.0] * D, [1.0] * D, device=dev)).params_stack
        template = mcmc._select(template, 0)
        u0 = pack_params(template)

        def log_prob(u):
            return mcmc._log_posterior(u, u0, template, data.query_points, data.observations,
                                       data.mask, mcmc.PRIOR_SCALE)

        q = u0[None].repeat(chains, 1) + 0.1 * torch.randn(chains, u0.shape[0], generator=g, device=dev)
        for _ in range(5):
            hmc._log_density_and_grad(log_prob, q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            eager = hmc._log_density_and_grad(log_prob, q)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / REPS * 1e3
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(10):
                hmc._log_density_and_grad(log_prob, q)
            torch.cuda.synchronize()
        averages = prof.key_averages()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.device_time_total for e in kernels) / 10 / 1e3
        print(f"capacity {capacity}, {chains} chains: {eager_ms:.3f} ms per evaluation eagerly "
              f"(host clock); under the profiler {device_ms:.3f} ms of kernel time and "
              f"{len(kernels) / 10:.0f} kernels per evaluation")
        print(averages.table(sort_by="self_cuda_time_total", row_limit=12, max_name_column_width=60))

        static_q = q.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                hmc._log_density_and_grad(log_prob, static_q)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_lp, static_grad = hmc._log_density_and_grad(log_prob, static_q)
        graph.replay()
        torch.cuda.synchronize()
        diff = max(float((static_lp - eager[0]).abs().max()), float((static_grad - eager[1]).abs().max()))
        t0 = time.perf_counter()
        for _ in range(REPS):
            static_q.copy_(q)
            graph.replay()
        torch.cuda.synchronize()
        graph_ms = (time.perf_counter() - t0) / REPS * 1e3
        print(f"capacity {capacity}: {graph_ms:.3f} ms per evaluation replayed from a CUDA graph "
              f"(largest difference from the eager result {diff:.3e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

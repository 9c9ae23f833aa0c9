#!/usr/bin/env python3
"""Time one Adam step of the deep models' fits, eagerly and replayed from a CUDA graph, and
show the device time by operator.

    python3 tools/deep_models_profile.py

Four shapes, those of ``chip_smoke.py`` phases 29 and 30: the deep GP (2 layers, 8 paths
a step) at capacity 32 in 2-D with 40 inducing points and at capacity 1024 in 6-D with
100, and the deep ensemble (5 members of (25, 25)) at capacity 32 and 1024 (data from a
generator seeded 0 on the card, fp32). For each, eagerly and from the graph: the
milliseconds per step of steps 10 to 509 of a fit of 520 steps (after the graph's capture),
timed between two CUDA events, each recorded after a synchronize, and on the host clock at
the same two points, as the median and the range of three fits; and the
``torch.profiler`` table of an eager fit of 20 steps with its kernel time and kernel count
per step. Needs a CUDA device.
"""
from __future__ import annotations

import statistics
import sys
import time
from functools import partial
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


FIRST, STEPS = 10, 500


def _marking(adam_minimize, marks):
    """``adam_minimize`` that, before steps ``FIRST`` and ``FIRST + STEPS``, waits for the
    card and appends the host clock and a CUDA event recorded there to ``marks``."""

    def run(leaves, loss_fn, num_steps, learning_rate, before_step=None):
        def before(t):
            if before_step is not None:
                before_step(t)
            if t in (FIRST, FIRST + STEPS):
                torch.cuda.synchronize()
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                marks.append((time.perf_counter(), event))

        return adam_minimize(leaves, loss_fn, num_steps, learning_rate, before)

    return run


def _spread(values):
    return f"{statistics.median(values):.4f} [{min(values):.4f}, {max(values):.4f}]"


def main() -> int:
    if not torch.cuda.is_available():
        print("deep_models_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from trieste_tpu_torch.data import Dataset
    from trieste_tpu_torch.models.deepgp import build_vanilla_deep_gp, deep_gp
    from trieste_tpu_torch.models.ensembles import build_deep_ensemble, deep_ensemble
    from trieste_tpu_torch.ops import adam
    from trieste_tpu_torch.space import Box

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    graphed_runner = adam._step_runner
    marks = []
    for module in (deep_gp, deep_ensemble):
        module.adam_minimize = _marking(adam.adam_minimize, marks)
    eager_runner = (lambda leaves, optimizer, loss_fn, nonfinite:
                    partial(adam._step, loss_fn, optimizer, nonfinite))
    for capacity, D in ((32, 2), (1024, 6)):
        g = torch.Generator(device=dev).manual_seed(0)
        X = torch.rand(capacity - capacity // 32, D, generator=g, device=dev)
        data = Dataset.from_arrays(X, torch.sin(5 * X[:, :1]) + X[:, 1:].sum(-1, keepdim=True),
                                   capacity=capacity)
        space = Box([0.0] * D, [1.0] * D, device=dev)
        dgp = build_vanilla_deep_gp(data, space, generator=torch.Generator(device=dev).manual_seed(1))
        ensemble = build_deep_ensemble(data, generator=torch.Generator(device=dev).manual_seed(1))

        def fit_dgp(steps):
            return deep_gp.fit_dgp(g, dgp.params, data.query_points, data.observations, data.mask,
                                   num_steps=steps)

        def fit_ensemble(steps):
            return deep_ensemble.fit_deep_ensemble(g, ensemble.params, data.query_points,
                                                   data.observations, data.mask, num_steps=steps)

        M = dgp.params.layers[0].inducing_points.shape[0]
        for name, fit in ((f"deep GP (M = {M})", fit_dgp), ("deep ensemble (E = 5)", fit_ensemble)):
            line = []
            for label, runner in (("eager", eager_runner), ("graph", graphed_runner)):
                adam._step_runner = runner
                fit(20)  # warm-up
                device_ms, host_ms = [], []
                for _ in range(3):
                    marks.clear()
                    fit(FIRST + STEPS + 10)
                    (h0, e0), (h1, e1) = marks
                    device_ms.append(e0.elapsed_time(e1) / STEPS)
                    host_ms.append((h1 - h0) * 1e3 / STEPS)
                line.append(f"{label} {_spread(device_ms)} ms per step between events "
                            f"({_spread(host_ms)} on the host clock)")
            adam._step_runner = eager_runner
            with torch.profiler.profile(activities=activities) as prof:
                fit(20)
                torch.cuda.synchronize()
            adam._step_runner = graphed_runner
            kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.name.startswith("Optimizer.")]  # Adam's range is no kernel
            device_ms = sum(e.device_time_total for e in kernels) / 20 / 1e3
            print(f"{name}, capacity {capacity}, D = {D}: {', '.join(line)}; under "
                  f"the profiler {device_ms:.3f} ms of kernel time and {len(kernels) / 20:.0f} "
                  f"kernels per eager step")
            print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=10,
                                            max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())

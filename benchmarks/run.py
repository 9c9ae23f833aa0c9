"""The benchmark of ``trieste_tpu_torch`` on one NVIDIA H100: seconds per BO step of a
closed Ask/Tell loop, for the cells of ``BENCHMARK.json``.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It sets up the cell, takes one warm-up step, runs the window for ``--seconds``
(whole steps), then judges every step against the plain reference and prints the result
as the last line of standard output, after the compared numbers and their limits on
standard error. ``--trace 1`` prints the per-layer metrics from spans and a profile of
two more steps. It refuses to run without a CUDA device: there is no CPU fallback.
"""
import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def process_age() -> float:
    """Seconds since this process started, from ``/proc`` (0 where it cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    started = PROCESS_START - process_age()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    # caches of the program's toolchain stay at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / "benchmark_cache" / sub))

    import torch

    from benchmarks.harness import check, loop, report, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), found {count}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    run = loop.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, started, log=log)
    launches = run.counters["launches_per_step"]
    log(f"steps {len(run.steps)} in the window ({run.window_s:.3f} s), "
        f"{len(run.profiled)} profiled, episodes {run.counters['episodes']}; "
        f"fused-kernel launches per step {launches}; "
        f"compile cache {run.counters['compile_cache']}")
    log(f"step seconds {[round(s.seconds, 4) for s in run.all_steps]}")
    if run.profile is not None:
        log(f"profile: {run.profile.device_events} device events, busy "
            f"{run.profile.busy_s!r} s of {run.profile.window_s!r} s, reduced in "
            f"{run.profile.reduce_s:.3f} s")
    t0 = time.perf_counter()
    verdict = check.judge(run, cell.limits)
    log(f"reference check of {verdict.checked_steps} steps in {time.perf_counter() - t0:.3f} s")
    for step, why in verdict.failed_steps:
        log(f"step {step} failed: {why}")
    line = report.result(run, verdict)
    leaked = report.forbidden_modules()
    if leaked:
        print(f"benchmark: the process loaded {leaked}", file=sys.stderr)
        return 3
    for text in verdict.lines():
        log(text)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

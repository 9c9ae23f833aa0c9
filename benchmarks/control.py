"""The readings that the limits of ``benchmarks/limits/<cell>.json`` are set from: for
each seed, one run of the cell as ``run.py`` makes it (set-up, warm-up, a window of
``--seconds``), then the three compared numbers of the program, and of the control, the
reference put in the program's place in TF32 (``benchmarks.harness.check.control_numbers``).
One process, one JSON line a seed on standard output. The benchmark's own runs never run
the control.

    python3 benchmarks/control.py --workload <cell> --seeds 11 12 13 --seconds 45
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmarks.harness import check, loop, spec

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        start = time.perf_counter()
        run = loop.run_cell(cell, seed, args.seconds, False, device, start,
                            log=lambda s: print(s, file=sys.stderr))
        verdict = check.judge(run, cell.limits)
        control = check.control_numbers(run)
        print(json.dumps({
            "workload": cell.name, "seed": seed, "steps": len(run.steps),
            "step_s": run.window_s / len(run.steps), "setup_s": run.setup_s,
            "failed": verdict.failed_steps, "program": verdict.numbers, "control": control,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

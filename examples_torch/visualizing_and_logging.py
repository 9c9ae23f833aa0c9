"""Monitoring a run: summary logging and regret plotting, on the port.

Counterpart of ``examples/visualizing_and_logging.py`` for ``trieste_tpu_torch``
(reference tutorial ``docs/notebooks/visualizing_with_tensorboard.pct.py``): attach a
summary writer (here the dependency-free JSON-lines writer; drop
``prefer_tensorboard=False`` for TensorBoard event files where ``tensorboard`` is
installed) and the loop records per-step wall-clocks, model diagnostics, and observation
statistics; then plot the regret curve from the tracked history if matplotlib is there.

Run: ``python examples_torch/visualizing_and_logging.py [num_steps] [--device cpu]``
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import trieste_tpu_torch as tt
from trieste_tpu_torch.logging import make_summary_writer, set_tensorboard_writer
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.objectives import ScaledBranin, mk_observer


def main(num_steps: int = 8, *, device: Optional[str] = None) -> dict:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    dtype = torch.float32 if dev.type == "cuda" else torch.float64

    logdir = Path(tempfile.mkdtemp(prefix="trieste_tpu_torch_logs_"))
    set_tensorboard_writer(make_summary_writer(str(logdir), prefer_tensorboard=False))
    print(f"summaries -> {logdir}")

    problem = ScaledBranin
    observer = mk_observer(problem.objective)
    space = problem.search_space.to(dev, dtype)
    generator = torch.Generator(device=dev).manual_seed(0)
    initial_data = observer(space.sample(generator, 5))
    model = build_gpr(
        initial_data, space, likelihood_variance=1e-7, trainable_likelihood=False
    )
    try:
        result = tt.BayesianOptimizer(observer, space).optimize(
            num_steps, initial_data, model, generator=generator, track_state=True
        )
    finally:
        set_tensorboard_writer(None)

    # regret curve from the tracked history
    best_so_far = [float(record.dataset.trimmed_observations.min())
                   for record in result.history]
    best_so_far.append(float(result.try_get_final_dataset().trimmed_observations.min()))
    regret = [b - float(problem.minimum[0]) for b in best_so_far]
    print("regret per step:", " ".join(f"{r:.4f}" for r in regret))

    logged = sorted(p.name for p in logdir.glob("*"))
    print(f"log files written: {logged}")

    plot_written = False
    try:  # optional: save a regret plot if matplotlib is present
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(5, 3))
        ax.plot(regret, marker="o")
        ax.set_xlabel("step")
        ax.set_ylabel("regret")
        ax.set_yscale("log")
        fig.tight_layout()
        fig.savefig(logdir / "regret.png", dpi=120)
        plt.close(fig)
        plot_written = True
        print(f"regret plot -> {logdir / 'regret.png'}")
    except ImportError:
        print("regret plot: matplotlib is not installed, no plot written")
    return {"regret": regret, "log_files": logged, "plot_written": plot_written}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("num_steps", type=int, nargs="?", default=8)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(args.num_steps, device=args.device)

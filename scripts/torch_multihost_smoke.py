"""Two-process smoke test of the port's pool mesh on ``torch.distributed``.

The counterpart of ``scripts/multihost_smoke.py`` for ``trieste_tpu_torch``: the parent
spawns two CPU worker processes; each joins one gloo process group through
``trieste_tpu_torch.parallel.initialize_multi_host`` (rank 0 listens at
``TRIESTE_TPU_COORD``, default ``localhost:12357``), builds the pool mesh over both ranks
with ``create_multi_host_mesh`` and runs ``fit_gpr`` with 16 restarts sharded over it,
eight a rank. The parent checks that both ranks report the same loss and that it equals
the loss of the same fit in one process, and prints ``MULTIHOST SMOKE PASSED``. Each worker
also checks that it never imported JAX.

Usage: ``python scripts/torch_multihost_smoke.py`` (the parent; it starts the workers).
"""
from __future__ import annotations

import os
import subprocess
import sys

COORD = os.environ.get("TRIESTE_TPU_COORD", "localhost:12357")
NPROC = 2
NUM_STARTS = 16
TIMEOUT = 420


def fit(pool_sharding=None):
    """The smoke's fit: 16 restarts on 16 points of a quadratic, in float64 on the CPU."""
    import torch

    from trieste_tpu_torch.data import Dataset
    from trieste_tpu_torch.models.gp import default_gpr_params, fit_gpr
    from trieste_tpu_torch.space import Box

    g = torch.Generator().manual_seed(0)
    X = torch.rand(16, 2, generator=g, dtype=torch.float64)
    ds = Dataset.from_arrays(X, torch.sum(torch.square(X - 0.4), -1, keepdim=True))
    space = Box([0.0, 0.0], [1.0, 1.0], dtype=torch.float64, device="cpu")
    params = default_gpr_params(ds, space)
    result = fit_gpr(g, params, ds.query_points, ds.observations, ds.mask,
                     num_starts=NUM_STARTS, max_iters=40, pool_sharding=pool_sharding)
    return float(result.loss)


def worker(process_id: int) -> None:
    import torch
    import torch.distributed as dist

    from trieste_tpu_torch.parallel import (
        create_multi_host_mesh, initialize_multi_host, pool_sharding,
    )

    torch.set_num_threads(1)
    initialize_multi_host(COORD, NPROC, process_id, device="cpu")
    try:
        mesh = create_multi_host_mesh()
        assert mesh.size == NPROC and mesh.rank == process_id, mesh
        loss = fit(pool_sharding(mesh))
    finally:
        dist.destroy_process_group()
    if "jax" in sys.modules:
        raise SystemExit("MULTIHOST worker imported jax")
    print(f"MULTIHOST_OK process={process_id} loss={loss!r}", flush=True)


def parent() -> int:
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen([sys.executable, __file__, str(pid)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env)
        for pid in range(NPROC)
    ]
    try:
        outputs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    losses = []
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        found = [float(line.rsplit("=", 1)[1]) for line in out.splitlines()
                 if line.startswith("MULTIHOST_OK")]
        losses += found
        if p.returncode != 0 or not found:
            print(f"--- worker {pid} (exit {p.returncode}) output ---\n{out}")
    sys.path.insert(0, repo)
    single = fit()
    if (len(losses) == NPROC and abs(losses[0] - losses[1]) < 1e-9
            and abs(losses[0] - single) < 1e-9):
        print(f"MULTIHOST SMOKE PASSED: both processes agree with one process, "
              f"loss={losses[0]!r} (one process {single!r})")
        return 0
    print(f"MULTIHOST SMOKE FAILED: losses={losses}, one process {single!r}")
    return 1


if __name__ == "__main__":
    if len(sys.argv) > 1:
        worker(int(sys.argv[1]))
    else:
        sys.exit(parent())

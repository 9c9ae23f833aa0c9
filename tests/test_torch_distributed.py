"""The port's multi-process scripts under the suite, as ``tests/integration/test_distributed.py``
runs the JAX package's: the two-process ``torch.distributed`` smoke of the pool mesh
(``scripts/torch_multihost_smoke.py``) and asynchronous Ask/Tell across worker processes
(``scripts/torch_async_multiprocessing_demo.py``), each in a subprocess. They skip only
where the environment cannot open a socket or a semaphore.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(script: str, *args: str, env: dict | None = None, timeout: int = 420):
    full_env = dict(os.environ)
    full_env["PYTHONPATH"] = str(REPO) + os.pathsep + full_env.get("PYTHONPATH", "")
    full_env["OMP_NUM_THREADS"] = "1"
    full_env.update(env or {})
    return subprocess.run(
        [sys.executable, str(REPO / "scripts" / script), *args],
        capture_output=True, text=True, timeout=timeout, env=full_env, cwd=REPO,
    )


def test_torch_multihost_smoke_two_processes():
    """Both ranks join one gloo group, shard fit_gpr's 16 restarts over the mesh and
    agree with each other and with one process on the loss."""
    try:
        port = _free_port()
    except OSError as exc:  # pragma: no cover - a sandbox without sockets
        pytest.skip(f"cannot allocate a coordinator port: {exc}")
    proc = _run("torch_multihost_smoke.py", env={"TRIESTE_TPU_COORD": f"localhost:{port}"})
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    assert "MULTIHOST SMOKE PASSED" in out


def test_torch_async_multiprocessing_ask_tell():
    """Two worker processes with random latency, tells as they arrive, and a run that
    improves on its initial design."""
    try:
        import multiprocessing

        multiprocessing.Semaphore(1)
    except (ImportError, OSError, PermissionError) as exc:  # pragma: no cover
        pytest.skip(f"multiprocessing unsupported here: {exc}")
    proc = _run("torch_async_multiprocessing_demo.py", "2", "4", "--device", "cpu")
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    assert "ASYNC DEMO DONE" in out

"""The pool mesh on ``torch.distributed`` (counterpart of :mod:`trieste_tpu.parallel.mesh`).

A single named axis ``"pool"`` is the data-parallel axis of Bayesian optimization: every
expensive stage is embarrassingly parallel over a pool (candidate points, L-BFGS starts,
hyperparameter restarts, HMC chains, MC samples), and only small best-of reductions
cross devices.

Torch has no single-controller mesh and no GSPMD, so the port takes the multi-controller
model that JAX's multi-host runtime already uses: every rank runs the same BO program,
holds its own replica of the model, draws the same random numbers, scores its own
contiguous block of each pool and joins the others only for the best-of reductions
(:mod:`trieste_tpu_torch.parallel.collectives`). A mesh therefore spans the ranks of a
process group, one device per rank, and not the devices of one process. A mesh of one
rank takes the unsharded path and makes no collective call.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple, Union

import torch
import torch.distributed as dist

POOL_AXIS = "pool"

_ACTIVE_MESH: Optional["Mesh"] = None


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the ranks ``ranks`` of the default process group: ``group`` joins
    them (``None`` for a mesh of one rank, which needs no collective) and ``rank`` is this
    process's index in ``ranks`` (``None`` where it is not one of them). A rank's device is
    the one :func:`initialize_multi_host` bound to its process."""

    group: Optional[dist.ProcessGroup]
    ranks: Tuple[int, ...]
    rank: Optional[int]

    @property
    def size(self) -> int:
        """The number of ranks."""
        return len(self.ranks)


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    """Install ``mesh`` as the framework-wide pool mesh (``None`` disables sharding).

    While a mesh of more than one rank is active, every pool-shaped stage shards over it:
    the acquisition seed pool and the multi-start L-BFGS runs
    (:mod:`trieste_tpu_torch.acquisition.optimizer`), the GPR, SGPR and SVGP restarts,
    the HMC chains and the MC sample axis of a single-batch reparametrization sample.
    Every rank must install the same mesh and run the same program."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_global_mesh() -> Optional[Mesh]:
    """The currently active pool mesh, or ``None``."""
    return _ACTIVE_MESH


@contextlib.contextmanager
def global_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Context manager form of :func:`set_global_mesh`."""
    previous = _ACTIVE_MESH
    set_global_mesh(mesh)
    try:
        yield mesh
    finally:
        set_global_mesh(previous)


def sharding_mesh() -> Optional[Mesh]:
    """The active mesh where it splits a pool (more than one rank), else ``None``: the
    mesh every sharded stage reads. A mesh of one rank takes the unsharded path."""
    if _ACTIVE_MESH is None or _ACTIVE_MESH.size == 1:
        return None
    return _ACTIVE_MESH


# The JAX package's sharding descriptors. Each stage of the port splits the one pool axis
# it owns, so the descriptor of a split axis is the mesh itself and that of a replicated
# array is ``None``; a ``pool_sharding=`` argument takes either.


def pool_sharding(mesh: Mesh) -> Mesh:
    """Shard the leading axis over the pool: the mesh."""
    return mesh


def replicated(mesh: Mesh) -> None:
    """Every rank holds the whole array: nothing is split."""
    return None


def current_pool_sharding() -> Optional[Mesh]:
    """Leading-axis pool sharding for the active mesh (the mesh), or ``None`` without
    one."""
    return _ACTIVE_MESH


def current_axis_sharding(axis: int, ndim: int) -> Optional[Mesh]:
    """Pool sharding over axis ``axis`` of an ``ndim``-rank array (the active mesh; the
    stage splits the axis it names), or ``None`` without a mesh."""
    return _ACTIVE_MESH


def round_to_mesh(n: int) -> int:
    """Round a pool size up to a multiple of the active mesh size (identity without a
    mesh) so that sharded axes divide evenly across ranks."""
    if _ACTIVE_MESH is None:
        return n
    d = _ACTIVE_MESH.size
    return ((n + d - 1) // d) * d


def create_mesh(num_devices: Optional[int] = None) -> Mesh:
    """A 1-D mesh over the first ``num_devices`` ranks of the default process group (all
    of them by default); every rank of the group must call it, since it makes the mesh's
    group with ``dist.new_group`` (a mesh of one rank needs none). With no process group
    initialised it is the mesh of this one process.

    A mesh spans ranks, not the devices of one process, because the port runs one
    program per device (see the module's docstring)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if num_devices is None else num_devices
    if n > world:
        raise ValueError(f"requested {n} devices but only {world} available")
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    me = dist.get_rank() if dist.is_initialized() else 0
    ranks = tuple(range(n))
    group = dist.new_group(list(ranks)) if dist.is_initialized() and n > 1 else None
    return Mesh(group, ranks, me if me < n else None)


def initialize_multi_host(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: Union[str, torch.device, None] = None,
) -> None:
    """Join this process, rank ``process_id`` of ``num_processes``, to the default
    process group at ``coordinator_address`` (``host:port``, rank 0 listens there). Then
    build the pool mesh with :func:`create_multi_host_mesh`.

    A rank is one device: ``device``, by default ``cuda:{LOCAL_RANK}`` (the process id
    where the launcher sets no ``LOCAL_RANK``); pass ``"cpu"`` to run on the CPU. A CUDA
    device becomes the process's current device, so ``"cuda"`` names the rank's own card.
    ``local_device_count`` keeps the JAX signature's place and takes only ``None`` or 1.
    The backend is NCCL for a CUDA device and gloo for the CPU, unless ``backend`` names
    one; nothing switches from one to the other on its own."""
    if local_device_count not in (None, 1):
        raise ValueError(
            f"a rank drives one device; local_device_count={local_device_count} is not "
            "supported (start one process per device)"
        )
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", process_id)))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id,
    )


def create_multi_host_mesh() -> Mesh:
    """A 1-D pool mesh over every rank of the default process group, in rank order: a
    pool axis gives each rank one contiguous block, and the best-of reductions are the
    only traffic between ranks."""
    return create_mesh()

"""What crosses ranks: each rank's block of a pool, the all-gather of its rows and the
best-of reductions every sharded stage ends with.

Every rank draws a whole pool from the same generator and keeps its block
(:func:`local_slice`), so a sharded run sees the numbers of the unsharded one. The pool
itself never crosses ranks: only each rank's best values with their payload rows do
(:func:`sharded_best`), or a stage's small outputs (:func:`gather_rows`). A gradient
through a sharded stage is summed over the ranks where the stage's inputs come in
(:func:`replicated_inputs`). Under gloo, which gathers no CUDA tensor, the operands go
through host copies; under NCCL they stay on the device. A collective that fails raises.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh

collective_calls = 0
"""Collectives (all-gathers and the gradients' all-reduces) made here in this process."""

bytes_received = 0
"""Bytes those collectives brought to this rank: ``size - 1`` times each operand's bytes,
what a rank receives when each other rank sends it one block."""


def _rank_of(mesh: Mesh) -> int:
    if mesh.rank is None:
        raise ValueError(f"this process is not one of the mesh's ranks {mesh.ranks}")
    return mesh.rank


def local_slice(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous block of ``n`` rows, in rank order; ``n`` is a multiple of
    the mesh size (:func:`~trieste_tpu_torch.parallel.round_to_mesh` rounds it so)."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} ranks")
    per = n // mesh.size
    r = _rank_of(mesh)
    return slice(r * per, (r + 1) * per)


def _staged(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The operand a collective takes: a host copy of a CUDA tensor under gloo."""
    global collective_calls, bytes_received
    collective_calls += 1
    bytes_received += (mesh.size - 1) * t.numel() * t.element_size()
    if t.is_cuda and dist.get_backend(mesh.group) == dist.Backend.GLOO:
        return t.cpu()
    return t.contiguous()


def _all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    src = _staged(t, mesh)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def _all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    src = _staged(t, mesh).clone()
    dist.all_reduce(src, group=mesh.group)
    return src.to(t.device)


class _GatherRows(torch.autograd.Function):
    """All-gather along dimension 0. Every rank computes the same function of the
    gathered tensor, so the gradient with respect to this rank's rows is its block of the
    output's gradient, and the backward needs no collective.
    (``torch.distributed.nn.functional.all_gather`` sums the output gradients of every
    rank instead, which counts a replicated downstream ``size`` times.)"""

    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.block = slice(_rank_of(mesh) * t.shape[0], (_rank_of(mesh) + 1) * t.shape[0])
        return _all_gather(t.detach(), mesh)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad[ctx.block], None


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[n, ...]`` on each rank → ``[size·n, ...]``, the ranks' blocks in rank order,
    on every rank; differentiable."""
    return _GatherRows.apply(t, mesh)


class _SumGradients(torch.autograd.Function):
    """The identity; its backward sums each gradient over the ranks."""

    @staticmethod
    def forward(ctx, mesh: Mesh, *tensors: torch.Tensor):
        ctx.mesh = mesh
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        return (None,) + tuple(
            None if g is None else _all_reduce_sum(g, ctx.mesh) for g in grads
        )


def replicated_inputs(mesh: Mesh, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Pass ``tensors``, the same on every rank, into a stage that each rank computes on
    its block and :func:`gather_rows` joins: the identity forward, while the backward sums
    their gradients over the ranks, since each rank's holds only what flowed through its
    block. Every rank must then run the backward too."""
    return _SumGradients.apply(mesh, *tensors)


def _best_rows(
    values: torch.Tensor, payload: torch.Tensor, k: int, largest: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best rows of ``values [n, ...]`` per trailing position, ties to the lower
    row, with the matching rows of ``payload [n, ..., *F]``."""
    order = torch.sort(values, dim=0, descending=largest, stable=True).indices[:k]
    index = order.reshape(order.shape + (1,) * (payload.ndim - values.ndim))
    return (
        torch.gather(values, 0, order),
        torch.gather(payload, 0, index.expand(order.shape + payload.shape[values.ndim:])),
    )


def sharded_best(
    values: torch.Tensor,
    payload: torch.Tensor,
    mesh: Mesh,
    *,
    k: int = 1,
    largest: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best of the whole pool from this rank's block: ``values [n, ...]`` and
    ``payload [n, ..., *F]`` → ``([k, ...], [k, ..., *F])``, the same on every rank.

    Each rank takes its own ``min(k, n)`` best rows; they are all-gathered with their
    payload, and the same sort runs on every rank. Ties go to the lower global row, as a
    first-occurrence argmax or argmin over the whole pool gives them."""
    kk = min(k, values.shape[0])
    local_vals, local_payload = _best_rows(values, payload, kk, largest)
    all_vals = gather_rows(local_vals, mesh)  # the ranks' blocks in rank order, each
    all_payload = gather_rows(local_payload, mesh)  # sorted with ties by row
    best_vals, best_payload = _best_rows(all_vals, all_payload, k, largest)
    return best_vals, best_payload

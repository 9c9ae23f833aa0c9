"""Adam over a fixed set of tensors, as the deep models' fits take it (counterpart of the
``optax.adam`` loops that the JAX package runs in one ``lax.scan``).

A step evaluates the loss of the tensors as they stand, back-propagates its sum and takes
PyTorch's Adam step, which is optax's (``b1`` 0.9, ``b2`` 0.999, ``eps`` 1e-8 outside the
square root). So the loss of step t is the one before step t's update, as in ``scan``.
A step reads nothing back from the device: the non-finite losses are counted on it.

On the card one step is captured once per fit as a CUDA graph and replayed: a step of the
deep models is some hundred small launches, which the host cannot issue as fast as the
card runs them. The optimizer's state then lives on the card (``capturable=True``). A
warm-up step on a side stream initializes it and what the capture records, and is undone
before the capture. The capture synchronizes once; the steps do not.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence, Tuple

import torch


def _step(
    loss_fn: Callable[[], torch.Tensor], optimizer: torch.optim.Adam, nonfinite: torch.Tensor
) -> torch.Tensor:
    """One Adam step on the sum of ``loss_fn()``: returns the loss before the update."""
    optimizer.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss = loss_fn()
        loss.sum().backward()
    optimizer.step()
    loss = loss.detach()
    nonfinite.add_(torch.count_nonzero(~torch.isfinite(loss)))
    return loss


def _step_runner(
    leaves: Sequence[torch.Tensor],
    optimizer: torch.optim.Adam,
    loss_fn: Callable[[], torch.Tensor],
    nonfinite: torch.Tensor,
) -> Callable[[], torch.Tensor]:
    """A function that takes one step and returns its loss. On the card it replays a CUDA
    graph of the step, captured here once; the loss it returns is the graph's output
    buffer, overwritten by the next replay."""
    step = partial(_step, loss_fn, optimizer, nonfinite)
    if not leaves[0].is_cuda:
        return step
    with torch.cuda.device(leaves[0].device):
        saved = [t.detach().clone() for t in leaves]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # initializes Adam's state and what the capture records
            step()
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():  # undo the warm-up step
            for t, s in zip(leaves, saved):
                t.copy_(s)
            for state in optimizer.state.values():
                for value in state.values():
                    value.zero_()
            nonfinite.zero_()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_loss = step()

    def replay() -> torch.Tensor:
        graph.replay()
        return static_loss

    return replay


def adam_minimize(
    leaves: Sequence[torch.Tensor],
    loss_fn: Callable[[], torch.Tensor],
    num_steps: int,
    learning_rate: float,
    before_step: Optional[Callable[[int], None]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``num_steps`` Adam steps on ``leaves`` (tensors that require grad, updated in place)
    on the sum of ``loss_fn()``. ``before_step(t)``, where given, runs before step t and
    outside any graph: it refreshes in place the inputs that ``loss_fn`` reads. Returns the
    last step's loss (the shape of ``loss_fn()``'s) and the number of loss elements that
    were not finite over all steps (an int64 tensor)."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be at least 1, got {num_steps}")
    on_card = leaves[0].is_cuda
    optimizer = torch.optim.Adam(
        leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, capturable=on_card
    )
    nonfinite = torch.zeros((), dtype=torch.int64, device=leaves[0].device)
    if before_step is not None:  # the warm-up of the capture reads the first step's inputs
        before_step(0)
    step = _step_runner(leaves, optimizer, loss_fn, nonfinite)
    for t in range(num_steps):
        if before_step is not None and t:
            before_step(t)
        loss = step()
    return loss.clone(), nonfinite

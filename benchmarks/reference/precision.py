"""The precisions the plain references compute in, shared by every family and rule:

- ``Precision(torch.float64)``, the reference;
- ``Precision(torch.float32, tf32=True)``, the control: every matrix product rounds its
  operands to TF32 (10 explicit mantissa bits), as a tensor core does with TF32 on. The
  rounding is done here, so the CPU tests see the same control as the card.

Only ``torch`` is imported: nothing of the program under test.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator

import torch


@dataclass(frozen=True)
class Precision:
    dtype: torch.dtype
    tf32: bool = False


FP64 = Precision(torch.float64)
TF32 = Precision(torch.float32, tf32=True)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: the nearest value with 10 explicit mantissa bits
    (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def _matmul_mode(prec: Precision) -> Iterator[None]:
    """Let the card's matrix products use TF32 under the control, and only there."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = prec.tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def matmul(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    if prec.tf32:
        a, b = tf32_round(a), tf32_round(b)
    with _matmul_mode(prec):
        return a @ b

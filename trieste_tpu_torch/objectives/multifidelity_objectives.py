"""Multifidelity test problems (counterpart of
:mod:`trieste_tpu.objectives.multifidelity_objectives`): the Forrester function with a
linearly varying fidelity, where higher fidelity indices move towards the exact function.

The problems' spaces live on ``cuda``. The fidelity search space is built when first read
(a discrete space holds its points on its device); ``fidelity_space`` builds it on another
device.

>>> x = torch.tensor([[0.75724875, 1.0]], dtype=torch.float64)
>>> round(float(linear_multifidelity(x)[0, 0]), 6)
-6.02074
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Union

import numpy as np
import torch

from ..space import Box, DiscreteSearchSpace, TaggedProductSearchSpace
from .single_objectives import SingleObjectiveTestProblem


@dataclass(frozen=True)
class SingleObjectiveMultifidelityTestProblem(SingleObjectiveTestProblem):
    num_fidelities: int = 2

    @functools.cached_property
    def fidelity_search_space(self) -> TaggedProductSearchSpace:
        """The input space × the fidelities, on the input space's device."""
        return fidelity_space(self.num_fidelities, self.search_space, self.search_space.device)


def linear_multifidelity(x: torch.Tensor) -> torch.Tensor:
    """The Forrester function with a linearly varying fidelity: the trailing input column
    is the fidelity index, 0 the coarsest. ``[..., 2] -> [..., 1]``."""
    x_input, x_fidelity = x[..., :-1], x[..., -1:]
    f = 0.5 * ((6.0 * x_input - 2.0) ** 2) * torch.sin(12.0 * x_input - 4.0) + 10.0 * (
        x_input - 1.0
    )
    return f + x_fidelity * (f - 20.0 * (x_input - 1.0))


def fidelity_space(
    n_fidelities: int, input_space: Box, device: Union[str, torch.device] = "cuda"
) -> TaggedProductSearchSpace:
    """``input_space`` × the fidelities ``0..n-1``, tagged ``input`` and ``fidelity``."""
    fidelities = DiscreteSearchSpace(
        np.arange(n_fidelities, dtype=float).reshape(-1, 1), dtype=input_space.dtype,
        device=device,
    )
    return TaggedProductSearchSpace([input_space.to(device), fidelities], ["input", "fidelity"])


_MINIMIZERS = {2: 0.75724875, 3: 0.76333767, 5: 0.76801846}
_MINIMA = {2: -6.020740055, 3: -6.634287061, 5: -7.933019704}


def _make_linear(n: int) -> SingleObjectiveMultifidelityTestProblem:
    return SingleObjectiveMultifidelityTestProblem(
        name=f"Linear {n} Fidelity",
        objective=linear_multifidelity,
        search_space=Box(np.zeros(1), np.ones(1)),
        minimizers=np.array([[_MINIMIZERS[n]]]),
        minimum=np.array([_MINIMA[n]]),
        num_fidelities=n,
    )


Linear2Fidelity = _make_linear(2)
Linear3Fidelity = _make_linear(3)
Linear5Fidelity = _make_linear(5)

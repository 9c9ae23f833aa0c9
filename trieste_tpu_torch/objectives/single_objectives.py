"""Single-objective benchmark problems (counterpart of
:mod:`trieste_tpu.objectives.single_objectives`): Branin, ScaledBranin,
ConstrainedScaledBranin, Hartmann6 and SimpleQuadratic.

The problems' search spaces live on ``cuda``; ``problem.search_space.to("cpu")`` gives the
same box on the CPU.

>>> x = torch.as_tensor(Branin.minimizers)
>>> bool(torch.allclose(branin(x), torch.as_tensor(Branin.minimum), atol=1e-5))
True
>>> tuple(hartmann_6(torch.zeros(4, 6)).shape)
(4, 1)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..space import Box, NonlinearConstraint, SearchSpace

ObjectiveFn = Callable[[torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class ObjectiveTestProblem:
    name: str
    objective: ObjectiveFn
    search_space: SearchSpace

    @property
    def dim(self) -> int:
        return self.search_space.dimension


@dataclass(frozen=True)
class SingleObjectiveTestProblem(ObjectiveTestProblem):
    """A test problem with a known global minimum."""

    minimizers: np.ndarray  # [N, D]
    minimum: np.ndarray  # [1]


def _as_objective(f: Callable[[torch.Tensor], torch.Tensor]) -> ObjectiveFn:
    """Wrap an ``[..., D] -> [...]`` function to return ``[..., 1]``."""

    def objective(x: torch.Tensor) -> torch.Tensor:
        return f(x)[..., None]

    return objective


def _branin_raw(x: torch.Tensor) -> torch.Tensor:
    x0, x1 = x[..., 0], x[..., 1]
    a, b, c = 1.0, 5.1 / (4 * math.pi**2), 5.0 / math.pi
    r, s, t = 6.0, 10.0, 1.0 / (8 * math.pi)
    return a * (x1 - b * x0**2 + c * x0 - r) ** 2 + s * (1 - t) * torch.cos(x0) + s


branin = _as_objective(_branin_raw)
"""The Branin-Hoo function over [-5, 10] x [0, 15]."""


def _scaled_branin_raw(u: torch.Tensor) -> torch.Tensor:
    x = torch.stack([u[..., 0] * 15.0 - 5.0, u[..., 1] * 15.0], dim=-1)
    return (_branin_raw(x) - 54.8104) / 51.9496


scaled_branin = _as_objective(_scaled_branin_raw)
"""Branin on the unit square, standardized to mean 0 and variance 1 over the domain."""

_BRANIN_MINIMIZERS = np.array([[-math.pi, 12.275], [math.pi, 2.275], [9.42478, 2.475]])

Branin = SingleObjectiveTestProblem(
    name="Branin",
    objective=branin,
    search_space=Box([-5.0, 0.0], [10.0, 15.0]),
    minimizers=_BRANIN_MINIMIZERS,
    minimum=np.array([0.397887]),
)

ScaledBranin = SingleObjectiveTestProblem(
    name="Scaled Branin",
    objective=scaled_branin,
    search_space=Box([0.0, 0.0], [1.0, 1.0]),
    minimizers=(_BRANIN_MINIMIZERS + np.array([5.0, 0.0])) / 15.0,
    minimum=np.array([(0.397887 - 54.8104) / 51.9496]),
)



def _branin_disk(x: torch.Tensor) -> torch.Tensor:
    z = x - 0.5
    return torch.sqrt(z[..., 0] ** 2 + z[..., 1] ** 2) - 0.4


ConstrainedScaledBranin = SingleObjectiveTestProblem(
    name="Constrained Scaled Branin",
    objective=scaled_branin,
    search_space=Box(
        [0.0, 0.0], [1.0, 1.0], constraints=[NonlinearConstraint(_branin_disk, -100.0, 0.0)]
    ),
    minimizers=np.array([[0.16518, 0.66518]]),
    minimum=np.array([-0.99888]),
)
"""ScaledBranin inside the disk of radius 0.4 around the centre. The declared minimum is the
JAX package's; ScaledBranin's minimizer (0.5428, 0.1517) lies in the disk too, at -1.04741."""

_H_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])
_H6_A = np.array(
    [
        [10.0, 3.0, 17.0, 3.5, 1.7, 8.0],
        [0.05, 10.0, 17.0, 0.1, 8.0, 14.0],
        [3.0, 3.5, 1.7, 10.0, 17.0, 8.0],
        [17.0, 8.0, 0.05, 10.0, 0.1, 14.0],
    ]
)
_H6_P = np.array(
    [
        [0.1312, 0.1696, 0.5569, 0.0124, 0.8283, 0.5886],
        [0.2329, 0.4135, 0.8307, 0.3736, 0.1004, 0.9991],
        [0.2348, 0.1451, 0.3522, 0.2883, 0.3047, 0.6650],
        [0.4047, 0.8828, 0.8732, 0.5743, 0.1091, 0.0381],
    ]
)


def _hartmann_6_raw(x: torch.Tensor) -> torch.Tensor:
    A = torch.as_tensor(_H6_A, dtype=x.dtype, device=x.device)
    P = torch.as_tensor(_H6_P, dtype=x.dtype, device=x.device)
    alpha = torch.as_tensor(_H_ALPHA, dtype=x.dtype, device=x.device)
    inner = torch.sum(A * torch.square(x[..., None, :] - P), dim=-1)
    return -torch.sum(alpha * torch.exp(-inner), dim=-1)


hartmann_6 = _as_objective(_hartmann_6_raw)
"""The six-dimensional Hartmann function on the unit hypercube."""

Hartmann6 = SingleObjectiveTestProblem(
    name="Hartmann 6",
    objective=hartmann_6,
    search_space=Box([0.0] * 6, [1.0] * 6),
    minimizers=np.array([[0.20169, 0.150011, 0.476874, 0.275332, 0.311652, 0.6573]]),
    minimum=np.array([-3.32237]),
)


def _simple_quadratic_raw(x: torch.Tensor) -> torch.Tensor:
    return -torch.sum(torch.square(x), dim=-1)


simple_quadratic = _as_objective(_simple_quadratic_raw)
"""The negated sum of squares on the unit square: its minimum is at the corner (1, 1)."""

SimpleQuadratic = SingleObjectiveTestProblem(
    name="Simple Quadratic",
    objective=simple_quadratic,
    search_space=Box([0.0, 0.0], [1.0, 1.0]),
    minimizers=np.array([[1.0, 1.0]]),
    minimum=np.array([-2.0]),
)

"""Single-objective benchmark problems (counterpart of
:mod:`trieste_tpu.objectives.single_objectives`): Branin, ScaledBranin,
ConstrainedScaledBranin, Hartmann3 and Hartmann6, SimpleQuadratic, GramacyLee,
LogarithmicGoldsteinPrice, Shekel4, Levy8, Rosenbrock4, Ackley5, Michalewicz2, 5 and 10, and
Trid10, each with its raw function, and :func:`check_objective_shapes`.

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
from typing import Callable, Sequence

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


def _like(a: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


def _hartmann_raw(A: np.ndarray, P: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    inner = torch.sum(_like(A, x) * torch.square(x[..., None, :] - _like(P, x)), dim=-1)
    return -torch.sum(_like(_H_ALPHA, x) * torch.exp(-inner), dim=-1)


def _hartmann_6_raw(x: torch.Tensor) -> torch.Tensor:
    return _hartmann_raw(_H6_A, _H6_P, x)


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


def _gramacy_lee_raw(x: torch.Tensor) -> torch.Tensor:
    x0 = x[..., 0]
    return torch.sin(10 * math.pi * x0) / (2 * x0) + (x0 - 1.0) ** 4


gramacy_lee = _as_objective(_gramacy_lee_raw)
"""The one-dimensional Gramacy & Lee function on [0.5, 2.5]."""

GramacyLee = SingleObjectiveTestProblem(
    name="Gramacy & Lee",
    objective=gramacy_lee,
    search_space=Box([0.5], [2.5]),
    minimizers=np.array([[0.548562]]),
    minimum=np.array([-0.869011]),
)


def _log_goldstein_price_raw(u: torch.Tensor) -> torch.Tensor:
    x = 4.0 * u - 2.0
    x0, x1 = x[..., 0], x[..., 1]
    a = (x0 + x1 + 1) ** 2
    b = 19 - 14 * x0 + 3 * x0**2 - 14 * x1 + 6 * x0 * x1 + 3 * x1**2
    c = (2 * x0 - 3 * x1) ** 2
    d = 18 - 32 * x0 + 12 * x0**2 + 48 * x1 - 36 * x0 * x1 + 27 * x1**2
    g = (1 + a * b) * (30 + c * d)
    return (torch.log(g) - 8.693) / 2.427


logarithmic_goldstein_price = _as_objective(_log_goldstein_price_raw)
"""The logarithm of Goldstein-Price on the unit square, standardized."""

LogarithmicGoldsteinPrice = SingleObjectiveTestProblem(
    name="Logarithmic Goldstein-Price",
    objective=logarithmic_goldstein_price,
    search_space=Box([0.0, 0.0], [1.0, 1.0]),
    minimizers=np.array([[0.5, 0.25]]),
    minimum=np.array([-3.12913]),
)

_H3_A = np.array([[3.0, 10.0, 30.0], [0.1, 10.0, 35.0], [3.0, 10.0, 30.0], [0.1, 10.0, 35.0]])
_H3_P = np.array(
    [
        [0.3689, 0.1170, 0.2673],
        [0.4699, 0.4387, 0.7470],
        [0.1091, 0.8732, 0.5547],
        [0.0381, 0.5743, 0.8828],
    ]
)


def _hartmann_3_raw(x: torch.Tensor) -> torch.Tensor:
    return _hartmann_raw(_H3_A, _H3_P, x)


hartmann_3 = _as_objective(_hartmann_3_raw)
"""The three-dimensional Hartmann function on the unit cube."""

Hartmann3 = SingleObjectiveTestProblem(
    name="Hartmann 3",
    objective=hartmann_3,
    search_space=Box([0.0] * 3, [1.0] * 3),
    minimizers=np.array([[0.114614, 0.555649, 0.852547]]),
    minimum=np.array([-3.86278]),
)

_SHEKEL_BETA = np.array([1, 2, 2, 4, 4, 6, 3, 7, 5, 5], dtype=np.float64) / 10.0
_SHEKEL_C = np.array(
    [
        [4.0, 1.0, 8.0, 6.0, 3.0, 2.0, 5.0, 8.0, 6.0, 7.0],
        [4.0, 1.0, 8.0, 6.0, 7.0, 9.0, 3.0, 1.0, 2.0, 3.6],
        [4.0, 1.0, 8.0, 6.0, 3.0, 2.0, 5.0, 8.0, 6.0, 7.0],
        [4.0, 1.0, 8.0, 6.0, 7.0, 9.0, 3.0, 1.0, 2.0, 3.6],
    ]
)


def _shekel_4_raw(x: torch.Tensor) -> torch.Tensor:
    z = x * 10.0
    d2 = torch.sum(torch.square(z[..., :, None] - _like(_SHEKEL_C, x)), dim=-2)  # [..., 10]
    val = -torch.sum(1.0 / (d2 + _like(_SHEKEL_BETA, x)), dim=-1)
    return (val + 1.0) / 2.73


shekel_4 = _as_objective(_shekel_4_raw)
"""Shekel's function with ten maxima, its inputs on the unit hypercube, standardized."""

Shekel4 = SingleObjectiveTestProblem(
    name="Shekel 4",
    objective=shekel_4,
    search_space=Box([0.0] * 4, [1.0] * 4),
    minimizers=np.array([[0.4, 0.4, 0.4, 0.4]]),
    minimum=np.array([(-10.5363 + 1.0) / 2.73]),
)


def _levy_raw(x: torch.Tensor) -> torch.Tensor:
    w = 1.0 + (x - 1.0) / 4.0
    term1 = torch.sin(math.pi * w[..., 0]) ** 2
    wi = w[..., :-1]
    mid = torch.sum((wi - 1.0) ** 2 * (1.0 + 10.0 * torch.sin(math.pi * wi + 1.0) ** 2), dim=-1)
    last = (w[..., -1] - 1.0) ** 2 * (1.0 + torch.sin(2 * math.pi * w[..., -1]) ** 2)
    return term1 + mid + last


def _levy_8_raw(u: torch.Tensor) -> torch.Tensor:
    return _levy_raw(u * 20.0 - 10.0)


levy = _as_objective(_levy_raw)
"""The Levy function in any dimension."""

levy_8 = _as_objective(_levy_8_raw)
"""Levy in eight dimensions, its inputs on the unit hypercube."""

Levy8 = SingleObjectiveTestProblem(
    name="Levy 8",
    objective=levy_8,
    search_space=Box([0.0] * 8, [1.0] * 8),
    minimizers=(np.ones((1, 8)) + 10.0) / 20.0,
    minimum=np.array([0.0]),
)


def _rosenbrock_raw(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1.0 - x[..., :-1]) ** 2, dim=-1)


def _rosenbrock_4_raw(u: torch.Tensor) -> torch.Tensor:
    return (_rosenbrock_raw(u * 4.1 - 2.048) - 3.827 * 1e3) / (3.755 * 1e3)


rosenbrock = _as_objective(_rosenbrock_raw)
"""The Rosenbrock function in any dimension."""

rosenbrock_4 = _as_objective(_rosenbrock_4_raw)
"""Rosenbrock in four dimensions, its inputs on the unit hypercube, standardized."""

Rosenbrock4 = SingleObjectiveTestProblem(
    name="Rosenbrock 4",
    objective=rosenbrock_4,
    search_space=Box([0.0] * 4, [1.0] * 4),
    minimizers=(np.ones((1, 4)) + 2.048) / 4.1,
    minimum=np.array([(0.0 - 3.827e3) / 3.755e3]),
)


def _ackley_5_raw(u: torch.Tensor) -> torch.Tensor:
    x = u * 65.536 - 32.768
    d = x.shape[-1]
    a, b, c = 20.0, 0.2, 2 * math.pi
    s1 = torch.sum(torch.square(x), dim=-1) / d
    s2 = torch.sum(torch.cos(c * x), dim=-1) / d
    return -a * torch.exp(-b * torch.sqrt(s1)) - torch.exp(s2) + a + math.e


ackley_5 = _as_objective(_ackley_5_raw)
"""Ackley in five dimensions, its inputs on the unit hypercube."""

Ackley5 = SingleObjectiveTestProblem(
    name="Ackley 5",
    objective=ackley_5,
    search_space=Box([0.0] * 5, [1.0] * 5),
    minimizers=np.full((1, 5), 32.768 / 65.536),
    minimum=np.array([0.0]),
)


def _michalewicz_raw(x: torch.Tensor, m: float = 10.0) -> torch.Tensor:
    i = torch.arange(1, x.shape[-1] + 1, dtype=x.dtype, device=x.device)
    return -torch.sum(torch.sin(x) * torch.sin(i * torch.square(x) / math.pi) ** (2 * m), dim=-1)


michalewicz = _as_objective(_michalewicz_raw)
"""The Michalewicz function (steepness 10) in any dimension."""


def _make_michalewicz(d: int, minimizer: Sequence[float], minimum: float) -> SingleObjectiveTestProblem:
    return SingleObjectiveTestProblem(
        name=f"Michalewicz {d}",
        objective=michalewicz,
        search_space=Box([0.0] * d, [math.pi] * d),
        minimizers=np.array([minimizer]),
        minimum=np.array([minimum]),
    )


Michalewicz2 = _make_michalewicz(2, [2.202906, 1.570796], -1.8013034)
Michalewicz5 = _make_michalewicz(5, [2.202906, 1.570796, 1.284992, 1.923058, 1.720470], -4.687658)
Michalewicz10 = _make_michalewicz(
    10,
    [2.202906, 1.570796, 1.284992, 1.923058, 1.720470,
     1.570796, 1.454414, 1.756087, 1.655717, 1.570796],
    -9.66015,
)
michalewicz_2 = michalewicz_5 = michalewicz_10 = michalewicz


def _trid_raw(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x - 1.0), dim=-1) - torch.sum(x[..., 1:] * x[..., :-1], dim=-1)


trid = _as_objective(_trid_raw)
"""The Trid function in any dimension."""


def _make_trid(d: int) -> SingleObjectiveTestProblem:
    i = np.arange(1, d + 1, dtype=np.float64)
    return SingleObjectiveTestProblem(
        name=f"Trid {d}",
        objective=trid,
        search_space=Box([-(d**2.0)] * d, [d**2.0] * d),
        minimizers=(i * (d + 1.0 - i))[None, :],
        minimum=np.array([-d * (d + 4.0) * (d - 1.0) / 6.0]),
    )


Trid10 = _make_trid(10)
trid_10 = trid


def check_objective_shapes(d: int) -> Callable[[ObjectiveFn], ObjectiveFn]:
    """A decorator that raises ``ValueError`` unless the objective maps ``[..., d]`` to
    ``[..., 1]``."""

    def decorator(f: ObjectiveFn) -> ObjectiveFn:
        def wrapped(x: torch.Tensor) -> torch.Tensor:
            if x.shape[-1] != d:
                raise ValueError(f"objective expects [..., {d}] inputs, got {tuple(x.shape)}")
            out = f(x)
            if out.shape != x.shape[:-1] + (1,):
                raise ValueError(
                    f"objective returned {tuple(out.shape)}, expected {tuple(x.shape[:-1]) + (1,)}"
                )
            return out

        return wrapped

    return decorator

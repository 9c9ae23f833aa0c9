"""Multi-objective benchmark problems (counterpart of
:mod:`trieste_tpu.objectives.multi_objectives`): VLMOP2 and the DTLZ family, each with a
generator of Pareto-optimal points.

A generator's draws (DTLZ1's Dirichlet weights, DTLZ2's normals) come from a
``torch.Generator``; the points are on its device (``cuda`` without one), in the default
float dtype.

>>> front = VLMOP2.gen_pareto_optimal_points(5, device="cpu")
>>> tuple(front.shape)
(5, 2)
>>> bool(torch.allclose(vlmop2(torch.zeros(1, 2)), torch.tensor([[1 - math.exp(-1)] * 2])))
True
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional, Union

import torch

from ..space import Box
from ..utils.misc import default_float, standard_normal, uniform
from .single_objectives import ObjectiveTestProblem

Device = Union[str, torch.device]


@dataclass(frozen=True)
class MultiObjectiveTestProblem(ObjectiveTestProblem):
    """A multi-objective test problem with a generator of Pareto-optimal points,
    ``gen_pareto_optimal_points(n, generator=None, *, device=None) -> [n, M]``."""

    gen_pareto_optimal_points: Callable[..., torch.Tensor]


def _like(generator: Optional[torch.Generator], device: Optional[Device]) -> torch.Tensor:
    """A zero-size tensor of the default float dtype on ``device``, or on the generator's
    device, or on ``cuda``."""
    if device is None:
        device = generator.device if generator is not None else "cuda"
    return torch.empty(0, dtype=default_float(), device=device)


def vlmop2(x: torch.Tensor) -> torch.Tensor:
    """The VLMOP2 function, ``[..., D] -> [..., 2]``."""
    transl = 1.0 / math.sqrt(x.shape[-1])
    f1 = 1.0 - torch.exp(-torch.sum((x - transl) ** 2, dim=-1))
    f2 = 1.0 - torch.exp(-torch.sum((x + transl) ** 2, dim=-1))
    return torch.stack([f1, f2], dim=-1)


def _vlmop2_pareto(
    n: int, generator: Optional[torch.Generator] = None, *, device: Optional[Device] = None
) -> torch.Tensor:
    """VLMOP2 on ``n`` points of the segment from ``-t`` to ``t`` (``t = 1/sqrt(2)``),
    which is its Pareto set; nothing is drawn."""
    like = _like(generator, device)
    transl = 1.0 / math.sqrt(2.0)
    t = torch.linspace(-transl, transl, n, dtype=like.dtype, device=like.device)
    return vlmop2(torch.stack([t, t], dim=-1))


VLMOP2 = MultiObjectiveTestProblem(
    name="VLMOP2",
    objective=vlmop2,
    search_space=Box([-2.0, -2.0], [2.0, 2.0]),
    gen_pareto_optimal_points=_vlmop2_pareto,
)


def dtlz_mkd(input_dim: int, num_objectives: int) -> tuple[int, int, int]:
    """``(M, k, d)``: the number of objectives, of distance variables and of inputs."""
    if input_dim <= 0 or num_objectives <= 0 or input_dim <= num_objectives:
        raise ValueError(
            f"DTLZ requires input_dim > num_objectives > 0, got {input_dim}, "
            f"{num_objectives}"
        )
    M = num_objectives
    d = input_dim
    k = d - M + 1
    return M, k, d


def dtlz1(x: torch.Tensor, num_objectives: int = 2) -> torch.Tensor:
    """DTLZ1, ``[..., d] -> [..., M]``."""
    M = num_objectives
    xm = x[..., M - 1:]
    g = 100.0 * (
        xm.shape[-1]
        + torch.sum((xm - 0.5) ** 2 - torch.cos(20.0 * math.pi * (xm - 0.5)), dim=-1)
    )
    objs = []
    for i in range(M):
        f = 0.5 * (1.0 + g)
        for j in range(M - 1 - i):
            f = f * x[..., j]
        if i > 0:
            f = f * (1.0 - x[..., M - 1 - i])
        objs.append(f)
    return torch.stack(objs, dim=-1)


def dtlz2(x: torch.Tensor, num_objectives: int = 2) -> torch.Tensor:
    """DTLZ2, ``[..., d] -> [..., M]``."""
    M = num_objectives
    xm = x[..., M - 1:]
    g = torch.sum((xm - 0.5) ** 2, dim=-1)
    objs = []
    for i in range(M):
        f = 1.0 + g
        for j in range(M - 1 - i):
            f = f * torch.cos(0.5 * math.pi * x[..., j])
        if i > 0:
            f = f * torch.sin(0.5 * math.pi * x[..., M - 1 - i])
        objs.append(f)
    return torch.stack(objs, dim=-1)


def dirichlet_ones(generator: Optional[torch.Generator], n: int, M: int, like: torch.Tensor):
    """``n`` draws ``[n, M]`` of the flat Dirichlet distribution: unit exponentials
    ``-log(1 - u)`` of uniforms, normalized."""
    e = -torch.log1p(-uniform(generator, (n, M), like))
    return e / torch.sum(e, dim=-1, keepdim=True)


def _dtlz1_pareto(
    M: int, n: int, generator: Optional[torch.Generator] = None, *,
    device: Optional[Device] = None,
) -> torch.Tensor:
    return 0.5 * dirichlet_ones(generator, n, M, _like(generator, device))


def _dtlz2_pareto(
    M: int, n: int, generator: Optional[torch.Generator] = None, *,
    device: Optional[Device] = None,
) -> torch.Tensor:
    z = torch.abs(standard_normal(generator, (n, M), _like(generator, device)))
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)


def DTLZ1(input_dim: int, num_objectives: int) -> MultiObjectiveTestProblem:
    M, _, d = dtlz_mkd(input_dim, num_objectives)
    return MultiObjectiveTestProblem(
        name=f"DTLZ1({d}, {M})",
        objective=partial(dtlz1, num_objectives=M),
        search_space=Box([0.0] * d, [1.0] * d),
        gen_pareto_optimal_points=partial(_dtlz1_pareto, M),
    )


def DTLZ2(input_dim: int, num_objectives: int) -> MultiObjectiveTestProblem:
    M, _, d = dtlz_mkd(input_dim, num_objectives)
    return MultiObjectiveTestProblem(
        name=f"DTLZ2({d}, {M})",
        objective=partial(dtlz2, num_objectives=M),
        search_space=Box([0.0] * d, [1.0] * d),
        gen_pareto_optimal_points=partial(_dtlz2_pareto, M),
    )

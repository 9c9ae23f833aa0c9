"""Plotting utilities for inequality-constrained problems (counterpart of
:mod:`trieste_tpu.experimental.plotting.inequality_constraints`): a ``Simulation``
protocol bundling an objective, a constraint and a feasibility threshold, and figures of
the constrained objective and of the feasible and infeasible query points. The simulation
is evaluated on a grid that is a tensor on the device and dtype of the space's bounds; the
data may be numpy arrays or tensors.
"""
from __future__ import annotations

from typing import Optional, Protocol, Tuple, Type, runtime_checkable

import numpy as np

from ...types import TensorType
from .plotting import _on_device_of, _to_np, create_grid


@runtime_checkable
class Simulation(Protocol):
    """A constrained simulation: an objective, a constraint and the threshold the
    constraint must not exceed."""

    threshold: float

    @staticmethod
    def objective(input_data: TensorType) -> TensorType:
        ...

    @staticmethod
    def constraint(input_data: TensorType) -> TensorType:
        ...


def plot_objective_and_constraints(search_space, simulation: Type[Simulation]):
    """A 2 x 2 panel: the objective and the constraint, and both masked to the feasible
    region."""
    import matplotlib.pyplot as plt

    points, xx, yy = create_grid(search_space.lower, search_space.upper, grid_density=30)
    grid = _on_device_of(points, search_space.lower)
    objective = _to_np(simulation.objective(grid))
    constraint = _to_np(simulation.constraint(grid))
    fig, (axes1, axes2) = plt.subplots(2, 2, sharex="all", sharey="all", figsize=(8, 8))
    levels = 30

    axes1[0].contourf(xx, yy, objective.reshape(*xx.shape), levels, alpha=0.9)
    axes1[1].contourf(xx, yy, constraint.reshape(*xx.shape), levels, alpha=0.9)
    axes1[0].set_title("Objective")
    axes1[1].set_title("Constraint")

    mask = (constraint > simulation.threshold).reshape(objective.shape)
    objective_masked = np.ma.array(objective, mask=mask)
    constraint_masked = np.ma.array(constraint, mask=mask)
    axes2[0].contourf(xx, yy, objective_masked.reshape(*xx.shape), levels, alpha=0.9)
    axes2[1].contourf(xx, yy, constraint_masked.reshape(*xx.shape), levels, alpha=0.9)
    axes2[0].set_title("Constrained objective")
    axes2[1].set_title("Constraint mask")

    lower, upper = _to_np(search_space.lower), _to_np(search_space.upper)
    for ax in np.ravel([axes1, axes2]):
        ax.set_xlim(lower[0], upper[0])
        ax.set_ylim(lower[1], upper[1])
    return fig


def plot_init_query_points(
    search_space,
    simulation: Type[Simulation],
    objective_data: TensorType,
    constraint_data: TensorType,
    new_constraint_data: Optional[Tuple[TensorType, TensorType]] = None,
):
    """Query points over the feasibility-masked objective: feasible points filled,
    infeasible hollow, and new points, where given, in a second colour.

    ``objective_data``/``constraint_data`` are ``[N, D(+1)]`` arrays whose first two
    columns are the 2-D inputs and whose last column is the observation.
    """
    import matplotlib.pyplot as plt

    levels, psize = 30, 15
    cw, cb, co = "white", "tab:blue", "tab:orange"
    points, xx, yy = create_grid(search_space.lower, search_space.upper, grid_density=30)
    grid = _on_device_of(points, search_space.lower)
    objective = _to_np(simulation.objective(grid))
    constraint = _to_np(simulation.constraint(grid))
    fig, ax = plt.subplots(1, 1, figsize=(8, 6))

    mask = np.zeros_like(objective, dtype=bool)
    mask[constraint[:, 0] > simulation.threshold, :] = True
    objective_masked = np.ma.array(objective, mask=mask)

    def in_out(points, cvals):
        points, cvals = _to_np(points), _to_np(cvals)
        ids_in = cvals[:, -1] <= simulation.threshold
        return points[ids_in], points[~ids_in]

    pts_in, pts_out = in_out(objective_data, constraint_data)
    ax.contourf(xx, yy, objective_masked.reshape(*xx.shape), levels, alpha=0.9)
    ax.scatter(pts_in[:, 0], pts_in[:, 1], s=psize, c=cb, edgecolors=cw, marker="o")
    ax.scatter(pts_out[:, 0], pts_out[:, 1], s=psize, c=cw, edgecolors=cb, marker="o")

    if new_constraint_data is not None:
        new_points, new_cvals = new_constraint_data
        n_in, n_out = in_out(new_points, new_cvals)
        ax.scatter(n_in[:, 0], n_in[:, 1], s=psize, c=co, edgecolors=cw, marker="o")
        ax.scatter(n_out[:, 0], n_out[:, 1], s=psize, c=cw, edgecolors=co, marker="o")

    lower, upper = _to_np(search_space.lower), _to_np(search_space.upper)
    ax.set_title("Constrained objective")
    ax.set_xlim(lower[0], upper[0])
    ax.set_ylim(lower[1], upper[1])
    return fig


def plot_2obj_cst_query_points(
    search_space,
    simulation: Type[Simulation],
    objective_data: TensorType,
    constraint_data: TensorType,
) -> list:
    """One constrained query-point figure per objective of a 2-output simulation."""
    figures = []
    for idx in range(2):

        class _SimSlice:
            threshold = simulation.threshold
            constraint = staticmethod(simulation.constraint)

            @staticmethod
            def objective(input_data, _idx=idx):
                return _to_np(simulation.objective(input_data))[:, _idx : _idx + 1]

        figures.append(
            plot_init_query_points(search_space, _SimSlice, objective_data, constraint_data)
        )
    return figures

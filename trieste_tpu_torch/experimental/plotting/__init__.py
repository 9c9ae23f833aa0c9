"""Experimental plotting (counterpart of :mod:`trieste_tpu.experimental.plotting`):
matplotlib figures, imported where a figure is made, and plotly figures behind
:data:`PLOTLY_AVAILABLE`."""

from .plotting import (
    convert_figure_to_frame,
    convert_frames_to_gif,
    create_grid,
    format_point_markers,
    plot_acq_function_2d,
    plot_bo_points,
    plot_feasible_region_2d,
    plot_function_2d,
    plot_gp_2d,
    plot_mobo_history,
    plot_mobo_points_in_obj_space,
    plot_constrained_objective_2d,
    plot_pareto_front_2d,
    plot_regret,
    plot_trust_region_history_2d,
)
from .inequality_constraints import (
    Simulation,
    plot_2obj_cst_query_points,
    plot_init_query_points,
    plot_objective_and_constraints,
)
from .pairplot import pairplot
from .plotting import plot_surface
from .plotting_plotly import (
    PLOTLY_AVAILABLE,
    add_surface_plotly,
    add_bo_points_plotly,
    plot_function_plotly,
    plot_model_predictions_plotly,
)

__all__ = [
    "PLOTLY_AVAILABLE",
    "Simulation",
    "add_bo_points_plotly",
    "add_surface_plotly",
    "pairplot",
    "plot_2obj_cst_query_points",
    "plot_constrained_objective_2d",
    "plot_init_query_points",
    "plot_surface",
    "convert_figure_to_frame",
    "convert_frames_to_gif",
    "create_grid",
    "format_point_markers",
    "plot_acq_function_2d",
    "plot_bo_points",
    "plot_feasible_region_2d",
    "plot_function_2d",
    "plot_function_plotly",
    "plot_gp_2d",
    "plot_mobo_history",
    "plot_mobo_points_in_obj_space",
    "plot_model_predictions_plotly",
    "plot_objective_and_constraints",
    "plot_pareto_front_2d",
    "plot_regret",
    "plot_trust_region_history_2d",
]

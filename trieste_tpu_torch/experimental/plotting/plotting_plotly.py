"""Plotly plotting utilities (counterpart of
:mod:`trieste_tpu.experimental.plotting.plotting_plotly`), behind the optional ``plotly``
dependency: without it :data:`PLOTLY_AVAILABLE` is false and every figure raises
``ImportError``. Inputs may be numpy arrays or tensors; a function or model is evaluated on
a grid that is a tensor on the device and dtype of ``mins``."""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .plotting import _on_device_of, _to_np, create_grid

try:
    import plotly.graph_objects as go

    PLOTLY_AVAILABLE = True
except ImportError:  # an optional dependency
    go = None
    PLOTLY_AVAILABLE = False


def _require_plotly() -> None:
    if not PLOTLY_AVAILABLE:
        raise ImportError("plotly is not installed; install it to use the plotly plots")


def plot_function_plotly(
    f: Callable, mins, maxs, grid_density: int = 30, title: Optional[str] = None
):
    """A 3-D surface of a function of two inputs."""
    _require_plotly()
    points, XX, YY = create_grid(mins, maxs, grid_density)
    values = _to_np(f(_on_device_of(points, mins))).reshape(XX.shape)
    fig = go.Figure(data=[go.Surface(x=XX, y=YY, z=values)])
    if title:
        fig.update_layout(title=title)
    return fig


def plot_model_predictions_plotly(
    model, mins, maxs, grid_density: int = 30, num_samples: Optional[int] = None
):
    """A model's predictive mean surface between its ±2 standard deviation surfaces."""
    _require_plotly()
    points, XX, YY = create_grid(mins, maxs, grid_density)
    mean, var = model.predict(_on_device_of(points, mins))
    mean = _to_np(mean)[:, 0].reshape(XX.shape)
    std = np.sqrt(_to_np(var)[:, 0]).reshape(XX.shape)
    return go.Figure(
        data=[
            go.Surface(x=XX, y=YY, z=mean, opacity=1.0, name="mean"),
            go.Surface(x=XX, y=YY, z=mean + 2 * std, opacity=0.3, showscale=False),
            go.Surface(x=XX, y=YY, z=mean - 2 * std, opacity=0.3, showscale=False),
        ]
    )


def format_point_markers(
    num_pts: int,
    num_init: int,
    idx_best: Optional[int] = None,
    mask_fail=None,
    m_init: str = "x",
    m_add: str = "circle",
    c_pass: str = "green",
    c_fail: str = "red",
    c_best: str = "darkmagenta",
):
    """Each point's colour and marker by its role: the initial points crosses, the
    acquired ones circles, failures red and the best point dark magenta. Returns
    ``(colors [N], markers [N])``."""
    col_pts = np.repeat(c_pass, num_pts).astype("<U15")
    mark_pts = np.repeat(m_init, num_pts).astype("<U15")
    mark_pts[num_init:] = m_add
    if mask_fail is not None:
        col_pts[_to_np(mask_fail)] = c_fail
    if idx_best is not None:
        col_pts[idx_best] = c_best
    return col_pts, mark_pts


def add_surface_plotly(xx, yy, f, fig, alpha: float = 1.0, figrow: int = 1, figcol: int = 1):
    """Add a surface to a plotly (sub)figure."""
    _require_plotly()
    xx, yy = _to_np(xx), _to_np(yy)
    z = _to_np(f).reshape([xx.shape[0], yy.shape[1]])
    fig.add_trace(
        go.Surface(z=z, x=xx, y=yy, showscale=False, opacity=alpha, colorscale="viridis"),
        row=figrow,
        col=figcol,
    )
    return fig


def add_bo_points_plotly(
    x,
    y,
    z,
    fig,
    num_init: int = 0,
    idx_best: Optional[int] = None,
    mask_fail=None,
    figrow: int = 1,
    figcol: int = 1,
):
    """BO points on a plotly 3-D (sub)figure, marked by their role."""
    _require_plotly()
    x = _to_np(x)
    col_pts, mark_pts = format_point_markers(x.shape[0], num_init, idx_best, mask_fail)
    fig.add_trace(
        go.Scatter3d(
            x=x,
            y=_to_np(y),
            z=_to_np(z),
            mode="markers",
            marker=dict(size=4, color=col_pts, symbol=mark_pts, opacity=0.8),
        ),
        row=figrow,
        col=figcol,
    )
    return fig

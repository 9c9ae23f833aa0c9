"""Matplotlib plotting utilities (counterpart of
:mod:`trieste_tpu.experimental.plotting.plotting`): regret curves, 2-D function and model
surfaces, BO point overlays, trust-region history and multi-objective point clouds.

Host-side: the figures take numpy arrays or tensors (copied to the host), and a function,
model or space is evaluated on a grid that is a tensor on the device and dtype of the
bounds it was given (``mins``, a space's ``lower``), or on ``cuda`` when the bounds are
not tensors. matplotlib is imported where a figure is made, so importing this module needs
none.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ...utils.misc import default_float, to_numpy


def _to_np(x) -> np.ndarray:
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _on_device_of(points: np.ndarray, like) -> torch.Tensor:
    """``points`` as a tensor on the device and in the floating dtype of ``like``. Bounds
    that are not tensors (lists, arrays) send the grid to ``cuda`` in the default dtype,
    as :func:`~trieste_tpu_torch.space._points_tensor` sends arrays."""
    if isinstance(like, torch.Tensor) and like.is_floating_point():
        return torch.as_tensor(points, dtype=like.dtype, device=like.device)
    device = like.device if isinstance(like, torch.Tensor) else "cuda"
    return torch.as_tensor(points, dtype=default_float(), device=device)


def plot_regret(
    observations,
    ax,
    num_init: int = 0,
    show_obs: bool = True,
    minimum: Optional[float] = None,
) -> None:
    """The running minimum of the observations against their index."""
    obs = _to_np(observations).reshape(-1)
    best = np.minimum.accumulate(obs)
    steps = np.arange(len(obs))
    if show_obs:
        ax.scatter(steps, obs, s=12, alpha=0.5, label="observations")
    ax.plot(steps, best, color="C1", label="best so far")
    if minimum is not None:
        ax.axhline(minimum, color="k", linestyle="--", alpha=0.5, label="minimum")
    if num_init:
        ax.axvline(num_init - 0.5, color="gray", linestyle=":", alpha=0.7)
    ax.set_xlabel("observation index")
    ax.set_ylabel("objective")
    ax.legend()


def create_grid(
    mins, maxs, grid_density: int = 30
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A 2-D evaluation grid: its points ``[G², 2]`` and the two ``[G, G]`` meshes."""
    mins, maxs = _to_np(mins), _to_np(maxs)
    xs = np.linspace(mins[0], maxs[0], grid_density)
    ys = np.linspace(mins[1], maxs[1], grid_density)
    XX, YY = np.meshgrid(xs, ys)
    points = np.stack([XX.ravel(), YY.ravel()], axis=-1)
    return points, XX, YY


def plot_surface(
    xx: np.ndarray,
    yy: np.ndarray,
    f,
    ax,
    contour: bool = False,
    fill: bool = False,
    alpha: float = 1.0,
):
    """A contour (filled or not) or a 3-D surface of mesh data on an axis."""
    f = _to_np(f).reshape(np.shape(xx))
    if contour:
        if fill:
            return ax.contourf(xx, yy, f, 80, alpha=alpha)
        return ax.contour(xx, yy, f, 80, alpha=alpha)
    return ax.plot_surface(xx, yy, f, alpha=alpha, linewidth=0, antialiased=False)


def plot_function_2d(
    f: Callable[[torch.Tensor], torch.Tensor],
    mins,
    maxs,
    grid_density: int = 30,
    contour: bool = True,
    title: Optional[str] = None,
    fig=None,
    ax=None,
):
    """A contour plot of a function of two inputs (its first output)."""
    import matplotlib.pyplot as plt

    points, XX, YY = create_grid(mins, maxs, grid_density)
    values = _to_np(f(_on_device_of(points, mins))).reshape(XX.shape[0], XX.shape[1], -1)[:, :, 0]
    if ax is None:
        fig, ax = plt.subplots()
    if contour:
        cs = ax.contourf(XX, YY, values, levels=30)
        if fig is not None:
            fig.colorbar(cs, ax=ax)
    else:
        ax.pcolormesh(XX, YY, values)
    if title:
        ax.set_title(title)
    return fig, ax


def plot_gp_2d(model, mins, maxs, grid_density: int = 30, fig=None):
    """The predictive mean and variance of a model of two inputs, side by side."""
    import matplotlib.pyplot as plt

    points, XX, YY = create_grid(mins, maxs, grid_density)
    mean, var = model.predict(_on_device_of(points, mins))
    if fig is None:
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    else:
        axes = fig.subplots(1, 2)
    for ax, vals, name in zip(axes, [mean, var], ["mean", "variance"]):
        cs = ax.contourf(XX, YY, _to_np(vals)[:, 0].reshape(XX.shape), levels=30)
        fig.colorbar(cs, ax=ax)
        ax.set_title(name)
    return fig, axes


def plot_bo_points(pts, ax, num_init: int = 0, idx_best: Optional[int] = None) -> None:
    """BO query points over a plot: the initial ones, the acquired ones and the best."""
    pts = _to_np(pts)
    if num_init:
        ax.scatter(pts[:num_init, 0], pts[:num_init, 1], c="black", marker="x", label="initial")
    ax.scatter(pts[num_init:, 0], pts[num_init:, 1], c="tab:red", s=18, label="acquired")
    if idx_best is not None:
        ax.scatter(pts[idx_best, 0], pts[idx_best, 1], c="gold", marker="*", s=150,
                   edgecolor="k", label="best")
    ax.legend()


def _non_dominated_mask(obs: np.ndarray) -> np.ndarray:
    from ...acquisition.multi_objective.dominance import non_dominated

    return _to_np(non_dominated(torch.as_tensor(obs))[1])


def plot_mobo_points_in_obj_space(
    obs_values,
    num_init: Optional[int] = None,
    mask_fail: Optional[np.ndarray] = None,
    ax=None,
):
    """Multi-objective observations, the Pareto front picked out."""
    import matplotlib.pyplot as plt

    obs = _to_np(obs_values)
    nd_mask = _non_dominated_mask(obs)
    if ax is None:
        _, ax = plt.subplots()
    ax.scatter(obs[~nd_mask, 0], obs[~nd_mask, 1], c="tab:blue", alpha=0.5, label="dominated")
    ax.scatter(obs[nd_mask, 0], obs[nd_mask, 1], c="tab:red", label="Pareto front")
    ax.set_xlabel("objective 1")
    ax.set_ylabel("objective 2")
    ax.legend()
    return ax


def plot_trust_region_history_2d(
    obj_func: Callable[[torch.Tensor], torch.Tensor],
    mins,
    maxs,
    history: Sequence,
    num_query_points: Optional[int] = None,
    num_init: Optional[int] = None,
):
    """The objective's contours with the last record's trust-region boxes and its query
    points over them."""
    import matplotlib.patches as patches

    from ...utils.misc import ignoring_local_tags

    fig, ax = plot_function_2d(obj_func, mins, maxs, contour=True)
    if not history:
        return fig, ax
    record = history[-1]
    record = record.load() if hasattr(record, "load") else record
    state = record.acquisition_state
    if state is not None and hasattr(state, "subspaces"):
        for i, region in enumerate(state.subspaces):
            lower, upper = _to_np(region.lower), _to_np(region.upper)
            ax.add_patch(patches.Rectangle(lower, *(upper - lower), fill=False,
                                           edgecolor=f"C{i % 10}", linewidth=2))
    datasets = ignoring_local_tags(record.datasets)
    if datasets:
        qp = _to_np(next(iter(datasets.values())).trimmed_query_points)
        plot_bo_points(qp, ax, num_init or 0)
    return fig, ax


def plot_acq_function_2d(
    acq_fn: Callable[[torch.Tensor], torch.Tensor],
    mins,
    maxs,
    grid_density: int = 40,
    contour: bool = True,
    colorbar: bool = True,
    title: Optional[str] = None,
    fig_size: Tuple[float, float] = (8.0, 6.0),
):
    """An acquisition function over a 2-D box, evaluated at ``[G², 1, 2]``."""
    import matplotlib.pyplot as plt

    points, XX, YY = create_grid(mins, maxs, grid_density)
    vals = _to_np(acq_fn(_on_device_of(points[:, None, :], mins))).reshape(XX.shape)
    fig, ax = plt.subplots(figsize=fig_size)
    cm = ax.contourf(XX, YY, vals, levels=40) if contour else ax.pcolormesh(XX, YY, vals)
    if colorbar:
        fig.colorbar(cm, ax=ax)
    if title:
        ax.set_title(title)
    return fig, ax


def format_point_markers(
    num_pts: int,
    num_init: int = 0,
    idx_best: Optional[Sequence[int]] = None,
    mask_fail: Optional[np.ndarray] = None,
    m_init: str = "x",
    m_add: str = "o",
    c_pass: str = "tab:green",
    c_fail: str = "tab:red",
    c_best: str = "tab:purple",
) -> Tuple[np.ndarray, np.ndarray]:
    """Each point's marker and colour in a BO progress plot: ``m_init`` for the initial
    points, ``m_add`` for the others; ``c_fail`` for failures and ``c_best`` for the best,
    ``c_pass`` otherwise."""
    markers = np.repeat(m_add, num_pts).astype("<U1")
    markers[:num_init] = m_init
    colors = np.repeat(c_pass, num_pts).astype("<U16")
    if mask_fail is not None:
        colors[_to_np(mask_fail).astype(bool)] = c_fail
    if idx_best is not None:
        colors[_to_np(idx_best).astype(int)] = c_best
    return markers, colors


def plot_mobo_history(
    obs_values, metric_fn: Callable[[np.ndarray], float], num_init: int, ax
) -> None:
    """A multi-objective progress metric (a hypervolume regret, say) as observations
    accrue."""
    obs = _to_np(obs_values)
    steps = np.arange(num_init, len(obs) + 1)
    vals = [float(metric_fn(obs[:i])) for i in steps]
    ax.plot(steps, vals, color="C0")
    ax.axvline(num_init - 0.5, color="gray", linestyle=":", alpha=0.7)
    ax.set_xlabel("observations")
    ax.set_ylabel("metric")


def _feasibility(space, points: np.ndarray, shape) -> np.ndarray:
    return _to_np(space.is_feasible(_on_device_of(points, space.lower))).reshape(shape)


def plot_feasible_region_2d(
    space, ax, grid_density: int = 200, color: str = "tab:green", alpha: float = 0.25
) -> None:
    """Shade the feasible region of a constrained 2-D space."""
    points, XX, YY = create_grid(space.lower, space.upper, grid_density)
    feasible = _feasibility(space, points, XX.shape).astype(float)
    ax.contourf(XX, YY, feasible, levels=[0.5, 1.5], colors=[color], alpha=alpha)
    ax.contour(XX, YY, feasible, levels=[0.5], colors=[color])


def plot_constrained_objective_2d(
    space,
    objective: Callable[[torch.Tensor], torch.Tensor],
    grid_density: int = 100,
    fig_size: Tuple[float, float] = (8.0, 6.0),
):
    """The objective's contours with the space's infeasible region greyed out (beside
    :func:`.inequality_constraints.plot_objective_and_constraints`, which takes a
    simulation in place of a constrained space)."""
    import matplotlib.pyplot as plt

    points, XX, YY = create_grid(space.lower, space.upper, grid_density)
    vals = _to_np(objective(_on_device_of(points, space.lower))).reshape(XX.shape)
    fig, ax = plt.subplots(figsize=fig_size)
    cm = ax.contourf(XX, YY, vals, levels=40)
    fig.colorbar(cm, ax=ax)
    if getattr(space, "has_constraints", False):
        feasible = _feasibility(space, points, XX.shape)
        masked = np.ma.masked_where(feasible, np.ones_like(vals))
        ax.pcolormesh(XX, YY, masked, cmap="gray", alpha=0.45, shading="auto")
        ax.contour(XX, YY, feasible.astype(float), levels=[0.5], colors="k")
    return fig, ax


def plot_pareto_front_2d(
    observations, ax, reference_point=None, show_dominated: bool = True
) -> None:
    """Observed objective vectors with the Pareto front as a staircase and, where given,
    the hypervolume's reference point."""
    obs = _to_np(observations)
    mask = _non_dominated_mask(obs)
    front = obs[mask]
    if show_dominated:
        ax.scatter(obs[~mask, 0], obs[~mask, 1], s=14, c="gray", alpha=0.5, label="dominated")
    f = front[np.argsort(front[:, 0])]
    ax.scatter(f[:, 0], f[:, 1], s=24, c="C3", label="Pareto front")
    ax.plot(np.repeat(f[:, 0], 2)[1:], np.repeat(f[:, 1], 2)[:-1], c="C3", lw=1, alpha=0.8)
    if reference_point is not None:
        rp = _to_np(reference_point)
        ax.scatter([rp[0]], [rp[1]], marker="*", s=120, c="k", label="reference")
    ax.set_xlabel("objective 1")
    ax.set_ylabel("objective 2")
    ax.legend()


def convert_figure_to_frame(fig) -> np.ndarray:
    """A matplotlib figure rasterized to an RGB array ``[H, W, 3]``."""
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()


def convert_frames_to_gif(frames: Sequence[np.ndarray], duration: int = 5000):
    """Frames encoded as an animated GIF in a ``BytesIO``, ``duration`` milliseconds in
    all (needs Pillow, which matplotlib requires)."""
    import io

    from PIL import Image

    images = [Image.fromarray(np.asarray(f)) for f in frames]
    out = io.BytesIO()
    images[0].save(out, format="gif", save_all=True, append_images=images[1:],
                   duration=duration // max(len(images), 1), loop=0)
    out.seek(0)
    return out

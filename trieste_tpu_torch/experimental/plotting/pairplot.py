"""Scatter-matrix ("pairplot") figures for the loop's diagnostics (counterpart of
:mod:`trieste_tpu.experimental.plotting.pairplot`).

A grid of pairwise scatter plots, with per-dimension histograms on the diagonal, of
observations or query points, each group ("initial", "old", "new", optionally
"(non-dominated)") in its own colour. Pure matplotlib, imported when a figure is made; the
figure is built on the host and handed to :func:`trieste_tpu_torch.logging.pyplot`.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from .plotting import _to_np

_PALETTE = {
    "initial": "tab:green",
    "old": "tab:green",
    "new": "tab:orange",
    "initial (non-dominated)": "tab:purple",
    "old (non-dominated)": "tab:purple",
    "new (non-dominated)": "tab:red",
}
_MARKERS = {"initial": "X", "old": "o", "new": "o"}


def pairplot(
    data: np.ndarray,
    groups: Optional[Sequence[str]] = None,
    labels: Optional[Sequence[str]] = None,
    palette: Optional[Mapping[str, str]] = None,
):
    """A matplotlib scatter matrix of ``data [N, D]`` (a numpy array or a tensor).

    ``groups`` gives each row a group name, whose colour and marker come from the palette:
    initial and old green, new orange, non-dominated purple and red. Returns the figure,
    which the caller closes.
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    data = _to_np(data).astype(float)
    n, d = data.shape
    if groups is None:
        groups = ["old"] * n
    groups = list(groups)
    labels = list(labels) if labels is not None else [f"x{i}" for i in range(d)]
    palette = dict(_PALETTE, **(palette or {}))

    fig, axes = plt.subplots(d, d, figsize=(2.2 * d, 2.2 * d), squeeze=False)
    group_names = sorted(set(groups), key=lambda g: (g.endswith(")"), g))
    for gi in range(d):
        for gj in range(d):
            ax = axes[gi][gj]
            if gi == gj:
                for name in group_names:
                    rows = [k for k, g in enumerate(groups) if g == name]
                    ax.hist(
                        data[rows, gi],
                        bins=min(20, max(5, len(rows))),
                        alpha=0.6,
                        color=palette.get(name, "tab:gray"),
                    )
            else:
                for name in group_names:
                    rows = [k for k, g in enumerate(groups) if g == name]
                    base = name.split(" (")[0]
                    ax.scatter(
                        data[rows, gj],
                        data[rows, gi],
                        s=18,
                        alpha=0.8,
                        color=palette.get(name, "tab:gray"),
                        marker=_MARKERS.get(base, "o"),
                        label=name if (gi, gj) == (0, 1) else None,
                    )
            if gi == d - 1:
                ax.set_xlabel(labels[gj])
            if gj == 0:
                ax.set_ylabel(labels[gi])
    if d > 1:
        handles, names = axes[0][1].get_legend_handles_labels()
        if handles:
            fig.legend(handles, names, loc="upper right", fontsize="small")
    fig.tight_layout()
    return fig


def observation_groups(
    num_initial: int,
    num_old: int,
    num_new: int,
    non_dominated_mask: Optional[np.ndarray] = None,
) -> list[str]:
    """Group labels for the rows of a stacked [initial; old; new] matrix, with
    " (non-dominated)" after those that ``non_dominated_mask`` marks."""
    groups = (
        ["initial"] * num_initial + ["old"] * num_old + ["new"] * num_new
    )
    if non_dominated_mask is not None:
        groups = [
            g + " (non-dominated)" if bool(nd) else g
            for g, nd in zip(groups, non_dominated_mask)
        ]
    return groups

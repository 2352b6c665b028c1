"""Persistence-diagram plotting (port of ``tdax/viz/diagrams.py``).

persim.plot_diagrams as the reference uses it (debug_tda_pipeline.py:139-144):
birth/death scatter per homology dimension, dashed diagonal, dashed
infinity line for essential classes, legend H0/H1/...  Matplotlib only,
imported when a plot is drawn.
"""

from __future__ import annotations

import numpy as np

_COLORS = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728"]


def plot_diagrams(dgms, ax, title: str | None = None):
    finite_all = np.concatenate(
        [d[np.isfinite(d[:, 1])] for d in dgms if len(d)] or [np.zeros((0, 2))])
    has_inf = any(np.isinf(d[:, 1]).any() for d in dgms if len(d))

    if len(finite_all):
        lo = min(0.0, float(finite_all.min()))
        hi = float(finite_all.max())
    else:
        lo, hi = 0.0, 1.0
    span = max(hi - lo, 1e-9)
    pad = span * 0.05
    inf_y = hi + span * 0.1

    ax.plot([lo - pad, hi + pad], [lo - pad, hi + pad], "--", c="gray", lw=1)
    if has_inf:
        ax.plot([lo - pad, hi + pad], [inf_y, inf_y], "--", c="black", lw=0.8)
        ax.annotate(r"$\infty$", (lo - pad, inf_y), textcoords="offset points", xytext=(4, 4))

    for dim, dgm in enumerate(dgms):
        dgm = np.asarray(dgm).reshape(-1, 2)
        if not len(dgm):
            continue
        fin = dgm[np.isfinite(dgm[:, 1])]
        inf = dgm[np.isinf(dgm[:, 1])]
        c = _COLORS[dim % len(_COLORS)]
        label = f"$H_{dim}$"
        if len(fin):
            ax.scatter(fin[:, 0], fin[:, 1], 20, c=c, label=label, zorder=3)
            label = None
        if len(inf):
            ax.scatter(inf[:, 0], [inf_y] * len(inf), 20, c=c, label=label, marker="^",
                       zorder=3)

    ax.set_xlabel("Birth")
    ax.set_ylabel("Death")
    ax.set_xlim(lo - pad, hi + pad)
    ax.set_ylim(lo - pad, inf_y + pad)
    ax.legend(loc="lower right")
    if title:
        ax.set_title(title)
    return ax


def save_diagram_png(dgms, out_path: str, title: str | None = None, figsize=(7, 7)) -> None:
    """Render a diagram straight to PNG through the object-oriented Agg
    canvas: no pyplot global state, so the sweep renders in threads."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    fig = Figure(figsize=figsize)
    FigureCanvasAgg(fig)
    plot_diagrams(dgms, ax=fig.add_subplot(), title=title)
    fig.savefig(out_path)

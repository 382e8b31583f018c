"""Offline snapshots: clouds and trajectories rendered to PNG.

Mirrors `icpx/viz.py` (matplotlib's Agg backend; machines that run the
port are headless). Clouds and poses may live on any device. matplotlib is
imported at call time, so a machine without it raises ImportError only
when asked to render.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from icpx_torch.cloud import PointCloud


def _get_plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# Per-cloud colours follow the reference viewer's scheme: source blue,
# transformed red.
_COLORS = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd"]


def render_clouds(
    path,
    clouds: Sequence[PointCloud],
    labels: Optional[Sequence[str]] = None,
    *,
    max_points: int = 20000,
    point_size: float = 0.5,
    title: str = "",
) -> None:
    """Save a 3-projection (XY / XZ / YZ) scatter snapshot as PNG."""
    plt = _get_plt()
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    planes = [(0, 1, "x", "y"), (0, 2, "x", "z"), (1, 2, "y", "z")]
    for ci, cloud in enumerate(clouds):
        pts = cloud.to_numpy()
        if len(pts) > max_points:
            pts = pts[:: len(pts) // max_points + 1]
        label = labels[ci] if labels else f"cloud {ci}"
        for ax, (a, b, na, nb) in zip(axes, planes):
            ax.scatter(pts[:, a], pts[:, b], s=point_size, c=_COLORS[ci % len(_COLORS)],
                       label=label, alpha=0.6, linewidths=0)
            ax.set_xlabel(na)
            ax.set_ylabel(nb)
            ax.set_aspect("equal", adjustable="datalim")
    axes[0].legend(markerscale=8)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)


def _positions(poses) -> np.ndarray:
    return np.stack([p.t.detach().cpu().numpy() for p in poses])


def render_trajectory(path, poses, gt_poses=None, *, title: str = "trajectory") -> None:
    """Top-down (XY) trajectory plot, optionally against ground truth."""
    plt = _get_plt()
    fig, ax = plt.subplots(figsize=(7, 7))
    t = _positions(poses)
    ax.plot(t[:, 0], t[:, 1], "-o", ms=2.5, label="estimate", color=_COLORS[0])
    if gt_poses is not None:
        g = _positions(gt_poses)
        ax.plot(g[:, 0], g[:, 1], "--", label="ground truth", color=_COLORS[1])
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_aspect("equal", adjustable="datalim")
    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)

"""Degraded-mode guard for the ICP loop.

Mirrors `degenerate_solve_guard` of `icpx/distributed/fault.py`. The
watchdog, stall detection and fault injectors wait for ROADMAP queue 1
step 9.
"""

from __future__ import annotations

import torch

from icpx_torch.geometry.se3 import SE3


def degenerate_solve_guard(transform: SE3, stats, prev_transform: SE3):
    """Reject a solve update whose convergence stats are non-finite or whose
    inlier count collapsed: keep the previous transform instead.

    Returns (transform, ok) with `ok` a 0-d bool tensor; a select, so no
    host sync."""
    ok = (
        torch.isfinite(stats.rmse)
        & torch.isfinite(stats.diff)
        & (stats.inlier_count >= 3.0)
        & torch.isfinite(transform.t).all()
        & torch.isfinite(transform.R).all()
    )
    return SE3(
        R=torch.where(ok, transform.R, prev_transform.R),
        t=torch.where(ok, transform.t, prev_transform.t),
    ), ok

"""Trajectory evaluation: ATE, RPE and the KITTI relative error.

Mirrors `icpx/odometry/evaluate.py`. Poses come as a list of SE3 or one
batched SE3; the results are Python floats.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from icpx_torch.geometry.se3 import SE3
from icpx_torch.registration.horn import horn_align


def _stack(poses) -> SE3:
    if isinstance(poses, SE3):
        return poses
    return SE3(R=torch.stack([p.R for p in poses]), t=torch.stack([p.t for p in poses]))


def _at(T: SE3, i) -> SE3:
    return SE3(R=T.R[i], t=T.t[i])


def ate_rmse(est: Sequence[SE3], gt: Sequence[SE3], *, align: bool = True) -> float:
    """Absolute trajectory error: RMSE of the position residuals after an
    optional rigid (SE(3)) alignment of est onto gt."""
    est_s, gt_s = _stack(est), _stack(gt)
    p, q = est_s.t, gt_s.t.to(est_s.t.device)
    if align:
        p = horn_align(p, q).apply(p)
    err = torch.linalg.vector_norm(p - q, dim=-1).cpu().numpy()
    return float(np.sqrt((err**2).mean()))


def rpe(est: Sequence[SE3], gt: Sequence[SE3], *, delta: int = 1) -> Tuple[float, float]:
    """Relative pose error over `delta`-frame intervals: (translation RMSE,
    rotation RMSE in radians)."""
    est_s, gt_s = _stack(est), _stack(gt)
    gt_s = gt_s.to(est_s.t.device)
    m = est_s.t.shape[0]
    if m <= delta:
        return 0.0, 0.0
    a = torch.arange(0, m - delta, device=est_s.t.device)
    b = a + delta
    rel_est = _at(est_s, a).inverse() @ _at(est_s, b)
    rel_gt = _at(gt_s, a).inverse() @ _at(gt_s, b)
    err = rel_gt.inverse() @ rel_est
    t_err = torch.linalg.vector_norm(err.t, dim=-1).cpu().numpy()
    r_err = err.rotation_angle().cpu().numpy()
    return float(np.sqrt((t_err**2).mean())), float(np.sqrt((r_err**2).mean()))


def kitti_relative_error(
    est: Sequence[SE3],
    gt: Sequence[SE3],
    *,
    lengths: Sequence[float] = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0),
    step: int = 10,
) -> Tuple[float, float]:
    """The KITTI odometry metric (Geiger et al. 2012): translational error
    (a fraction) and rotational error (rad/m), averaged over subsequences
    of the standard lengths starting every `step` frames. (nan, nan) when
    the trajectory is shorter than the shortest length."""
    est_s, gt_s = _stack(est), _stack(gt)
    gt_s = gt_s.to(est_s.t.device)
    gt_t = gt_s.t.cpu().numpy()
    n = gt_t.shape[0]
    seg = np.linalg.norm(np.diff(gt_t, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])

    t_errs, r_errs = [], []
    for first in range(0, n, step):
        for length in lengths:
            last = int(np.searchsorted(cum, cum[first] + length))
            if last >= n:
                continue
            gt_rel = _at(gt_s, first).inverse() @ _at(gt_s, last)
            est_rel = _at(est_s, first).inverse() @ _at(est_s, last)
            err = est_rel.inverse() @ gt_rel
            t_errs.append(float(torch.linalg.vector_norm(err.t)) / length)
            r_errs.append(float(err.rotation_angle()) / length)
    if not t_errs:
        return float("nan"), float("nan")
    return float(np.mean(t_errs)), float(np.mean(r_errs))

"""The per-iteration ICP core: correspondence weights, increment, stats.

Mirrors `icpx/registration/step.py` on a single device. The sharded step
(a collective `reduce` over the points axis, with the histogram quantiles
of `_reduced_quantile`) waits for ROADMAP queue 1 step 9.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icpx_torch.geometry.se3 import SE3
from icpx_torch.registration.linearize import (
    build_normal_equations_gicp,
    build_normal_equations_p2plane,
    build_normal_equations_symmetric,
    mad_scale,
    robust_weight,
)
from icpx_torch.registration.solve import (
    reconstruct_about_point,
    reconstruct_p2plane_transform,
    reconstruct_symmetric_transform,
    solve_damped_6x6,
)

_EPS = 1e-12


def identity_reduce(x):
    """The single-device `reduce` of the reference's step functions; the
    sharded step will take a collective in its place."""
    return x


class StepStats(NamedTuple):
    diff: torch.Tensor  # evalDiff-style sum of corresponded distances
    rmse: torch.Tensor  # inlier euclidean RMSE (post-update)
    inlier_count: torch.Tensor


def correspondence_weights(config, p, n_p, q, n_q, dist, src_mask) -> torch.Tensor:
    """Validity gate + robust IRLS weights for the current correspondences."""
    valid = src_mask & (dist <= config.max_corr_dist) & torch.isfinite(dist)
    vmask = valid.to(torch.float32)
    if config.trim_fraction < 1.0:
        # Trimmed ICP: keep only the closest fraction of correspondences.
        thr = _masked_quantile(dist, vmask, config.trim_fraction)
        valid = valid & (dist <= thr)
        vmask = valid.to(torch.float32)
    if config.robust == "none":
        return vmask
    if config.objective == "symmetric":
        r_w = ((p - q) * (n_p + n_q)).sum(-1).abs()
    elif config.objective == "p2plane":
        r_w = ((p - q) * n_q).sum(-1).abs()
    else:
        r_w = dist
    if config.robust_scale > 0:
        scale = torch.tensor(config.robust_scale, dtype=torch.float32, device=p.device)
    else:
        scale = mad_scale(r_w, vmask)
    return vmask * robust_weight(r_w, config.robust, scale)


def _masked_quantile(x: torch.Tensor, w_valid: torch.Tensor, q: float) -> torch.Tensor:
    """Quantile of x over entries with w_valid > 0: the sorted entry at
    floor(count * q) (count * q in fp32, as the reference computes it)."""
    n = x.shape[0]
    valid = w_valid > 0
    vals = torch.sort(torch.where(valid, x, float("inf"))).values
    cnt = valid.sum().to(torch.float32)
    idx = (cnt * q).to(torch.int64).clamp(0, n - 1)
    return vals[idx]


def estimate_increment(config, p, q, n_p, n_q, w) -> SE3:
    """One Gauss-Newton / closed-form update from weighted correspondences;
    n_p / n_q are normals (N, 3), or flattened covariances (N, 9) for GICP."""
    denom = torch.clamp(w.sum(), min=_EPS)
    p_bar = (p * w[:, None]).sum(0) / denom
    q_bar = (q * w[:, None]).sum(0) / denom

    if config.objective == "p2p":
        # Weighted Kabsch with the det-sign fix against reflections.
        pc = p - p_bar[None, :]
        qc = q - q_bar[None, :]
        S = torch.einsum("n,ni,nj->ij", w, qc, pc) / denom
        U, _, Vt = torch.linalg.svd(S)
        det = torch.linalg.det(U) * torch.linalg.det(Vt)
        D = torch.ones(3, dtype=S.dtype, device=S.device)
        D[2] = torch.sign(det) + (det == 0.0).to(S.dtype)
        R = torch.einsum("ik,k,kj->ij", U, D, Vt)
        return SE3(R=R, t=q_bar - R @ p_bar)

    if config.objective == "gicp":
        ne = build_normal_equations_gicp(p, q, n_p.reshape(-1, 3, 3), n_q.reshape(-1, 3, 3), w, p_bar)
        x = solve_damped_6x6(ne.JtJ, ne.Jtr, config.damping, config.degeneracy_clamp)
        return reconstruct_about_point(x, p_bar)

    if config.objective == "symmetric":
        ne = build_normal_equations_symmetric(p, q, n_p, n_q, w, p_bar, q_bar)
        x = solve_damped_6x6(ne.JtJ, ne.Jtr, config.damping, config.degeneracy_clamp)
        return reconstruct_symmetric_transform(x, p_bar, q_bar)

    ne = build_normal_equations_p2plane(p, q, n_q, w)
    x = solve_damped_6x6(ne.JtJ, ne.Jtr, config.damping, config.degeneracy_clamp)
    return reconstruct_p2plane_transform(x)


def step_stats(config, p_new, q, dist_old, src_mask) -> StepStats:
    """Convergence metrics against the iteration's correspondences."""
    valid = src_mask & (dist_old <= config.max_corr_dist) & torch.isfinite(dist_old)
    vmask = valid.to(torch.float32)
    d_new = torch.linalg.vector_norm(p_new - q, dim=-1)
    count = vmask.sum()
    # clamp only the divisor: the reported count stays truthful
    return StepStats(
        diff=torch.where(valid, d_new, 0.0).sum(),
        rmse=torch.sqrt((vmask * d_new * d_new).sum() / torch.clamp(count, min=1.0)),
        inlier_count=count,
    )

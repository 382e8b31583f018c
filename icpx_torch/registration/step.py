"""The per-iteration ICP core: correspondence weights, increment, stats.

Mirrors `icpx/registration/step.py`, parameterized over the reduction as
the reference is:

  * on one device `reduce` is `identity_reduce`, which changes nothing;
  * sharded over a points axis (`icpx_torch.distributed`) it is a psum
    over that axis's process group (`comm.psum`), so the centroids, the
    6x6 normal equations and the convergence sums are the only traffic an
    iteration, and the robust statistics (the MAD scale, the trim
    quantile) come from psum'd histograms (`_reduced_quantile`) over the
    whole correspondence set, whatever the shard layout.

Hazard: `identity_reduce` is a sentinel. Any other `reduce`, even one over
a single rank, switches the robust statistics to the histogram quantiles,
so a sharded run equals `register()` only where those statistics are exact
(`robust_scale` > 0 or robust "none", and no trimming); with the MAD scale
or trimming it agrees to the histogram's ~1e-4 relative resolution.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

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
from icpx_torch.utils import profiling

_EPS = 1e-12


def identity_reduce(x):
    """The single-device `reduce` (the shared sentinel: robust statistics
    switch to reduced-histogram quantiles iff `reduce` is not this)."""
    return x


class StepStats(NamedTuple):
    diff: torch.Tensor  # evalDiff-style sum of corresponded distances
    rmse: torch.Tensor  # inlier euclidean RMSE (post-update)
    inlier_count: torch.Tensor


def correspondence_weights(config, p, n_p, q, n_q, dist, src_mask,
                           reduce: Callable = identity_reduce) -> torch.Tensor:
    """Validity gate + robust IRLS weights for the current correspondences.

    With a collective `reduce` the MAD scale and the trim quantile are
    taken over the global correspondence set through psum'd histograms
    (`_reduced_quantile`), so the weights do not depend on the shard
    count."""
    sharded = reduce is not identity_reduce
    valid = src_mask & (dist <= config.max_corr_dist) & torch.isfinite(dist)
    vmask = valid.to(torch.float32)
    if config.trim_fraction < 1.0:
        # Trimmed ICP: keep only the closest fraction of correspondences.
        if sharded:
            thr = _reduced_quantile(dist, vmask, config.trim_fraction, reduce)
        else:
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
    elif sharded:
        med = _reduced_quantile(r_w, vmask, 0.5, reduce)
        dev = (r_w - torch.where(torch.isfinite(med), med, 0.0)).abs()
        mad = _reduced_quantile(dev, vmask, 0.5, reduce)
        mad = torch.where(torch.isfinite(mad), mad, 1.0)
        scale = 1.4826 * torch.clamp(mad, min=_EPS)
    else:
        scale = mad_scale(r_w, vmask)
    return vmask * robust_weight(r_w, config.robust, scale)


def _reduced_quantile(x: torch.Tensor, vmask: torch.Tensor, q: float, reduce: Callable,
                      n_bins: int = 128) -> torch.Tensor:
    """Masked quantile over all shards: a two-level psum'd histogram.

    The range is [0, mean + 8 sigma] from reduced moments (values above it
    clamp into the last bin, so extreme-tail quantiles saturate there); two
    refinement levels resolve range / n_bins^2, ~1e-4 relative. The bin
    counts psum to the same totals under any shard layout. +inf when no
    entry is valid. Bin indices are clamped in floating point before the
    integer conversion (the same bins as the reference's convert-then-clip
    for every finite value, saturating for infinite ones)."""
    # Python scalars (cast to float32 by each op, as the reference's f32
    # constants): a scalar tensor made on the card would be a host copy
    # that waits for the queue
    f32 = dict(dtype=torch.float32, device=x.device)
    v = vmask > 0
    xs = torch.where(v, x, 0.0)
    vf = v.to(torch.float32)
    cnt, s1, s2 = reduce((vf.sum(), xs.sum(), (xs * xs).sum()))
    cntc = torch.clamp(cnt, min=1.0)
    mean = s1 / cntc
    var = torch.clamp(s2 / cntc - mean * mean, min=0.0)
    hi = mean + 8.0 * torch.sqrt(var) + _EPS
    lo = torch.zeros((), **f32)
    rank = cnt * q
    for _ in range(2):
        width = torch.clamp(hi - lo, min=_EPS)
        idx = torch.clamp((xs - lo) / width * n_bins, 0.0, n_bins - 1).to(torch.int64)
        # 0/1 counts: exact in any order of adds below 2^24 a bin
        h = reduce(torch.zeros((n_bins,), **f32).index_add_(0, idx, vf))
        csum = torch.cumsum(h, 0)
        b = torch.argmax((csum >= rank).to(torch.int32))  # the first bin reaching the rank
        b = torch.where(csum[n_bins - 1] >= rank, b, n_bins - 1)
        below = torch.where(b > 0, csum[profiling.fetch_int(torch.clamp(b - 1, min=0))], 0.0)
        step = width / n_bins
        bf = b.to(torch.float32)
        lo, hi = lo + bf * step, lo + (bf + 1.0) * step
        rank = rank - below
    return torch.where(cnt > 0, hi, float("inf"))


def _masked_quantile(x: torch.Tensor, w_valid: torch.Tensor, q: float) -> torch.Tensor:
    """Quantile of x over entries with w_valid > 0: the sorted entry at
    floor(count * q) (count * q in fp32, as the reference computes it)."""
    n = x.shape[0]
    valid = w_valid > 0
    vals = torch.sort(torch.where(valid, x, float("inf"))).values
    cnt = valid.sum().to(torch.float32)
    idx = (cnt * q).to(torch.int64).clamp(0, n - 1)
    return vals[profiling.fetch_int(idx)]  # indexing by a 0-d tensor reads it on the host


def estimate_increment(config, p, q, n_p, n_q, w, reduce: Callable = identity_reduce) -> SE3:
    """One Gauss-Newton / closed-form update from weighted correspondences;
    n_p / n_q are normals (N, 3), or flattened covariances (N, 9) for GICP.

    `reduce` sums the local sufficient statistics across a points
    partition (the weighted centroids first, then the 6x6 system or the
    3x3 cross-covariance), so every rank solves the same system and
    returns the same increment."""
    wsum, p_num, q_num = reduce((w.sum(), (p * w[:, None]).sum(0), (q * w[:, None]).sum(0)))
    denom = torch.clamp(wsum, min=_EPS)
    p_bar = p_num / denom
    q_bar = q_num / denom

    if config.objective == "p2p":
        # Weighted Kabsch with the det-sign fix against reflections.
        pc = p - p_bar[None, :]
        qc = q - q_bar[None, :]
        S = reduce(torch.einsum("n,ni,nj->ij", w, qc, pc)) / denom
        U, _, Vt = torch.linalg.svd(S)
        det = torch.linalg.det(U) * torch.linalg.det(Vt)
        D = torch.ones(3, dtype=S.dtype, device=S.device)
        D[2] = torch.sign(det) + (det == 0.0).to(S.dtype)
        R = torch.einsum("ik,k,kj->ij", U, D, Vt)
        return SE3(R=R, t=q_bar - R @ p_bar)

    if config.objective == "gicp":
        ne = build_normal_equations_gicp(p, q, n_p.reshape(-1, 3, 3), n_q.reshape(-1, 3, 3), w, p_bar)
        JtJ, Jtr = reduce((ne.JtJ, ne.Jtr))
        x = solve_damped_6x6(JtJ, Jtr, config.damping, config.degeneracy_clamp)
        return reconstruct_about_point(x, p_bar)

    if config.objective == "symmetric":
        ne = build_normal_equations_symmetric(p, q, n_p, n_q, w, p_bar, q_bar)
        JtJ, Jtr = reduce((ne.JtJ, ne.Jtr))
        x = solve_damped_6x6(JtJ, Jtr, config.damping, config.degeneracy_clamp)
        return reconstruct_symmetric_transform(x, p_bar, q_bar)

    ne = build_normal_equations_p2plane(p, q, n_q, w)
    JtJ, Jtr = reduce((ne.JtJ, ne.Jtr))
    x = solve_damped_6x6(JtJ, Jtr, config.damping, config.degeneracy_clamp)
    return reconstruct_p2plane_transform(x)


def step_stats(config, p_new, q, dist_old, src_mask,
               reduce: Callable = identity_reduce) -> StepStats:
    """Convergence metrics against the iteration's correspondences, summed
    over the partition by `reduce`."""
    valid = src_mask & (dist_old <= config.max_corr_dist) & torch.isfinite(dist_old)
    vmask = valid.to(torch.float32)
    d_new = torch.linalg.vector_norm(p_new - q, dim=-1)
    diff, sq, count = reduce((torch.where(valid, d_new, 0.0).sum(), (vmask * d_new * d_new).sum(),
                              vmask.sum()))
    # clamp only the divisor: the reported count stays truthful
    return StepStats(diff=diff, rmse=torch.sqrt(sq / torch.clamp(count, min=1.0)),
                     inlier_count=count)

"""Residual linearisations -> 6x6 normal equations.

Mirrors `icpx/registration/linearize.py`: symmetric, point-to-plane and
GICP. The symmetric rows follow Rusinkiewicz 2019 on demeaned points:
    r_i = (p~_i - q~_i) . n_i,  J_i = [ (p~_i + q~_i) x n_i , n_i ],
    n_i = n_p_i + n_q_i.
GICP (Segal et al. 2009) weighs r_i = p_i - q_i by W_i = (C_q_i + C_p_i)^-1.
The outputs are plain sums over points.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from icpx_torch.geometry.se3 import skew
from icpx_torch.utils import profiling

_EPS = 1e-12


class NormalEquations(NamedTuple):
    """Sufficient statistics of a linearised registration step."""

    JtJ: torch.Tensor  # (6, 6)
    Jtr: torch.Tensor  # (6,)
    sq_residual_sum: torch.Tensor  # sum w * r^2
    weight_sum: torch.Tensor  # sum w
    p_centroid_num: torch.Tensor  # (3,) sum w * p
    q_centroid_num: torch.Tensor  # (3,) sum w * q


def build_normal_equations_symmetric(p, q, n_p, n_q, w, p_bar, q_bar) -> NormalEquations:
    """Symmetric point-to-plane system for given correspondences; p_bar /
    q_bar are the centroids to demean with."""
    pt = p - p_bar[None, :]
    qt = q - q_bar[None, :]
    n = n_p + n_q
    r = ((pt - qt) * n).sum(-1)
    J = torch.cat([torch.linalg.cross(pt + qt, n, dim=-1), n], dim=-1)
    return _reduce(J, r, w, p, q)


def build_normal_equations_p2plane(p, q, n_q, w) -> NormalEquations:
    """Classic point-to-plane: r_i = (p_i - q_i) . n_q_i,
    J_i = [ p_i x n_q_i , n_q_i ] (small angle about the origin)."""
    r = ((p - q) * n_q).sum(-1)
    J = torch.cat([torch.linalg.cross(p, n_q, dim=-1), n_q], dim=-1)
    return _reduce(J, r, w, p, q)


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched explicit 3x3 inverse (cofactor form); |det| <= 1e-12 is
    replaced by 1e-12."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(det.abs() > _EPS, det, torch.full_like(det, _EPS))
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def build_normal_equations_gicp(p, q, cov_p, cov_q, w, p_bar) -> NormalEquations:
    """Generalized ICP (plane-to-plane): residual r_i = p_i - q_i with the
    per-pair information W_i = (C_q_i + C_p_i)^-1, cov_p in the current
    frame; Jacobian about the demeaned source point J_i = [-[p~_i]_x | I].
    Reconstruction: T = T(p_bar) (exp(w), t) T(-p_bar)."""
    W = inv3x3(cov_q + cov_p)  # (N, 3, 3)
    r = p - q
    S = skew(p - p_bar[None, :])  # [p~]_x
    wW = W * w[:, None, None]
    StW = torch.einsum("nji,njk->nik", S, wW)  # S^T (wW)
    H_rr = torch.einsum("nij,njk->ik", StW, S)
    H_rt = -StW.sum(0)
    H_tt = wW.sum(0)
    g_r = -torch.einsum("nij,nj->i", StW, r)
    g_t = torch.einsum("nij,nj->i", wW, r)
    JtJ = torch.cat([torch.cat([H_rr, H_rt], dim=1), torch.cat([H_rt.T, H_tt], dim=1)], dim=0)
    return NormalEquations(
        JtJ=JtJ,
        Jtr=torch.cat([g_r, g_t]),
        sq_residual_sum=(w * torch.einsum("ni,nij,nj->n", r, W, r)).sum(),
        weight_sum=w.sum(),
        p_centroid_num=(p * w[:, None]).sum(0),
        q_centroid_num=(q * w[:, None]).sum(0),
    )


def _reduce(J, r, w, p, q) -> NormalEquations:
    wJ = J * w[:, None]
    return NormalEquations(
        JtJ=wJ.T @ J,
        Jtr=wJ.T @ r,
        sq_residual_sum=(w * r * r).sum(),
        weight_sum=w.sum(),
        p_centroid_num=(p * w[:, None]).sum(0),
        q_centroid_num=(q * w[:, None]).sum(0),
    )


def weighted_centroids(p, q, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted centroids of corresponded pairs."""
    denom = torch.clamp(w.sum(), min=_EPS)
    return (p * w[:, None]).sum(0) / denom, (q * w[:, None]).sum(0) / denom


# ---- robust weighting ---------------------------------------------------------


def robust_weight(r_abs: torch.Tensor, kind: str, scale) -> torch.Tensor:
    """IRLS weights for |residual| under a robust kernel."""
    s = torch.clamp(torch.as_tensor(scale, dtype=r_abs.dtype, device=r_abs.device), min=_EPS)
    x = r_abs / s
    if kind == "none":
        return torch.ones_like(r_abs)
    if kind == "huber":
        return torch.clamp(1.0 / torch.clamp(x, min=_EPS), max=1.0)
    if kind == "tukey":
        u = torch.clamp(1.0 - x * x, 0.0, 1.0)
        return u * u
    if kind == "welsch":
        return torch.exp(-x * x)
    if kind == "cauchy":
        return 1.0 / (1.0 + x * x)
    raise ValueError(f"unknown robust kernel: {kind}")


def mad_scale(r_abs: torch.Tensor, w_valid: torch.Tensor) -> torch.Tensor:
    """1.4826 * median(|r|) over valid entries — the auto robust scale.

    A masked median by sort: invalid entries sort last as +inf and the
    median is the entry at floor(count / 2) (`torch.median`/`quantile`
    pick or interpolate differently, so they are not used)."""
    n = r_abs.shape[0]
    valid = w_valid > 0
    vals = torch.sort(torch.where(valid, r_abs, float("inf"))).values
    mid = torch.div(valid.sum(), 2, rounding_mode="floor").clamp(0, n - 1)
    med = vals[profiling.fetch_int(mid)]  # indexing by a 0-d tensor reads it on the host
    med = torch.where(torch.isfinite(med), med, torch.ones_like(med))
    return 1.4826 * torch.clamp(med, min=_EPS)

"""Residual linearisations -> 6x6 normal equations.

Mirrors `icpx/registration/linearize.py` (symmetric and point-to-plane;
GICP waits for ROADMAP queue 1 step 6). The symmetric rows follow
Rusinkiewicz 2019 on demeaned points:
    r_i = (p~_i - q~_i) . n_i,  J_i = [ (p~_i + q~_i) x n_i , n_i ],
    n_i = n_p_i + n_q_i.
The outputs are plain sums over points.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

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
    med = vals[mid]
    med = torch.where(torch.isfinite(med), med, torch.ones_like(med))
    return 1.4826 * torch.clamp(med, min=_EPS)

"""Closed-form rigid registration with known correspondences (Horn/Kabsch).

Mirrors `icpx/registration/horn.py`: weighted centroids, the 3x3
cross-covariance, its SVD with the reflection (det) fix, t = q_bar - R p_bar,
mapping src -> dst (q ~= R p + t), with weights and leading batch dims.
The SVD is `torch.linalg.svd` (LAPACK on the CPU, cuSOLVER on the card):
the two may return singular vectors of opposite signs, which leaves R
unchanged while S has rank >= 2, and the det fix keeps R proper in every
case.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from icpx_torch.cloud import DEFAULT_DEVICE
from icpx_torch.geometry.se3 import SE3

_EPS = 1e-12


def horn_align(src, dst, weights: Optional[torch.Tensor] = None, *, device=None) -> SE3:
    """Least-squares rigid fit: argmin_{R,t} sum_i w_i ||R p_i + t - q_i||^2.

    src, dst: (..., N, 3) corresponding points; weights: optional (..., N)
    nonnegative (0 drops a pair). Returns the SE3 mapping src into dst, on
    `device`; when that is None, on src's device for a tensor and on the
    first CUDA device otherwise, as `PointCloud.create` places its input."""
    R, t, _ = _weighted_kabsch(src, dst, weights, with_scale=False, device=device)
    return SE3(R=R, t=t)


def umeyama_align(src, dst, weights: Optional[torch.Tensor] = None, *,
                  device=None) -> Tuple[SE3, torch.Tensor]:
    """Similarity fit (Umeyama): (SE3, scale) with q ~= s R p + t, placed as
    by `horn_align`."""
    R, t, s = _weighted_kabsch(src, dst, weights, with_scale=True, device=device)
    return SE3(R=R, t=t), s


def _weighted_kabsch(src, dst, weights, *, with_scale: bool, device):
    if device is None and torch.is_tensor(src):
        device = src.device
    device = DEFAULT_DEVICE if device is None else torch.device(device)
    src = torch.as_tensor(src, dtype=torch.float32, device=device)
    dst = torch.as_tensor(dst, dtype=torch.float32, device=device)
    if weights is None:
        w = torch.ones(src.shape[:-1], dtype=torch.float32, device=src.device)
    else:
        w = torch.as_tensor(weights, dtype=torch.float32, device=src.device)
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=_EPS)
    wn = w / wsum  # (..., N)

    p_bar = torch.einsum("...n,...ni->...i", wn, src)
    q_bar = torch.einsum("...n,...ni->...i", wn, dst)
    pc = src - p_bar[..., None, :]
    qc = dst - q_bar[..., None, :]

    # cross-covariance S = sum_i w_i q_c p_c^T (3x3)
    S = torch.einsum("...n,...ni,...nj->...ij", wn, qc, pc)
    U, sig, Vt = torch.linalg.svd(S)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    D = torch.ones(S.shape[:-2] + (3,), dtype=S.dtype, device=S.device)
    D[..., 2] = torch.sign(det) + (det == 0.0).to(S.dtype)  # det fix, 0-safe
    R = torch.einsum("...ik,...k,...kj->...ij", U, D, Vt)

    if with_scale:
        var_p = torch.einsum("...n,...ni,...ni->...", wn, pc, pc)
        s = (sig * D).sum(-1) / torch.clamp(var_p, min=_EPS)
    else:
        s = torch.ones(S.shape[:-2], dtype=S.dtype, device=S.device)
    t = q_bar - s[..., None] * torch.einsum("...ij,...j->...i", R, p_bar)
    return R, t, s

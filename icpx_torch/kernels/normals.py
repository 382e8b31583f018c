"""kNN + PCA surface-normal estimation (brute-force neighbourhoods).

Mirrors `icpx/kernels/normals.py` on its `method="brute"` path: for each
point, its k nearest valid neighbours (self included), the weighted 3x3
neighbourhood covariance, and the smallest-eigenvalue direction from the
closed-form solver, oriented toward the viewpoint. `method="auto"`
resolves as in the JAX package — to "block" (radius PCA off the KD tile
index) from BLOCK_THRESHOLD points — and "block" is not ported yet
(ROADMAP queue 1 step 5), so it raises rather than quietly running brute.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from icpx_torch.cloud import PointCloud
from icpx_torch.kernels.eigh3 import smallest_eigenvector_3x3
from icpx_torch.kernels.knn import knn

BLOCK_THRESHOLD = 32768
# Reference-tile width of the neighbourhood kNN. Results do not depend on
# tiling (ties break by index); wide tiles cut the per-tile torch op count.
# Measured on an H100 80GB HBM3 (700 W limit) at 65,536 points, k = 10:
# 812 ms with knn's default 1024 x 4096 tiles, 267 ms with 1024 x 65536.
_KNN_TILE_R = 65536


def _check_method(method: str, n: int) -> None:
    if method == "auto":
        method = "block" if n >= BLOCK_THRESHOLD else "brute"
    if method == "block":
        raise NotImplementedError(
            "block radius-PCA normals are not ported yet (ROADMAP queue 1 "
            f"step 5); pass method='brute' (cloud capacity {n})"
        )
    if method != "brute":
        raise ValueError(f"unknown normal-estimation method {method!r}")


def estimate_normals_xyz(
    xyz: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    k: int = 10,
    viewpoint=(0.0, 0.0, 0.0),
    method: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normals (N, 3) unit, curvature (N,)) for (N, 3) points; curvature is
    PCL's surface variation lambda_0 / (lambda_0 + lambda_1 + lambda_2)."""
    n = xyz.shape[0]
    mask = torch.ones((n,), dtype=torch.bool, device=xyz.device) if mask is None else mask
    _check_method(method, n)
    d2, idx = knn(xyz, xyz, k, ref_mask=mask, tile_r=_KNN_TILE_R)
    neigh = xyz[idx.long()]
    normals, curv = _pca_normals(xyz, neigh, d2, viewpoint)
    normals = torch.where(mask[:, None], normals, 0.0)
    curv = torch.where(mask, curv, 0.0)
    return normals, curv


def _pca_normals(query, neigh, d2, viewpoint):
    """Weighted-PCA normal per query from (N, k, 3) neighbours; neighbours
    with infinite distance are excluded by weight."""
    w = torch.isfinite(d2).to(torch.float32)  # (N, k)
    wsum = torch.clamp(w.sum(1, keepdim=True), min=1.0)
    mean = (neigh * w[..., None]).sum(1, keepdim=True) / wsum[..., None]
    centered = (neigh - mean) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", centered, centered) / wsum[..., None]
    normal, ev = smallest_eigenvector_3x3(cov)
    total = torch.clamp(ev[..., 0] + ev[..., 1] + ev[..., 2], min=1e-20)
    curvature = torch.clamp(ev[..., 0], min=0.0) / total
    vp = torch.as_tensor(viewpoint, dtype=query.dtype, device=query.device)
    flip = (normal * (vp[None, :] - query)).sum(-1) < 0.0
    normal = torch.where(flip[:, None], -normal, normal)
    return normal, curvature


def estimate_normals(
    cloud: PointCloud,
    *,
    k: int = 10,
    viewpoint=(0.0, 0.0, 0.0),
    method: str = "auto",
) -> PointCloud:
    """The cloud with PCA normals attached (k=10 default)."""
    normals, _ = estimate_normals_xyz(
        cloud.xyz, cloud.mask, k=k, viewpoint=viewpoint, method=method
    )
    return cloud.replace(normals=normals)

"""PCA surface normals and GICP covariances: kNN neighbourhoods or radius
moments.

Mirrors `icpx/kernels/normals.py`. `method="brute"`: for each point its k
nearest valid neighbours (self included), the weighted 3x3 neighbourhood
covariance, and the smallest-eigenvalue direction from the closed-form
solver, oriented toward the viewpoint. `method="block"`: radius PCA off a
KD tile index (`_block_radius_cov`), the radius set from k so it holds ~k
surface neighbours; like the reference it takes the plain
`block_radius_moments`, and the union-moments kernel
(`blocknn_cuda.block_radius_moments_fused`) only where
`use_fused_default()` says so, which it does not. `method="auto"` picks
"block" from BLOCK_THRESHOLD points, as in the JAX package. (`register()`
on the block path estimates normals off its own indexes instead,
`registration/icp.py::_index_normals`.) `estimate_covariances` gives each
point the GICP plane-to-plane covariance over the same neighbourhoods.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from icpx_torch.cloud import PointCloud
from icpx_torch.kernels.blocknn import block_radius_moments, build_kd_index
from icpx_torch.kernels.blocknn_cuda import block_radius_moments_fused, use_fused_default
from icpx_torch.kernels.eigh3 import eigh3x3, smallest_eigenvector_3x3
from icpx_torch.kernels.knn import knn
from icpx_torch.kernels.voxel import auto_cell_size
from icpx_torch.utils import profiling

BLOCK_THRESHOLD = 32768
# Reference-tile width of the neighbourhood kNN. Results do not depend on
# tiling (ties break by index); wide tiles cut the per-tile torch op count.
# Measured on an H100 80GB HBM3 (700 W limit) at 65,536 points, k = 10:
# 812 ms with knn's default 1024 x 4096 tiles, 267 ms with 1024 x 65536.
_KNN_TILE_R = 65536


def _resolve_method(method: str, n: int) -> str:
    if method == "auto":
        return "block" if n >= BLOCK_THRESHOLD else "brute"
    if method not in ("brute", "block"):
        raise ValueError(f"unknown normal-estimation method {method!r}")
    return method


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
    if _resolve_method(method, n) == "block":
        cnt, cov = _block_radius_cov(xyz, mask, k)
        normal, ev = smallest_eigenvector_3x3(cov)
        total = torch.clamp(ev[..., 0] + ev[..., 1] + ev[..., 2], min=1e-20)
        curv = torch.clamp(ev[..., 0], min=0.0) / total
        vp = torch.as_tensor(viewpoint, dtype=xyz.dtype, device=xyz.device)
        flip = (normal * (vp[None, :] - xyz)).sum(-1) < 0.0
        normal = torch.where(flip[:, None], -normal, normal)
        ok = cnt >= 3.0  # degenerate neighbourhoods (< 3 points in radius): no normal
        normals = torch.where(ok[:, None], normal, 0.0)
        curv = torch.where(ok, curv, 0.0)
    else:
        d2, idx = knn(xyz, xyz, k, ref_mask=mask, tile_r=_KNN_TILE_R)
        normals, curv = _pca_normals(xyz, xyz[idx.long()], d2, viewpoint)
    normals = torch.where(mask[:, None], normals, 0.0)
    curv = torch.where(mask, curv, 0.0)
    return normals, curv


def _block_radius_cov(xyz: torch.Tensor, mask: torch.Tensor, k: int, *,
                      fused: Optional[bool] = None):
    """(count (N,), cov (N, 3, 3)) in original point order: radius moments
    over a KD index of 128-point tiles, each tile its own query tile, with
    radius = spacing * 3 * sqrt(k / 10) (PCL's `setRadiusSearch` mode).

    `fused` (None: `use_fused_default()`) takes the reference's fused branch,
    the union-moments kernel over groups of 4 tiles, where the tile count
    allows it; it is there for tests and the on-card check, not a user
    option."""
    n = xyz.shape[0]
    idx = build_kd_index(xyz, mask, tile_size=128)
    radius = auto_cell_size(xyz, mask, scale=3.0 * math.sqrt(max(k, 1) / 10.0))
    fused = use_fused_default() if fused is None else fused
    if fused and idx.n_tiles % 4 == 0:
        cnt_s, _, cov_s = block_radius_moments_fused(idx.tiles, idx, radius, k_tiles=8, group=4,
                                                     u_max=32)
    else:
        cnt_s, _, cov_s = block_radius_moments(idx.tiles, idx, radius, k_tiles=8)
    # unsort: sorted position -> original row, pad rows dropped (row n)
    safe = torch.where(idx.order >= 0, idx.order.long(), n)
    cov = torch.zeros((n + 1, 3, 3), dtype=torch.float32, device=xyz.device)
    cnt = torch.zeros((n + 1,), dtype=torch.float32, device=xyz.device)
    cov[safe] = cov_s
    cnt[safe] = cnt_s
    return cnt[:n], cov[:n]


def _knn_cov(neigh, d2):
    """(count (N,), cov (N, 3, 3)) of each query's (N, k, 3) neighbours;
    neighbours with infinite distance are excluded by weight."""
    w = torch.isfinite(d2).to(torch.float32)  # (N, k)
    wsum = torch.clamp(w.sum(1, keepdim=True), min=1.0)
    mean = (neigh * w[..., None]).sum(1, keepdim=True) / wsum[..., None]
    centered = (neigh - mean) * w[..., None]
    return w.sum(1), torch.einsum("nki,nkj->nij", centered, centered) / wsum[..., None]


def _pca_normals(query, neigh, d2, viewpoint):
    """Weighted-PCA normal per query from (N, k, 3) neighbours."""
    _, cov = _knn_cov(neigh, d2)
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
    with profiling.span("icpx.normals"):
        normals, _ = estimate_normals_xyz(
            cloud.xyz, cloud.mask, k=k, viewpoint=viewpoint, method=method
        )
        return cloud.replace(normals=normals)


def _covariances_xyz(xyz: torch.Tensor, mask: torch.Tensor, *, k: int, epsilon: float,
                     method: str, fused: Optional[bool] = None):
    """(GICP covariances (N, 3, 3), smallest-eigenvalue directions (N, 3))
    over kNN ("brute") or radius ("block") neighbourhoods; rows with fewer
    than 3 neighbours, and pad rows, get the identity and a zero normal."""
    n = xyz.shape[0]
    if _resolve_method(method, n) == "block":
        count, cov = _block_radius_cov(xyz, mask, k, fused=fused)
    else:
        d2, idx = knn(xyz, xyz, k, ref_mask=mask, tile_r=_KNN_TILE_R)
        count, cov = _knn_cov(xyz[idx.long()], d2)

    # plane-to-plane regularisation: eigenvalues replaced by (epsilon, 1, 1),
    # confident along the surface, soft along the normal
    _, V = eigh3x3(cov)
    d = torch.tensor([epsilon, 1.0, 1.0], dtype=torch.float32, device=xyz.device)
    reg = torch.einsum("nik,k,njk->nij", V, d, V)
    ok = (count >= 3.0) & mask  # degenerate neighbourhoods: isotropic identity
    eye = torch.eye(3, dtype=torch.float32, device=xyz.device).expand_as(reg)
    reg = torch.where(ok[:, None, None], reg, eye)
    normal = torch.where(ok[:, None], V[..., 0], 0.0)
    return reg, normal


def estimate_covariances(
    cloud: PointCloud,
    *,
    k: int = 20,
    epsilon: float = 1e-3,
    method: str = "auto",
) -> PointCloud:
    """The cloud with GICP-regularised neighbourhood covariances attached
    (Segal et al. 2009: eigenvalues replaced by (epsilon, 1, 1), a
    plane-to-plane information model per point); it also fills normals
    (the smallest-eigenvalue directions, unoriented) where there are none."""
    with profiling.span("icpx.covariances"):
        covs, normal = _covariances_xyz(cloud.xyz, cloud.mask, k=k, epsilon=epsilon,
                                        method=method)
        out = cloud.replace(covs=covs)
        if out.normals is None:
            out = out.replace(normals=torch.where(cloud.mask[:, None], normal, 0.0))
        return out

"""NDT: normal-distributions-transform registration (Biber & Strasser 2003;
Magnusson 2009), point-to-distribution and distribution-to-distribution.

Mirrors `icpx/registration/ndt.py`. The target's KD tiles (`cell_size`
points each, built through the sort kernel on the card) are the NDT cells:
each cell's masked mean and cell-centred covariance, its eigenvalues
clamped to at least `eig_floor` times the largest (Magnusson's
regularisation, through `eigh3x3`). Scoring a source point against its
nearest cell's Gaussian is the GICP objective with the source covariance
shrunk to `point_cov` I, so NDT runs through `register()` with
`objective="gicp"`: a cloud of 16,384 cell means takes the block path and
its fold with the 12-wide payload.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from icpx_torch.cloud import PAD_COORD, PointCloud
from icpx_torch.geometry.se3 import SE3
from icpx_torch.kernels.blocknn import build_kd_index
from icpx_torch.kernels.eigh3 import eigh3x3
from icpx_torch.registration.icp import ICPConfig, ICPResult, register


def ndt_cells(tgt: PointCloud, *, cell_size: int = 64, eig_floor: float = 1e-2,
              min_points: int = 5) -> PointCloud:
    """A cloud of cell means whose `covs` hold the regularised cell
    covariances; cells with fewer than `min_points` points are masked out
    (their covariance is kept, as in the reference)."""
    # centre before the moment expansion (fp32 second moments at large
    # coordinate magnitudes lose the cell structure); the means get the
    # shift back
    center = tgt.centroid()
    idx = build_kd_index(tgt.xyz - center[None, :], tgt.mask, tile_size=cell_size)
    tiles = idx.tiles  # (T, S, 3)
    valid = (idx.order >= 0).reshape(tiles.shape[0], tiles.shape[1])
    cnt = valid.sum(1).to(torch.float32)
    safe = torch.clamp(cnt, min=1.0)
    mu = torch.where(valid[..., None], tiles, 0.0).sum(1) / safe[:, None]
    d = torch.where(valid[..., None], tiles - mu[:, None, :], 0.0)
    cov = torch.einsum("tsi,tsj->tij", d, d) / safe[:, None, None]
    # Magnusson regularisation: lambda_i >= eig_floor * lambda_max
    lam, V = eigh3x3(cov)  # ascending eigenvalues
    lam_max = torch.clamp(lam[..., 2:3], min=1e-12)
    lam_r = torch.maximum(lam, eig_floor * lam_max)
    cov_r = torch.einsum("tik,tk,tjk->tij", V, lam_r, V)
    ok = cnt >= float(min_points)
    return PointCloud(xyz=torch.where(ok[:, None], mu + center[None, :], PAD_COORD), mask=ok,
                      covs=cov_r)


def register_ndt(
    src: PointCloud,
    tgt: PointCloud,
    config: Optional[ICPConfig] = None,
    init: Optional[SE3] = None,
    *,
    cell_size: int = 64,
    eig_floor: float = 1e-2,
    point_cov: float = 1e-4,
    mode: str = "p2d",
) -> ICPResult:
    """Register src onto tgt's NDT cells. "p2d" scores every source point
    (isotropic covariance `point_cov`) against its nearest target cell;
    "d2d" (Stoyanov et al. 2012) collapses both clouds to cells. The
    objective is forced to GICP; the rest of `config` passes through."""
    if mode not in ("p2d", "d2d"):
        raise ValueError("mode must be p2d|d2d")
    if config is None:
        config = ICPConfig(max_iters=30, diff_threshold=0.0, rmse_change_tol=1e-6,
                           robust="huber")
    cells = ndt_cells(tgt, cell_size=cell_size, eig_floor=eig_floor)
    if mode == "d2d":
        src_c = ndt_cells(src, cell_size=cell_size, eig_floor=eig_floor)
    else:
        eye = torch.tensor(point_cov, dtype=torch.float32) * torch.eye(3, dtype=torch.float32)
        src_c = src.replace(covs=eye.to(src.device).expand(src.capacity, 3, 3))
    return register(src_c, cells, dataclasses.replace(config, objective="gicp"), init)

"""Coarse-to-fine multi-resolution ICP.

Mirrors `icpx/registration/pyramid.py`: each level registers
stride-subsampled clouds (every stride-th point of the Morton order, a
spatially stratified sample of static size) with a correspondence gate
that narrows by 2x a level, seeded with the previous level's transform.
Each level is one `register()` call, so a level above the block path's
threshold runs the block kernels and one below it the brute `nn` kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

from icpx_torch.cloud import PAD_COORD, PointCloud
from icpx_torch.geometry.se3 import SE3
from icpx_torch.kernels.blocknn import build_tile_index
from icpx_torch.registration.icp import ICPConfig, ICPResult, register


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Per-level schedule, the reference's fields and defaults. Level 0 is
    the coarsest."""

    levels: int = 3
    subsample: int = 4  # stride factor between levels
    iters_per_level: Tuple[int, ...] = ()  # empty -> base.max_iters each
    base: ICPConfig = ICPConfig()
    # correspondence gate per level as a multiple of the target's extent;
    # overrides base.max_corr_dist except at the finest level when that is
    # finite
    coarse_gate_frac: float = 0.25
    # redescending kernels (tukey/welsch) stall misaligned coarse levels:
    # those levels take this monotone kernel, the finest level the base's
    coarse_robust: str = "huber"


def morton_stratified_subsample(cloud: PointCloud, stride: int) -> PointCloud:
    """Every stride-th point of the Morton order (tiles of 64), with its
    normals, covariances (identity on pad rows) and features."""
    if stride <= 1:
        return cloud
    idx = build_tile_index(cloud.xyz, cloud.mask, tile_size=64)
    order = idx.order[::stride].long()
    valid = order >= 0
    safe = torch.clamp(order, min=0)
    xyz = torch.where(valid[:, None], cloud.xyz[safe], PAD_COORD)
    normals = covs = feats = None
    if cloud.normals is not None:
        normals = torch.where(valid[:, None], cloud.normals[safe], 0.0)
    if cloud.covs is not None:
        eye = torch.eye(3, dtype=torch.float32, device=cloud.device)
        covs = torch.where(valid[:, None, None], cloud.covs[safe], eye)
    if cloud.feats is not None:
        feats = torch.where(valid[:, None], cloud.feats[safe], 0.0)
    return PointCloud(xyz=xyz, mask=valid & cloud.mask[safe], normals=normals, covs=covs,
                      feats=feats, feat_names=cloud.feat_names)


def register_pyramid(
    src: PointCloud,
    tgt: PointCloud,
    config: PyramidConfig = PyramidConfig(),
    init: Optional[SE3] = None,
) -> Tuple[ICPResult, List[ICPResult]]:
    """Coarse-to-fine registration: (the finest level's result, whose
    transform is the full accumulated one, and every level's result)."""
    if init is None:
        init = SE3.identity(device=tgt.device)
    levels = config.levels
    iters = config.iters_per_level or tuple(config.base.max_iters for _ in range(levels))
    if len(iters) != levels:
        raise ValueError("iters_per_level length must equal levels")

    extent = float(tgt.extent())
    results: List[ICPResult] = []
    transform = init
    for lvl in range(levels):
        stride = config.subsample ** (levels - 1 - lvl)
        src_l = morton_stratified_subsample(src, stride)
        tgt_l = morton_stratified_subsample(tgt, stride)
        if lvl == levels - 1 and math.isfinite(config.base.max_corr_dist):
            gate = config.base.max_corr_dist
        else:
            # wide at the coarsest, narrowing by 2x per level
            gate = config.coarse_gate_frac * extent / (2**lvl)
        robust = (config.base.robust
                  if lvl == levels - 1 or config.base.robust in ("none", "huber", "cauchy")
                  else config.coarse_robust)
        cfg_l = dataclasses.replace(config.base, max_iters=iters[lvl], max_corr_dist=float(gate),
                                    robust=robust)
        res = register(src_l, tgt_l, cfg_l, init=transform)
        transform = res.transform
        results.append(res)
    return results[-1], results

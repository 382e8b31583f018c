"""Appearance-based place recognition for loop closure.

Mirrors `icpx/odometry/placerec.py`: a Scan-Context-style polar
descriptor, made with fixed-order segment sums (`utils.segsum`: the same
bits on every run) over one cloud or a batch of clouds:

  * ring features (radial annuli about the sensor): point density, mean
    height, height spread, max height; invariant to sensor yaw, so the
    descriptor distance finds revisits whatever the heading or drift;
  * a sector profile (max height a azimuth bin), whose circular
    cross-correlation between two clouds estimates their relative yaw.

The reference's `vmap` over clouds is a leading batch dimension here.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from icpx_torch.cloud import PointCloud
from icpx_torch.utils.segsum import segment_plan, segment_sum


def place_descriptor(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    *,
    n_rings: int = 12,
    n_sectors: int = 48,
    max_range: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polar place descriptor of a sensor-frame cloud (N, 3), or of a batch
    (B, N, 3) with masks (B, N).

    Returns (ring_desc (..., n_rings, 4), sector_profile (..., n_sectors)):
    ring_desc's columns are [density fraction, mean z, std z, max z]; the
    sector profile is the max height a azimuth bin."""
    batched = xyz.ndim == 3
    if not batched:
        xyz, mask = xyz[None], mask[None]
    b, n, _ = xyz.shape
    dev = xyz.device
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = torch.sqrt(x * x + y * y)
    rv = torch.where(mask, r, 0.0)
    if max_range is None:
        # robust extent: ~the 90th percentile of the ranges
        rs = torch.sort(torch.where(mask, r, -1.0), dim=1).values
        count = torch.clamp(mask.sum(1), min=1)
        pos = torch.clamp((n - count) + (count * 9) // 10, max=n - 1)
        q = torch.clamp(torch.gather(rs, 1, pos[:, None])[:, 0], min=1e-3)
    else:
        q = torch.full((b,), max_range, dtype=torch.float32, device=dev)

    ring = torch.clamp((rv / q[:, None] * n_rings).to(torch.int32), 0, n_rings - 1).long()
    theta = torch.atan2(y, x)
    sector = torch.clamp(((theta + math.pi) / (2.0 * math.pi) * n_sectors).to(torch.int32),
                         0, n_sectors - 1).long()

    f32 = dict(dtype=torch.float32, device=dev)
    w = mask.to(torch.float32)
    zm = torch.where(mask, z, 0.0)
    z_or_ninf = torch.where(mask, z, float("-inf"))
    # a ring's sums over its points in point order (the reference's
    # `.at[ring].add`), one destination a (cloud, ring)
    plan = segment_plan(ring + n_rings * torch.arange(b, device=dev)[:, None], b * n_rings)
    sums = segment_sum(torch.stack([w, zm, zm * zm], -1).reshape(b * n, 3), plan)
    cnt, sz, szz = sums.reshape(b, n_rings, 3).unbind(-1)
    zmax = torch.full((b, n_rings), float("-inf"), **f32).scatter_reduce_(
        1, ring, z_or_ninf, reduce="amax")
    safe = torch.clamp(cnt, min=1.0)
    mean_z = sz / safe
    var_z = torch.clamp(szz / safe - mean_z * mean_z, min=0.0)
    total = torch.clamp(w.sum(1, keepdim=True), min=1.0)
    ring_desc = torch.stack(
        [cnt / total, mean_z, torch.sqrt(var_z), torch.where(torch.isfinite(zmax), zmax, 0.0)],
        dim=-1)

    sec_max = torch.full((b, n_sectors), float("-inf"), **f32).scatter_reduce_(
        1, sector, z_or_ninf, reduce="amax")
    profile = torch.where(torch.isfinite(sec_max), sec_max, 0.0)
    if not batched:
        return ring_desc[0], profile[0]
    return ring_desc, profile


def cloud_descriptor(cloud: PointCloud, **kw):
    return place_descriptor(cloud.xyz, cloud.mask, **kw)


def descriptor_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Scale-normalized L2 between ring descriptors (lower = more alike)."""
    scale = torch.clamp(torch.sqrt(torch.mean(a * a) + torch.mean(b * b)), min=1e-6)
    return torch.sqrt(torch.mean((a - b) ** 2)) / scale


def relative_yaw(profile_a: torch.Tensor, profile_b: torch.Tensor) -> torch.Tensor:
    """The yaw that best aligns cloud b onto cloud a, Rz(yaw) @ b ~ a, by
    circular cross-correlation of the sector profiles; in (-pi, pi]."""
    s = profile_a.shape[0]
    a = profile_a - torch.mean(profile_a)
    b = profile_b - torch.mean(profile_b)
    ar = torch.arange(s, device=a.device)
    idx = (ar[None, :] + ar[:, None]) % s
    corr = (b[idx] * a[None, :]).sum(dim=1)  # corr[k] = sum_i a(i) b(i + k)
    shift = torch.argmax(corr)
    yaw = 2.0 * math.pi * shift.to(torch.float32) / s
    return torch.where(yaw > math.pi, yaw - 2.0 * math.pi, yaw)

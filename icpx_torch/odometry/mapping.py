"""Global map maintenance: a fixed-capacity, voxel-deduplicated map.

Mirrors `icpx/odometry/mapping.py`. Keyframe scans move into the world
frame and merge into a bounded map that keeps at most one point a voxel,
the oldest (a mapped voxel's representative does not churn); past
capacity the oldest points are evicted, so the map follows the vehicle.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from icpx_torch.cloud import DEFAULT_DEVICE, PAD_COORD, PointCloud
from icpx_torch.geometry.se3 import SE3

_INT32_MAX = 2**31 - 1
_BIGC = 2**30  # out-of-range cell coordinate marking invalid rows (sorts last)


@dataclass(frozen=True)
class VoxelMap:
    """Bounded world-frame map with voxel-unique points."""

    xyz: torch.Tensor  # (M, 3), PAD_COORD rows invalid
    normals: torch.Tensor  # (M, 3)
    mask: torch.Tensor  # (M,)
    age: torch.Tensor  # (M,) int32 insertion counter (lower = older)
    cell_size: torch.Tensor  # 0-d float32
    counter: torch.Tensor  # 0-d int32, increasing
    feats: Optional[torch.Tensor] = None  # (M, D) payload channels
    feat_names: Optional[tuple] = None

    @classmethod
    def create(cls, capacity: int, cell_size: float, *, feat_names: Optional[tuple] = None,
               device=DEFAULT_DEVICE) -> "VoxelMap":
        dev = torch.device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        return cls(
            xyz=torch.full((capacity, 3), PAD_COORD, **f32),
            normals=torch.zeros((capacity, 3), **f32),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=dev),
            age=torch.full((capacity,), _INT32_MAX, dtype=torch.int32, device=dev),
            cell_size=torch.tensor(cell_size, **f32),
            counter=torch.zeros((), dtype=torch.int32, device=dev),
            feats=torch.zeros((capacity, len(feat_names)), **f32) if feat_names else None,
            feat_names=tuple(feat_names) if feat_names else None,
        )

    def replace(self, **changes) -> "VoxelMap":
        return replace(self, **changes)

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def num_valid(self) -> torch.Tensor:
        return self.mask.sum().to(torch.int32)

    def as_cloud(self) -> PointCloud:
        return PointCloud(xyz=self.xyz, mask=self.mask, normals=self.normals, feats=self.feats,
                          feat_names=self.feat_names)


def _voxel_coords(xyz: torch.Tensor, inv_cell: torch.Tensor,
                  mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """int32 cell coordinates a axis, _BIGC on invalid rows."""
    c = torch.floor(xyz * inv_cell).to(torch.int32)
    big = torch.full_like(c[:, 0], _BIGC)
    return (torch.where(mask, c[:, 0], big), torch.where(mask, c[:, 1], big),
            torch.where(mask, c[:, 2], big))


def _argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.argsort(x, stable=True)


def insert_scan(vmap: VoxelMap, scan: PointCloud, pose: SE3) -> VoxelMap:
    """Merge a sensor-frame scan (with normals) at `pose` into the map.

    At most one point a voxel, the oldest; past capacity the oldest points
    are evicted. The order is the reference's: chained stable sorts by
    age, then cz, cy and cx, so each voxel's run is contiguous with its
    oldest point first; keepers are then compacted newest first."""
    if scan.normals is None:
        raise ValueError("scan must carry normals")
    if (vmap.feat_names or scan.feat_names) and scan.feat_names != vmap.feat_names:
        raise ValueError(
            f"map payload channels {vmap.feat_names} != scan's {scan.feat_names}; create "
            "the map with matching feat_names (silently dropping a channel would be worse)"
        )
    w_xyz = pose.apply(scan.xyz)
    w_nrm = pose.rotate(scan.normals)

    all_xyz = torch.cat([vmap.xyz, w_xyz])
    all_nrm = torch.cat([vmap.normals, w_nrm])
    all_feat = torch.cat([vmap.feats, scan.feats]) if vmap.feats is not None else None
    all_mask = torch.cat([vmap.mask, scan.mask])
    new_age = (vmap.counter + 1).expand(scan.capacity)
    all_age = torch.cat([vmap.age, new_age])

    inv_cell = 1.0 / vmap.cell_size
    cx, cy, cz = _voxel_coords(all_xyz, inv_cell, all_mask)

    order = _argsort(all_age)
    order = order[_argsort(cz[order])]
    order = order[_argsort(cy[order])]
    order = order[_argsort(cx[order])]
    sx, sy, sz = cx[order], cy[order], cz[order]
    same = (sx[1:] == sx[:-1]) & (sy[1:] == sy[:-1]) & (sz[1:] == sz[:-1])
    is_first = torch.cat([torch.ones((1,), dtype=torch.bool, device=same.device), ~same])
    keep = is_first & (sx < _BIGC)

    # keepers to the front, newest first, so the capacity cut evicts the
    # oldest points; invalid rows sort last
    sort_key = torch.where(keep, -all_age[order], torch.full_like(all_age, _INT32_MAX))
    order2 = _argsort(sort_key)
    sel = order[order2][: vmap.capacity]
    kept = keep[order2][: vmap.capacity]
    k1 = kept[:, None]
    return VoxelMap(
        xyz=torch.where(k1, all_xyz[sel], PAD_COORD),
        normals=torch.where(k1, all_nrm[sel], 0.0),
        mask=kept,
        age=torch.where(kept, all_age[sel], torch.full_like(all_age[sel], _INT32_MAX)),
        cell_size=vmap.cell_size,
        counter=vmap.counter + 1,
        feats=torch.where(k1, all_feat[sel], 0.0) if all_feat is not None else None,
        feat_names=vmap.feat_names,
    )

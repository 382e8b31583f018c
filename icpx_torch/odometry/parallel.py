"""Data-parallel odometry: every consecutive scan pair registers at once
over the mesh's ``pairs`` axis, then the relative poses compose into the
trajectory on the host.

Mirrors `icpx/odometry/parallel.py`. The sequential front ends order
frames by latency (frame k starts from frame k-1's motion); when the
motion between frames is small against the scene, each pair registers
from identity and the sequence becomes one batch: F frames are F - 1
independent registrations, one `sharded_register_pairs` call over the
``pairs`` axis (optionally with the ``points`` axis within each pair).
There is no constant-velocity start and no keyframe gate (every frame is
kept), and composition accumulates drift as scan-to-scan odometry does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from icpx_torch.cloud import PointCloud
from icpx_torch.geometry.se3 import SE3
from icpx_torch.kernels.normals import estimate_covariances, estimate_normals
from icpx_torch.registration.icp import ICPConfig


def batched_pair_seed(
    sx: torch.Tensor,  # (B, N, 3) source scans (sensor frame)
    sm: torch.Tensor,  # (B, N)
    tx: torch.Tensor,  # (B, N, 3) target scans
    tm: torch.Tensor,  # (B, N)
    *,
    n_rings: int = 12,
    n_sectors: int = 48,
    translation: str = "none",
) -> SE3:
    """A cheap global yaw start for each pair of an identity-start batch:
    the sector-profile correlation of `placerec.relative_yaw`, the seed
    loop closure uses for drift-corrupted candidates.

    `translation="centroid"` adds the rotated centroid difference: right
    for full-overlap pairs (two samplings of one surface), biased for
    range-limited LiDAR scans, whose global statistics follow the sensor
    origin; the default seeds the yaw only. Returns the batched SE3 (B,)
    mapping source to target frame."""
    from icpx_torch.odometry.placerec import place_descriptor, relative_yaw

    _, prof_s = place_descriptor(sx, sm, n_rings=n_rings, n_sectors=n_sectors)
    _, prof_t = place_descriptor(tx, tm, n_rings=n_rings, n_sectors=n_sectors)
    # register(src -> tgt): the target profile first, as loop closure's
    # initial guess (tgt ~ Rz(-yaw) src)
    yaw = torch.stack([relative_yaw(prof_t[i], prof_s[i]) for i in range(sx.shape[0])])
    c, s = torch.cos(-yaw), torch.sin(-yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([torch.stack([c, -s, z], dim=-1),
                     torch.stack([s, c, z], dim=-1),
                     torch.stack([z, z, o], dim=-1)], dim=-2)  # (B, 3, 3)
    if translation == "centroid":
        def centroid(x, m):
            denom = torch.clamp(m.sum(1), min=1.0)[:, None]
            return torch.where(m[:, :, None] > 0, x, 0.0).sum(1) / denom

        cs = centroid(sx, sm.to(torch.float32))
        ct = centroid(tx, tm.to(torch.float32))
        t = ct - torch.einsum("bij,bj->bi", R, cs)
    else:
        t = torch.zeros((sx.shape[0], 3), dtype=torch.float32, device=sx.device)
    return SE3(R=R, t=t)


def parallel_odometry(
    frames: Sequence[PointCloud],
    config: ICPConfig,
    mesh,
    *,
    pairs_axis: str = "pairs",
    points_axis: str = "points",
) -> Tuple[List[SE3], List[Tuple[int, int, SE3]], torch.Tensor]:
    """Register all consecutive pairs in parallel: (world poses a frame,
    the measured edges [(i, i + 1, i_T_{i+1})], each pair's final RMSE).

    Frames share one capacity. When the pair count F - 1 does not divide
    by the `pairs_axis` size, the batch is padded by repeating the last
    frame; the padded pairs' results are dropped. Normals (or GICP
    covariances) are estimated for frames that lack them; the poses are
    composed on the host, every rank holding the same trajectory."""
    from icpx_torch.distributed import comm
    from icpx_torch.distributed.sharded_icp import sharded_register_pairs

    f = len(frames)
    if f < 2:
        dev = frames[0].device if frames else torch.device("cpu")
        return ([SE3.identity(device=dev) for _ in range(f)], [],
                torch.zeros((0,), dtype=torch.float32, device=dev))
    if config.objective == "gicp":
        k_cov = max(config.k_normals, 15)
        frames = [fr if fr.covs is not None else estimate_covariances(fr, k=k_cov)
                  for fr in frames]

        def aux(fr):
            return fr.covs.reshape(fr.capacity, 9)
    else:
        frames = [fr if fr.normals is not None else estimate_normals(fr, k=config.k_normals)
                  for fr in frames]

        def aux(fr):
            return fr.normals

    n_pairs = f - 1
    dp = comm.axis_size(mesh.get_group(pairs_axis))
    pad = (-n_pairs) % dp
    srcs = list(frames[1:]) + [frames[-1]] * pad
    tgts = list(frames[:-1]) + [frames[-1]] * pad
    res = sharded_register_pairs(
        torch.stack([fr.xyz for fr in srcs]), torch.stack([fr.mask for fr in srcs]),
        torch.stack([aux(fr) for fr in srcs]), torch.stack([fr.xyz for fr in tgts]),
        torch.stack([fr.mask for fr in tgts]), torch.stack([aux(fr) for fr in tgts]),
        config, mesh, pairs_axis=pairs_axis, points_axis=points_axis,
    )
    poses = [SE3.identity(device=frames[0].device)]
    edges: List[Tuple[int, int, SE3]] = []
    for k in range(n_pairs):
        rel = SE3(R=res.transform.R[k], t=res.transform.t[k])
        edges.append((k, k + 1, rel))
        poses.append(poses[-1] @ rel)
    return poses, edges, res.final_rmse[:n_pairs]

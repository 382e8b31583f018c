"""KITTI odometry ingest and the synthetic LiDAR simulator.

Mirrors `icpx/odometry/kitti.py`. KITTI formats: velodyne scans are raw
float32 (x, y, z, reflectance) quadruples a point; ground-truth poses are
3x4 row-major matrices, one line a frame (`poses/XX.txt`).

The simulator is numpy, drawn from the same generators in the same order
as the JAX package's, so its worlds, trajectories and scans are bit-equal
to the reference's. The one step the reference runs in JAX, moving world
points into the sensor frame (`pose.inverse().apply`), runs here as the
same float32 matrix products in numpy, which give the same bits.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from icpx_torch.cloud import DEFAULT_DEVICE, PointCloud
from icpx_torch.geometry.se3 import SE3
from icpx_torch.interop import se3_from_numpy


def load_kitti_scan(path) -> np.ndarray:
    """One velodyne .bin -> (N, 3) float32 xyz: the native reader
    (`io/native.py`), else numpy."""
    from icpx_torch.io import native

    raw = Path(path).read_bytes()
    out = native.kitti_xyz(raw)
    if out is not None:
        return out
    return np.frombuffer(raw, dtype=np.float32).reshape(-1, 4)[:, :3].copy()


def load_kitti_scan_xyzi(path) -> np.ndarray:
    """One velodyne .bin -> (N, 4) float32 x, y, z, reflectance."""
    return np.fromfile(Path(path), dtype=np.float32).reshape(-1, 4).copy()


def load_kitti_sequence(
    velodyne_dir,
    *,
    max_frames: Optional[int] = None,
    capacity: Optional[int] = None,
    subsample: int = 1,
    with_intensity: bool = False,
    device=DEFAULT_DEVICE,
) -> List[PointCloud]:
    """Scans of a KITTI velodyne directory as same-capacity clouds on
    `device`. `with_intensity` keeps the reflectance channel as the
    clouds' "reflectance" feature column."""
    files = sorted(Path(velodyne_dir).glob("*.bin"))
    if max_frames is not None:
        files = files[:max_frames]
    loader = load_kitti_scan_xyzi if with_intensity else load_kitti_scan
    scans = [loader(f)[::subsample] for f in files]
    if capacity is None:
        cap = max(s.shape[0] for s in scans)
        cap = ((cap + 127) // 128) * 128
    else:
        cap = capacity
    if with_intensity:
        return [PointCloud.create(s[:cap, :3], capacity=cap, feats=s[:cap, 3:4],
                                  feat_names=("reflectance",), device=device) for s in scans]
    return [PointCloud.create(s[:cap], capacity=cap, device=device) for s in scans]


def load_kitti_poses(path, *, device=DEFAULT_DEVICE) -> List[SE3]:
    """KITTI poses file (12 floats a line, 3x4 row-major) -> SE3 list."""
    poses = []
    for line in open(path):
        vals = [float(v) for v in line.split()]
        if len(vals) != 12:
            continue
        m = np.asarray(vals, np.float32).reshape(3, 4)
        poses.append(se3_from_numpy(m[:, :3], m[:, 3], device=device))
    return poses


# ---- synthetic LiDAR simulator ----------------------------------------------


def make_world(
    n_points: int = 200000,
    extent: float = 60.0,
    seed: int = 0,
    n_posts: int = 60,
    ground_frac: float = 0.7,
) -> np.ndarray:
    """Synthetic outdoor world: undulating ground and scattered vertical
    structures (posts, walls), (N, 3) float32. Sparse structures make
    registration degenerate in places; raise `n_posts` for a
    well-constrained scene."""
    rng = np.random.default_rng(seed)
    n_ground = int(n_points * ground_frac)
    g_xy = rng.uniform(-extent, extent, (n_ground, 2)).astype(np.float32)
    g_z = (
        1.5 * np.sin(0.08 * g_xy[:, 0]) * np.cos(0.06 * g_xy[:, 1])
        + 0.2 * np.sin(0.5 * g_xy[:, 1])
    ).astype(np.float32)
    ground = np.column_stack([g_xy, g_z])

    n_struct = n_points - n_ground
    centers = rng.uniform(-extent, extent, (n_posts, 2)).astype(np.float32)
    sizes = rng.uniform(0.3, 3.0, n_posts).astype(np.float32)
    heights = rng.uniform(2.0, 8.0, n_posts).astype(np.float32)
    per = n_struct // n_posts
    pts = []
    for c, s, h in zip(centers, sizes, heights):
        local = rng.uniform(-1, 1, (per, 2)).astype(np.float32) * s
        z = rng.uniform(0, h, per).astype(np.float32)
        pts.append(np.column_stack([c[None, :] + local, z]))
    struct = np.concatenate(pts)[:n_struct]
    return np.concatenate([ground, struct]).astype(np.float32)


def make_trajectory(n_frames: int, *, speed: float = 1.0, turn: float = 0.02,
                    device=DEFAULT_DEVICE) -> List[SE3]:
    """Smooth curving trajectory in the world frame (world_T_frame)."""
    poses = []
    x, y, yaw = 0.0, 0.0, 0.0
    for k in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
        poses.append(se3_from_numpy(R, np.asarray([x, y, 1.5], np.float32), device=device))
        x += speed * np.cos(yaw)
        y += speed * np.sin(yaw)
        yaw += turn * (1.0 + 0.5 * np.sin(0.15 * k))
    return poses


def _to_sensor(pose: SE3, pts: np.ndarray) -> np.ndarray:
    """pose.inverse().apply(pts) as float32 numpy matrix products."""
    R = pose.R.detach().cpu().numpy().astype(np.float32)
    t = pose.t.detach().cpu().numpy().astype(np.float32)
    t_inv = -(R.T @ t)
    return (pts @ R + t_inv[None, :]).astype(np.float32)


def simulate_scans(
    world: np.ndarray,
    trajectory: Sequence[SE3],
    *,
    max_range: float = 25.0,
    points_per_scan: int = 8192,
    noise: float = 0.01,
    seed: int = 0,
    occlusion: bool = False,
    n_beams: int = 64,
    azimuth_bins: int = 2048,
    dropout: float = 0.0,
    with_intensity: bool = False,
    device=DEFAULT_DEVICE,
) -> List[PointCloud]:
    """Sensor-frame scans on `device`: world points within range of each
    pose, moved into the sensor frame, subsampled to a fixed budget, plus
    noise.

    Opt-in sensor pathologies, as in the reference: `occlusion` keeps the
    nearest return in each cell of an `n_beams` x `azimuth_bins` beam grid;
    `dropout` drops each return with that probability; `with_intensity`
    attaches an "intensity" column (height-keyed albedo times range
    attenuation plus noise), drawn from separate generators so the
    geometry stream is the same with or without it."""
    rng = np.random.default_rng(seed)
    frames = []
    cap = ((points_per_scan + 127) // 128) * 128
    albedo = None
    if with_intensity:
        albedo = (
            0.25
            + 0.5 * np.clip(world[:, 2] / 4.0, 0.0, 1.0)
            + 0.05 * np.random.default_rng(seed + 7919).standard_normal(world.shape[0])
        ).astype(np.float32)
    for pose in trajectory:
        center = pose.t.detach().cpu().numpy().astype(np.float32)
        d2 = ((world - center[None, :]) ** 2).sum(1)
        near = np.where(d2 < max_range * max_range)[0]
        pts_s = _to_sensor(pose, world[near])
        if occlusion:
            r = np.sqrt((pts_s**2).sum(1))
            az = np.arctan2(pts_s[:, 1], pts_s[:, 0])
            el = np.arctan2(pts_s[:, 2], np.sqrt((pts_s[:, :2] ** 2).sum(1)))
            col = np.clip(((az + np.pi) / (2 * np.pi) * azimuth_bins).astype(np.int64),
                          0, azimuth_bins - 1)
            # beam rows span the HDL-64's ~[-25, +3] degree window; floor
            # before the cast so below-window returns stay out of row 0
            el_lo, el_hi = np.radians(-25.0), np.radians(3.0)
            row = np.floor((el - el_lo) / (el_hi - el_lo) * n_beams).astype(np.int64)
            in_fov = (row >= 0) & (row < n_beams)
            cell = row * azimuth_bins + col
            o = np.lexsort((r, cell))  # nearest return first in each cell
            o = o[in_fov[o]]
            keep_first = np.ones(len(o), bool)
            keep_first[1:] = cell[o][1:] != cell[o][:-1]
            near_idx = o[keep_first]
        else:
            near_idx = np.arange(len(near))
        if dropout > 0.0 and len(near_idx):
            near_idx = near_idx[rng.uniform(size=len(near_idx)) >= dropout]
        if len(near_idx) > points_per_scan:
            near_idx = rng.choice(near_idx, points_per_scan, replace=False)
        pts = pts_s[near_idx]
        pts = pts + rng.normal(0, noise, pts.shape).astype(np.float32)
        feats = None
        feat_names = ()
        if with_intensity:
            rr = np.sqrt((pts**2).sum(1))
            atten = 1.0 - 0.5 * np.clip(rr / max_range, 0.0, 1.0) ** 2
            irng = np.random.default_rng(seed + 104729 + len(frames))
            inten = (albedo[near[near_idx]] * atten
                     + 0.02 * irng.standard_normal(len(near_idx))).astype(np.float32)
            feats = inten[:, None]
            feat_names = ("intensity",)
        frames.append(PointCloud.create(pts.astype(np.float32), capacity=cap, feats=feats,
                                        feat_names=feat_names, device=device))
    return frames


def write_kitti_sequence(
    velodyne_dir,
    frames: Sequence[PointCloud],
    poses: Optional[Sequence[SE3]] = None,
    *,
    poses_path=None,
) -> None:
    """Write scans and ground truth in KITTI's on-disk formats:
    `NNNNNN.bin` float32 (x, y, z, reflectance) quadruples a scan and a
    poses file of 3x4 row-major world_T_frame lines. Reflectance comes
    from a "reflectance" feature column when the cloud has one, else 0."""
    out = Path(velodyne_dir)
    out.mkdir(parents=True, exist_ok=True)
    for k, fr in enumerate(frames):
        xyz = fr.to_numpy().astype(np.float32)
        refl = np.zeros((xyz.shape[0], 1), np.float32)
        if fr.feats is not None and fr.feat_names and "reflectance" in fr.feat_names:
            col = fr.feat_names.index("reflectance")
            refl = fr.feats_to_numpy()[:, col:col + 1].astype(np.float32)
        np.concatenate([xyz, refl], axis=1).tofile(out / f"{k:06d}.bin")
    if poses is not None:
        if poses_path is None:
            poses_path = out.parent / "poses.txt"
        with open(poses_path, "w") as f:
            for p in poses:
                m = np.concatenate([p.R.detach().cpu().numpy(),
                                    p.t.detach().cpu().numpy()[:, None]], axis=1)
                f.write(" ".join(f"{v:.9e}" for v in m.reshape(-1)) + "\n")

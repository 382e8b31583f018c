"""Frozen copies of the inputs' generators, numpy only.

Each function is a copy of the construction the project's own benchmark and
tests use (`icpx_torch.io.loaders.synthetic_surface`,
`icpx_torch.odometry.kitti.make_world`, `make_trajectory` and
`simulate_scans` without its opt-in pathologies, and `bench.py`'s
ground-truth pair), held here so that a change to the program cannot move
the yardstick. `test_bench_copies.py` holds each copy equal to the
program's function on small inputs.

Seeds: `--seed` is any whole number; `sub_seed(seed, *path)` turns it and a
path of small integers into a 32-bit generator seed, so every pool entry
and every stream gets its own generator.
"""

from __future__ import annotations

import numpy as np


def sub_seed(seed: int, *path: int) -> int:
    """A 32-bit seed drawn from `seed` and `path` (any whole numbers)."""
    entropy = [int(seed) % 2**64, *(int(p) % 2**32 for p in path)]
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


def synthetic_surface(n: int, seed: int = 0) -> np.ndarray:
    """Random smooth 2.5D surface patch with unit-ish extent, (n, 3) f32."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1.0, 1.0, size=(n, 2))
    u, v = uv[:, 0], uv[:, 1]
    z = 0.35 * np.sin(2.1 * u) * np.cos(1.7 * v) + 0.15 * np.sin(4.3 * v)
    return np.stack([u, v, z], axis=-1).astype(np.float32)


def rotation(axis, angle: float) -> np.ndarray:
    """Rodrigues' rotation about a unit `axis` by `angle`, float64 (3, 3)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
    return np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * (K @ K)


def gt_pair(n: int, surface_seed: int, perm_seed: int, *, axis, angle: float, translation):
    """bench.py's flagship pair: a synthetic surface (the source), its image
    under the ground truth (R, t), rows shuffled by a permutation (the
    target): (src (n, 3) f32, tgt (n, 3) f32, perm, R (3, 3) f64, t (3,)
    f64), row i of the target the image of source row perm[i]."""
    src = synthetic_surface(n, seed=surface_seed)
    R, t = rotation(axis, angle), np.asarray(translation, np.float64)
    perm = np.random.default_rng(perm_seed).permutation(n)
    tgt = (src.astype(np.float64) @ R.T + t)[perm].astype(np.float32)
    return src, tgt, perm, R, t


def make_world(n_points: int = 200000, extent: float = 60.0, seed: int = 0,
               n_posts: int = 60, ground_frac: float = 0.7) -> np.ndarray:
    """Synthetic outdoor world: undulating ground and scattered vertical
    structures, (N, 3) float32."""
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


def make_trajectory(n_frames: int, *, speed: float = 1.0, turn: float = 0.02):
    """Smooth curving trajectory, world_T_frame: (R (F, 3, 3) f32, t (F, 3)
    f32)."""
    Rs, ts = [], []
    x, y, yaw = 0.0, 0.0, 0.0
    for k in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        Rs.append(np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32))
        ts.append(np.asarray([x, y, 1.5], np.float32))
        x += speed * np.cos(yaw)
        y += speed * np.sin(yaw)
        yaw += turn * (1.0 + 0.5 * np.sin(0.15 * k))
    return np.stack(Rs), np.stack(ts)


def simulate_scans(world: np.ndarray, R: np.ndarray, t: np.ndarray, *, max_range: float = 25.0,
                   points_per_scan: int = 8192, noise: float = 0.01, seed: int = 0):
    """Sensor-frame scans: world points within range of each pose, moved
    into the sensor frame, subsampled to a fixed budget, plus noise. A list
    of (n_k, 3) float32 arrays, n_k <= points_per_scan."""
    rng = np.random.default_rng(seed)
    frames = []
    for Rk, tk in zip(R, t):
        center = tk.astype(np.float32)
        d2 = ((world - center[None, :]) ** 2).sum(1)
        near = np.where(d2 < max_range * max_range)[0]
        Rf = Rk.astype(np.float32)
        t_inv = -(Rf.T @ center)
        pts_s = (world[near] @ Rf + t_inv[None, :]).astype(np.float32)
        near_idx = np.arange(len(near))
        if len(near_idx) > points_per_scan:
            near_idx = rng.choice(near_idx, points_per_scan, replace=False)
        pts = pts_s[near_idx]
        pts = pts + rng.normal(0, noise, pts.shape).astype(np.float32)
        frames.append(pts.astype(np.float32))
    return frames

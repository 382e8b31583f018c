"""Extension-dispatching cloud load/save plus the demo fixtures.

Mirrors `icpx/io/loaders.py`: ``.pcd``, ``.ply``, ``.txt`` / ``.xyz`` and
KITTI ``.bin`` load by extension, ``.pcd``, ``.ply`` and ``.txt`` /
``.xyz`` save; an unknown extension raises `ValueError`. Scalar payload
fields (intensity, reflectance, rgb, label, curvature, ring, time, ...)
become `PointCloud.feats` columns, and ``.pcd`` saves write them back.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from icpx_torch.cloud import DEFAULT_DEVICE, PointCloud
from icpx_torch.io.pcd import read_pcd, write_pcd
from icpx_torch.io.ply import read_ply, write_ply
from icpx_torch.io.xyz import read_xyz_txt, write_xyz_txt

# Scalar PCD / PLY fields carried into PointCloud.feats, in file order;
# geometry fields and padding are handled separately.
_PAYLOAD_FIELDS = (
    "intensity", "reflectance", "rgb", "rgba", "label", "curvature",
    "ring", "time", "t", "red", "green", "blue", "alpha",
)
_GEOMETRY_FIELDS = ("x", "y", "z", "normal_x", "normal_y", "normal_z",
                    "nx", "ny", "nz", "_", "padding")


def _collect_feats(rec):
    """(feats (n, F) float32, names) of a record's payload fields, or (None,
    None). Integers wider than 2^24 (packed rgba, large labels) are
    skipped: feats are float32 and would round them."""
    names, cols = [], []
    for name in rec:
        if name in ("xyz", "normals"):
            continue
        base = name.lower()
        if base in _GEOMETRY_FIELDS:
            continue
        col = np.asarray(rec[name])
        if col.ndim != 1 or base not in _PAYLOAD_FIELDS:
            continue
        if col.dtype.kind in "iu" and col.size and np.abs(col.astype(np.float64)).max() > 2**24:
            continue
        names.append(base)
        cols.append(col.astype(np.float32))
    if not cols:
        return None, None
    return np.stack(cols, axis=1), tuple(names)


def load_cloud(path, *, capacity: Optional[int] = None, device=DEFAULT_DEVICE) -> PointCloud:
    """Load a cloud from .pcd / .ply / .txt / .xyz / .bin (KITTI) onto
    `device` (default the first CUDA device; pass ``device="cpu"`` for the
    CPU)."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"cloud file not found: {path}")
    ext = path.suffix.lower()
    normals = feats = feat_names = None
    if ext in (".pcd", ".ply"):
        rec = read_pcd(path) if ext == ".pcd" else read_ply(path)
        xyz = rec["xyz"]
        normals = rec.get("normals")
        # All-zero PCD normals (like cat_out.pcd's) mean "no normals": it
        # decides whether `register` estimates them.
        if ext == ".pcd" and normals is not None and not np.any(normals):
            normals = None
        feats, feat_names = _collect_feats(rec)
    elif ext in (".txt", ".xyz"):
        xyz = read_xyz_txt(path)
    elif ext == ".bin":  # KITTI velodyne: float32 x, y, z, reflectance
        raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        xyz = raw[:, :3]
        feats, feat_names = raw[:, 3:4].copy(), ("reflectance",)
    else:
        raise ValueError(f"unsupported cloud extension: {ext}")
    return PointCloud.create(xyz, normals=normals, capacity=capacity, feats=feats,
                             feat_names=feat_names, device=device)


def save_cloud(path, cloud: PointCloud, *, binary: bool = False) -> None:
    """Save the valid points of a cloud to .pcd / .ply / .txt / .xyz by
    extension (normals to .pcd and .ply, payload columns to .pcd)."""
    path = Path(path)
    xyz = cloud.to_numpy()
    normals = cloud.normals_to_numpy()
    ext = path.suffix.lower()
    if ext == ".pcd":
        feats = cloud.feats_to_numpy()
        extra = None
        if feats is not None and cloud.feat_names:
            extra = {name: feats[:, i] for i, name in enumerate(cloud.feat_names)}
        write_pcd(path, xyz, normals=normals, binary=binary, extra_fields=extra)
    elif ext == ".ply":
        write_ply(path, xyz, normals=normals, binary=binary)
    elif ext in (".txt", ".xyz"):
        write_xyz_txt(path, xyz)
    else:
        raise ValueError(f"unsupported cloud extension: {ext}")


# ---- reference fixtures ------------------------------------------------------

_VENDORED_DATA_DIR = Path(__file__).resolve().parent.parent.parent / "tests" / "data"


def reference_data_dir() -> Optional[Path]:
    """Fixture directory: $ICPX_DATA_DIR, else the vendored tests/data."""
    env = os.environ.get("ICPX_DATA_DIR")
    if env:
        return Path(env)
    if (_VENDORED_DATA_DIR / "cat.pcd").exists():
        return _VENDORED_DATA_DIR
    return None


def __getattr__(name):
    # REFERENCE_DATA_DIR resolves at each access, so ICPX_DATA_DIR set
    # after import takes effect
    if name == "REFERENCE_DATA_DIR":
        return reference_data_dir()
    raise AttributeError(name)


def has_reference_data() -> bool:
    d = reference_data_dir()
    return d is not None and (d / "cat.pcd").exists()


def load_cat_pair(
    capacity: Optional[int] = None, *, device=DEFAULT_DEVICE
) -> Tuple[PointCloud, PointCloud]:
    """The reference demo pair cat.pcd / cat_out.pcd (GT = Rz(pi/4)+(2.5,0,0)),
    on `device` (default the first CUDA device).

    Falls back to a synthetic cat-scale cloud and the same GT transform
    when the fixtures are unavailable.
    """
    if has_reference_data():
        d = reference_data_dir()
        src = load_cloud(d / "cat.pcd", capacity=capacity, device=device)
        tgt = load_cloud(d / "cat_out.pcd", capacity=capacity, device=device)
        return src, tgt
    from icpx_torch.geometry.transforms import make_rigid_perturbation, transform_cloud

    src = PointCloud.create(synthetic_cat(3400), capacity=capacity, device=device)
    return src, transform_cloud(src, make_rigid_perturbation(device=src.device))


def load_bunny(capacity: Optional[int] = None, *, device=DEFAULT_DEVICE) -> PointCloud:
    """The 93-point bunny slice fixture (txt2pcd_bunny1.pcd, else za.txt),
    else a synthetic stand-in of that size, on `device`."""
    if has_reference_data():
        for name in ("txt2pcd_bunny1.pcd", "za.txt"):
            p = reference_data_dir() / name
            if p.exists():
                return load_cloud(p, capacity=capacity, device=device)
    return PointCloud.create(synthetic_surface(93, seed=7) * 0.18, capacity=capacity,
                             device=device)


def synthetic_cat(n: int = 3400, seed: int = 0) -> np.ndarray:
    """A cat-scale (extent ~200 units) curved synthetic surface, (n, 3) f32."""
    return synthetic_surface(n, seed=seed) * 100.0


def synthetic_surface(n: int, seed: int = 0) -> np.ndarray:
    """Random smooth 2.5D surface patch with unit-ish extent, (n, 3) f32."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1.0, 1.0, size=(n, 2))
    u, v = uv[:, 0], uv[:, 1]
    z = 0.35 * np.sin(2.1 * u) * np.cos(1.7 * v) + 0.15 * np.sin(4.3 * v)
    return np.stack([u, v, z], axis=-1).astype(np.float32)

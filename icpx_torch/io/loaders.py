"""Extension-dispatching cloud load/save plus the demo fixtures.

Mirrors `icpx/io/loaders.py` for ``.pcd``. ``.ply``, ``.txt``, ``.xyz``
and ``.bin`` (KITTI) wait for ROADMAP queue 1 step 2 and raise
`NotImplementedError`; an unknown extension raises `ValueError` as in the
reference. Payload feature columns are not carried yet (PointCloud has no
`feats` in this slice).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from icpx_torch.cloud import DEFAULT_DEVICE, PointCloud
from icpx_torch.io.pcd import read_pcd, write_pcd

_NOT_PORTED = (".ply", ".txt", ".xyz", ".bin")


def _not_ported(ext: str) -> NotImplementedError:
    return NotImplementedError(
        f"{ext} clouds are not ported yet (ROADMAP queue 1 step 2)"
    )


def load_cloud(path, *, capacity: Optional[int] = None, device=DEFAULT_DEVICE) -> PointCloud:
    """Load a cloud from a ``.pcd`` file onto `device` (default the first
    CUDA device; pass ``device="cpu"`` for the CPU)."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"cloud file not found: {path}")
    ext = path.suffix.lower()
    if ext in _NOT_PORTED:
        raise _not_ported(ext)
    if ext != ".pcd":
        raise ValueError(f"unsupported cloud extension: {ext}")
    rec = read_pcd(path)
    normals = rec.get("normals")
    # All-zero normals in a file (like cat_out.pcd) mean "no normals": it
    # decides whether `register` estimates them.
    if normals is not None and not np.any(normals):
        normals = None
    return PointCloud.create(rec["xyz"], normals=normals, capacity=capacity, device=device)


def save_cloud(path, cloud: PointCloud, *, binary: bool = False) -> None:
    """Save the valid points of a cloud (and its normals) to ``.pcd``."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext in _NOT_PORTED:
        raise _not_ported(ext)
    if ext != ".pcd":
        raise ValueError(f"unsupported cloud extension: {ext}")
    write_pcd(path, cloud.to_numpy(), normals=cloud.normals_to_numpy(), binary=binary)


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

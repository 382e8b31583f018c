"""Cloud-level transform application and the demo ground-truth transform.

Mirrors `icpx/geometry/transforms.py`: points get the full rigid
transform, normals are rotated only.
"""

from __future__ import annotations

import math

import torch

from icpx_torch.cloud import DEFAULT_DEVICE, PointCloud
from icpx_torch.geometry.se3 import SE3


def apply_transform(points: torch.Tensor, transform: SE3) -> torch.Tensor:
    """Rigid-transform (N, 3) points."""
    return transform.apply(points)


def rotate_vectors(vectors: torch.Tensor, transform: SE3) -> torch.Tensor:
    """Rotate (N, 3) direction vectors (normals): rotation only."""
    return transform.rotate(vectors)


def transform_cloud(cloud: PointCloud, transform: SE3) -> PointCloud:
    """Transform a cloud; normals (if any) are rotated, not translated."""
    out = cloud.with_xyz(transform.apply(cloud.xyz))
    if cloud.normals is not None:
        out = out.with_normals(transform.rotate(cloud.normals))
    return out


def make_rigid_perturbation(
    axis=(0.0, 0.0, 1.0),
    angle: float = math.pi / 4,
    translation=(2.5, 0.0, 0.0),
    *,
    device=DEFAULT_DEVICE,
) -> SE3:
    """The demo ground-truth family; defaults are Rz(pi/4) then (2.5, 0, 0),
    the transform that produced the reference's `cat_out.pcd`. On `device`
    (default the first CUDA device)."""
    axis = torch.as_tensor(axis, dtype=torch.float32, device=device)
    axis = axis / torch.linalg.vector_norm(axis)
    return SE3.from_axis_angle(
        axis,
        torch.tensor(angle, dtype=torch.float32, device=device),
        torch.as_tensor(translation, dtype=torch.float32, device=device),
    )

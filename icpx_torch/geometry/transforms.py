"""Cloud-level transform application and the demo ground-truth transform.

Mirrors `icpx/geometry/transforms.py`: points get the full rigid
transform, normals are rotated only.
"""

from __future__ import annotations

import math
from typing import Tuple

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


def perturb_cloud(
    cloud: PointCloud,
    generator: torch.Generator,
    *,
    max_angle: float = 0.3,
    max_trans: float = 0.5,
    noise_sigma: float = 0.0,
) -> Tuple[PointCloud, SE3]:
    """A random rigid perturbation (`SE3.random` from `generator`) and
    optional Gaussian noise of sigma `noise_sigma` on the valid rows:
    (perturbed cloud, ground truth mapping the original onto it), on the
    cloud's device whatever the generator's."""
    gt = SE3.random(generator, max_angle=max_angle, max_trans=max_trans).to(cloud.xyz.device)
    out = transform_cloud(cloud, gt)
    if noise_sigma > 0.0:
        noise = torch.randn(out.xyz.shape, generator=generator, device=generator.device)
        out = out.with_xyz(out.xyz + noise_sigma * noise.to(out.xyz.device))
    return out, gt

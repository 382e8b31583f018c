"""SE(3) rigid transforms as a dataclass of tensors.

Mirrors `icpx/geometry/se3.py`: ``SE3(R, t)`` with optional leading batch
dims and Eigen/matrix composition order,
``(a @ b).apply(x) == a.apply(b.apply(x))``. The small-angle and near-pi
branches of exp/log are kept as they are in the reference, as
`torch.where` selects.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from icpx_torch.cloud import DEFAULT_DEVICE

_EPS = 1e-9
# Tiny bias inside sqrt so norms stay smooth at 0 (primal error 1e-12).
_NORM_TINY = 1e-24


def _safe_norm(x, dim=-1, keepdim=False):
    return torch.sqrt((x * x).sum(dim=dim, keepdim=keepdim) + _NORM_TINY)


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", M, v)


@dataclass(frozen=True)
class SE3:
    """Rigid transform y = R @ x + t. R: (..., 3, 3), t: (..., 3)."""

    R: torch.Tensor
    t: torch.Tensor

    # ---- constructors ------------------------------------------------------

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32, device=DEFAULT_DEVICE) -> "SE3":
        R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
        t = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
        return cls(R=R.clone(), t=t)

    @classmethod
    def from_axis_angle(cls, axis, angle, t=None) -> "SE3":
        R = rotation_from_axis_angle(axis, angle)
        if t is None:
            t = torch.zeros(R.shape[:-2] + (3,), dtype=R.dtype, device=R.device)
        return cls(R=R, t=torch.as_tensor(t, dtype=R.dtype, device=R.device))

    @classmethod
    def exp(cls, twist: torch.Tensor) -> "SE3":
        """SE(3) exponential of a (..., 6) twist [omega, v]."""
        omega, v = twist[..., :3], twist[..., 3:]
        theta = _safe_norm(omega, keepdim=True)
        K = skew(omega / theta.clamp_min(_EPS))
        th = theta[..., None]
        s, c = torch.sin(th), torch.cos(th)
        eye = _eye(twist)
        KK = K @ K
        R = eye + s * K + (1.0 - c) * KK
        # V = I + ((1-cos θ)/θ) K + ((θ - sin θ)/θ) K²   (K from the unit axis)
        small = th < 1e-5
        th_safe = th.clamp_min(_EPS)
        V = eye + ((1.0 - c) / th_safe) * K + (1.0 - s / th_safe) * KK
        V = torch.where(small, eye, V)
        R = torch.where(small, eye + skew(omega), R)
        return cls(R=R, t=_matvec(V, v))

    def log(self) -> torch.Tensor:
        """(..., 6) twist [omega, v] with SE3.exp(log(T)) == T."""
        omega = rotation_log(self.R)
        theta = _safe_norm(omega, keepdim=True)
        K = skew(omega / theta.clamp_min(_EPS))
        th = theta[..., None]
        half = 0.5 * th
        # V^{-1} = I - θ/2 K + (1 - θ/2 cot(θ/2)) K²
        cot_term = 1.0 - half * torch.cos(half) / torch.sin(half).clamp_min(_EPS)
        eye = _eye(self.R)
        Vinv = eye - half * K + cot_term * (K @ K)
        Vinv = torch.where(th < 1e-5, eye - 0.5 * skew(omega), Vinv)
        return torch.cat([omega, _matvec(Vinv, self.t)], dim=-1)

    # ---- ops ---------------------------------------------------------------

    def replace(self, **changes) -> "SE3":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "SE3":
        return SE3(R=self.R.to(device), t=self.t.to(device))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform (..., N, 3) points: R @ p + t."""
        return torch.einsum("...ij,...nj->...ni", self.R, points) + self.t[..., None, :]

    def rotate(self, vectors: torch.Tensor) -> torch.Tensor:
        """Rotate direction vectors / normals — no translation."""
        return torch.einsum("...ij,...nj->...ni", self.R, vectors)

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other: apply `other` first."""
        return SE3(R=self.R @ other.R, t=_matvec(self.R, other.t) + self.t)

    def __matmul__(self, other: "SE3") -> "SE3":
        return self.compose(other)

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(R=Rt, t=-_matvec(Rt, self.t))

    def matrix(self) -> torch.Tensor:
        """(..., 4, 4) homogeneous matrix."""
        m = torch.zeros((*self.t.shape[:-1], 4, 4), dtype=self.R.dtype, device=self.R.device)
        m[..., :3, :3] = self.R
        m[..., :3, 3] = self.t
        m[..., 3, 3] = 1.0
        return m

    # ---- metrics -----------------------------------------------------------

    def rotation_angle(self) -> torch.Tensor:
        """Geodesic rotation magnitude in radians."""
        tr = torch.diagonal(self.R, dim1=-2, dim2=-1).sum(-1)
        return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))

    def distance_to(self, other: "SE3"):
        """(rotation angle, translation distance) between two transforms."""
        rel = self.inverse() @ other
        return rel.rotation_angle(), torch.linalg.vector_norm(rel.t, dim=-1)


# ---- free functions ---------------------------------------------------------


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [v]x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def rotation_from_axis_angle(axis, angle) -> torch.Tensor:
    """Rodrigues: unit axis (..., 3), angle (...) -> (..., 3, 3)."""
    axis = torch.as_tensor(axis, dtype=torch.float32)
    angle = torch.as_tensor(angle, dtype=torch.float32, device=axis.device)
    K = skew(axis)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    return _eye(axis) + s * K + (1.0 - c) * (K @ K)


def rotation_log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) log map -> (..., 3) rotation vector, safe near 0 and pi."""
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    cos_theta = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    # Generic: omega_hat = θ/(2 sinθ) (R - Rᵀ)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = 0.5 * _safe_norm(w)
    theta = torch.atan2(sin_theta, cos_theta)
    th = theta[..., None]
    scale = torch.where(
        th < 1e-5,
        0.5 + th**2 / 12.0,  # series of θ/(2 sinθ)
        th / (2.0 * sin_theta[..., None]).clamp_min(_EPS),
    )
    generic = scale * w
    # Near pi: the axis is the largest column of R + I (each column is a
    # 2 cos^2(θ/2)-scaled axis at θ=π).
    A = R + _eye(R)
    col = torch.argmax(torch.linalg.vector_norm(A, dim=-2), dim=-1)
    idx = col[..., None, None].expand(*A.shape[:-1], 1)
    axis_pi = torch.gather(A, -1, idx)[..., 0]
    axis_pi = axis_pi / torch.linalg.vector_norm(axis_pi, dim=-1, keepdim=True).clamp_min(_EPS)
    # Fix the sign with the skew part (zero exactly at π; any sign is right there)
    sign = torch.where((axis_pi * w).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    near_pi = (math.pi - th) < 1e-3
    return torch.where(near_pi, sign * axis_pi * th, generic)

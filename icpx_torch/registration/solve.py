"""6x6 damped solves + exact transform reconstruction.

Mirrors `icpx/registration/solve.py`: Levenberg-damped Cholesky solve of
the 6x6 normal equations, optional degeneracy clamp, and the paper's exact
reconstruction
    T = T(q_bar) R(a, theta) T(t_til cos(theta)) R(a, theta) T(-p_bar)
with theta = atan(||a_til||), a = a_til / ||a_til||.
"""

from __future__ import annotations

import torch

from icpx_torch.geometry.se3 import SE3, rotation_from_axis_angle

_EPS = 1e-12


def solve_damped_6x6(JtJ, Jtr, damping=1e-6, degeneracy_clamp: float = 0.0) -> torch.Tensor:
    """Solve (JtJ + lambda * diag(JtJ) + eps I) x = -Jtr. Returns (..., 6).

    With `degeneracy_clamp` > 0 the update is projected off eigendirections
    whose eigenvalue is below clamp * max eigenvalue (Zhang & Singh)."""
    diag = torch.diagonal(JtJ, dim1=-2, dim2=-1)
    A = JtJ + torch.diag_embed(damping * diag + 1e-9)
    # cholesky_ex: no host sync on the info flag; a non-SPD system gives a
    # non-finite x, which degenerate_solve_guard rejects.
    L = torch.linalg.cholesky_ex(A).L
    x = torch.cholesky_solve(-Jtr[..., None], L).squeeze(-1)
    if degeneracy_clamp > 0.0:
        w, V = torch.linalg.eigh(A)
        keep = (w > degeneracy_clamp * w[..., -1:]).to(x.dtype)
        x = torch.einsum(
            "...ij,...j->...i", V, keep * torch.einsum("...ij,...i->...j", V, x)
        )
    return x


def _unit_axis(v: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    axis = v / torch.clamp(norm, min=_EPS)[..., None]
    z = torch.tensor([0.0, 0.0, 1.0], dtype=v.dtype, device=v.device).expand_as(axis)
    # zero-rotation case: a fixed axis (the angle is 0 anyway)
    return torch.where(norm[..., None] > _EPS, axis, z)


def reconstruct_symmetric_transform(x, p_bar, q_bar) -> SE3:
    """Exact SE(3) from the symmetric solve x = [a_til, t_til]."""
    a_til, t_til = x[..., :3], x[..., 3:]
    norm_a = torch.linalg.vector_norm(a_til, dim=-1)
    theta = torch.arctan(norm_a)
    R_half = rotation_from_axis_angle(_unit_axis(a_til, norm_a), theta)
    ct = torch.cos(theta)[..., None]
    # applied to a point x:  R (R (x - p_bar) + t_til cos(theta)) + q_bar
    first = SE3(R=R_half, t=torch.einsum("...ij,...j->...i", R_half, -p_bar))
    second = SE3(R=R_half, t=torch.einsum("...ij,...j->...i", R_half, t_til * ct))
    lift = SE3.identity(batch_shape=x.shape[:-1], dtype=x.dtype, device=x.device).replace(
        t=q_bar + torch.zeros_like(t_til)
    )
    return lift @ second @ first


def reconstruct_about_point(x, p_bar) -> SE3:
    """SE(3) from x = [omega, t] linearised about p_bar:
    p' = p_bar + R (p - p_bar) + t  =>  T = (R, t + p_bar - R p_bar)."""
    omega, t = x[..., :3], x[..., 3:]
    angle = torch.linalg.vector_norm(omega, dim=-1)
    R = rotation_from_axis_angle(_unit_axis(omega, angle), angle)
    return SE3(R=R, t=t + p_bar - torch.einsum("...ij,...j->...i", R, p_bar))


def reconstruct_p2plane_transform(x) -> SE3:
    """SE(3) from the point-to-plane solve x = [omega, t]:
    R = exp([omega]_x), t as is."""
    omega, t = x[..., :3], x[..., 3:]
    angle = torch.linalg.vector_norm(omega, dim=-1)
    return SE3(R=rotation_from_axis_angle(_unit_axis(omega, angle), angle), t=t)

"""Closed-form 3x3 symmetric eigendecomposition, batched and branchless.

Mirrors `icpx/kernels/eigh3.py`: the analytic trigonometric method (Smith
1961 / Eberly) as elementwise fp32 math on six (N,) component vectors
(structure of arrays), with thin (..., 3, 3) wrappers for the public API.
The eigenvector normalisation is scale-invariant: it divides by the
largest component before taking the norm, so millimetre-spacing
neighbourhoods (cross products ~1e-12) never hit the isotropic fallback.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_EPS = 1e-12


def _unpack(A: torch.Tensor):
    return (
        A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2],
    )


def eigvalsh3x3_soa(a00, a01, a02, a11, a12, a22):
    """Eigenvalues (ascending, 3-tuple of (...,)) of the symmetric
    matrices [[a00,a01,a02],[a01,a11,a12],[a02,a12,a22]]."""
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    p_safe = torch.clamp(p, min=_EPS)
    # det(B)/2 with B = (A - qI)/p
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    ) / (p_safe * p_safe * p_safe)
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    # Degenerate (p ~ 0): the matrix is (numerically) q*I.
    isdiag = p < _EPS
    e_lo = torch.where(isdiag, q, e_lo)
    e_mid = torch.where(isdiag, q, e_mid)
    e_hi = torch.where(isdiag, q, e_hi)
    return e_lo, e_mid, e_hi


def _eigenvector_soa(a00, a01, a02, a11, a12, a22, lam):
    """Unit eigenvector for eigenvalue lam as (vx, vy, vz).

    Rows of (A - lam I) span the complement of the eigenvector, so row
    cross products lie along it; take the largest, with a fixed fallback
    for the isotropic case."""
    b00, b11, b22 = a00 - lam, a11 - lam, a22 - lam
    c01x = a01 * a12 - a02 * b11
    c01y = a02 * a01 - b00 * a12
    c01z = b00 * b11 - a01 * a01
    c02x = a01 * b22 - a02 * a12
    c02y = a02 * a02 - b00 * b22
    c02z = b00 * a12 - a01 * a02
    c12x = b11 * b22 - a12 * a12
    c12y = a12 * a02 - a01 * b22
    c12z = a01 * a12 - b11 * a02
    n01 = c01x * c01x + c01y * c01y + c01z * c01z
    n02 = c02x * c02x + c02y * c02y + c02z * c02z
    n12 = c12x * c12x + c12y * c12y + c12z * c12z
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = (~use01) & (n02 >= n12)

    def pick(x01, x02, x12):
        return torch.where(use01, x01, torch.where(use02, x02, x12))

    vx = pick(c01x, c02x, c12x)
    vy = pick(c01y, c02y, c12y)
    vz = pick(c01z, c02z, c12z)
    # Scale-invariant normalisation (no absolute epsilon on the norm):
    # dividing by the largest component puts the norm in [1, sqrt(3)].
    m = torch.maximum(torch.maximum(vx.abs(), vy.abs()), vz.abs())
    ok = m > 1e-30
    m_safe = torch.where(ok, m, torch.ones_like(m))
    ux, uy, uz = vx / m_safe, vy / m_safe, vz / m_safe
    inv = 1.0 / torch.sqrt(ux * ux + uy * uy + uz * uz)
    # Isotropic fallback: any unit vector is an eigenvector.
    vx = torch.where(ok, ux * inv, 0.0)
    vy = torch.where(ok, uy * inv, 0.0)
    vz = torch.where(ok, uz * inv, 1.0)
    return vx, vy, vz


def smallest_eigenvector_3x3_soa(a00, a01, a02, a11, a12, a22):
    """((vx, vy, vz), (e_lo, e_mid, e_hi)) from covariance components."""
    e_lo, e_mid, e_hi = eigvalsh3x3_soa(a00, a01, a02, a11, a12, a22)
    v = _eigenvector_soa(a00, a01, a02, a11, a12, a22, e_lo)
    return v, (e_lo, e_mid, e_hi)


def eigh3x3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigvals (..., 3) ascending, eigvecs (..., 3, 3)) of symmetric
    (..., 3, 3) matrices, with eigvecs[..., :, i] the i-th eigenvector."""
    comps = _unpack(A)
    e_lo, e_mid, e_hi = eigvalsh3x3_soa(*comps)
    v0 = torch.stack(_eigenvector_soa(*comps, e_lo), dim=-1)
    v2 = torch.stack(_eigenvector_soa(*comps, e_hi), dim=-1)
    # Middle eigenvector: the orthogonal complement.
    v1 = torch.linalg.cross(v2, v0, dim=-1)
    v1 = v1 / torch.linalg.vector_norm(v1, dim=-1, keepdim=True).clamp_min(_EPS)
    V = torch.stack([v0, v1, v2], dim=-1)
    return torch.stack([e_lo, e_mid, e_hi], dim=-1), V


def eigvalsh3x3(A) -> torch.Tensor:
    """Eigenvalues (ascending) of symmetric (..., 3, 3) matrices."""
    e_lo, e_mid, e_hi = eigvalsh3x3_soa(*_unpack(torch.as_tensor(A)))
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def smallest_eigenvector_3x3(A) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unit eigenvector of the smallest eigenvalue, eigenvalues ascending):
    the normal-estimation primitive."""
    comps = _unpack(torch.as_tensor(A))
    (vx, vy, vz), (e_lo, e_mid, e_hi) = smallest_eigenvector_3x3_soa(*comps)
    return torch.stack([vx, vy, vz], dim=-1), torch.stack([e_lo, e_mid, e_hi], dim=-1)

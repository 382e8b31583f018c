"""The plain reference: registration of the configured semantics,
independent of the program.

It imports numpy, scipy's KD tree (exact nearest neighbours and exact
radius neighbourhoods) and torch (float64 arithmetic on whatever device it
is given), and nothing of the program; it takes the inputs the benchmark
made and works out everything else itself: neighbourhood radii, normals,
GICP covariances, correspondences, weights, normal equations and solves.

What it follows from the project's documented semantics:

* neighbourhoods: from 32,768 rows, every valid point within radius r of
  a point (itself included), r = 3 sqrt(k / 10) x the median
  nearest-neighbour spacing of a strided sample of 1,024 rows, corrected by
  sqrt(stride); below that, the k nearest valid points;
* normals: the smallest-eigenvalue direction of the neighbourhood's
  covariance, turned toward the viewpoint; fewer than 3 neighbours: none;
* GICP covariances (Segal et al. 2009): the eigenvalues replaced by
  (epsilon, 1, 1); fewer than 3 neighbours: the identity;
* ICP: both clouds centred on the target's valid centroid; correspondences
  the exact nearest valid target point; the distance gate, the robust
  weights (Huber on the MAD scale), the symmetric objective (Rusinkiewicz
  2019) or GICP, the damped 6x6 solve and the exact reconstruction, the
  post-update statistics and the stop rules (rmse change, iteration cap,
  rejected updates), and an optional coarse phase on every stride-th source
  row.

All of it runs in float64. A control may ask for less
(`working_precision`): the same arithmetic in float32, with or without
TF32 matrix products; the KD tree's neighbours stay exact.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from scipy.spatial import cKDTree

# The working precision: float64 unless a control asks for less
# (`working_precision`)
REAL = torch.float64
_EPS = 1e-12
# Clouds of this many rows or more take radius neighbourhoods, smaller ones
# the k nearest (the project's documented split for normals and covariances)
RADIUS_FROM = 32768


def _tree(pts: np.ndarray) -> cKDTree:
    return cKDTree(pts, balanced_tree=False, compact_nodes=False)


@contextmanager
def working_precision(name: str):
    """Run the reference in "float64" (its own), "float32" (TF32 off) or
    "tf32" (float32, matrix products in TF32) inside the block."""
    global REAL
    if name not in ("float64", "float32", "tf32"):
        raise ValueError(f"working precision {name!r}")
    old = REAL, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    REAL = torch.float64 if name == "float64" else torch.float32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = name == "tf32"
    try:
        yield
    finally:
        REAL, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ---- neighbourhoods ----------------------------------------------------------------------


def neighbour_radius(xyz: np.ndarray, valid: np.ndarray, k: int, sample: int = 1024) -> float:
    """3 sqrt(k / 10) x the median nearest-neighbour spacing of every
    stride-th row (the first `sample` of them), / sqrt(stride)."""
    n = xyz.shape[0]
    stride = max(n // sample, 1)
    sub = xyz[::stride][:sample].astype(np.float64)
    pts = sub[valid[::stride][:sample]]
    if len(pts) < 2:
        return 1e-6
    d, _ = _tree(pts).query(pts, k=2)
    spacing = float(np.median(d[:, 1])) / max(math.sqrt(stride), 1.0)
    return max(3.0 * math.sqrt(max(k, 1) / 10.0) * spacing, 1e-6)


def neighbourhoods(xyz: np.ndarray, valid: np.ndarray, radius: float, device,
                   k_start: int = 24, chunk: int = 65536):
    """(count (n,), covariance (n, 3, 3)) of each valid row's valid
    neighbours within `radius`, as float64 tensors on `device`; invalid
    rows get count 0. The KD tree's bounded k-query is redone with twice
    the k for every row whose k-th neighbour was still inside the radius,
    so no neighbourhood is cut short."""
    n = xyz.shape[0]
    pts = xyz[valid].astype(np.float64)
    m = len(pts)
    count = torch.zeros((n,), dtype=REAL, device=device)
    cov = torch.zeros((n, 3, 3), dtype=REAL, device=device)
    if m == 0:
        return count, cov
    tree = _tree(pts)
    pts_pad = torch.as_tensor(np.concatenate([pts, np.zeros((1, 3))]), dtype=REAL, device=device)
    todo = np.nonzero(valid)[0]
    k = k_start
    while todo.size:
        k = min(k, m)
        _, j = tree.query(xyz[todo].astype(np.float64), k=k, distance_upper_bound=radius,
                          workers=-1)
        j = j.reshape(len(todo), k)
        done = (j[:, -1] >= m) | (k == m)
        rows, jd = todo[done], j[done]
        for a in range(0, len(rows), chunk):
            jj = torch.as_tensor(jd[a:a + chunk], device=device)
            w = (jj < m).to(REAL)
            nb = pts_pad[jj]
            cnt = w.sum(1)
            mean = (nb * w[..., None]).sum(1) / cnt[:, None].clamp(min=1.0)
            c = nb - mean[:, None, :]
            r = torch.as_tensor(rows[a:a + chunk], device=device)
            cov[r] = torch.einsum("nk,nki,nkj->nij", w, c, c) / cnt[:, None, None].clamp(min=1.0)
            count[r] = cnt
        todo = todo[~done]
        k *= 2
    return count, cov


def knn_neighbourhoods(xyz: np.ndarray, valid: np.ndarray, k: int, device):
    """(count (n,), covariance (n, 3, 3)) of each row's k nearest valid
    rows (itself included where valid), float64 on `device`."""
    n = xyz.shape[0]
    pts = xyz[valid].astype(np.float64)
    kk = min(k, len(pts))
    _, j = _tree(pts).query(xyz.astype(np.float64), k=kk, workers=-1)
    nb = torch.as_tensor(pts, dtype=REAL, device=device)[torch.as_tensor(j.reshape(n, kk),
                                                                        device=device)]
    mean = nb.mean(1)
    c = nb - mean[:, None, :]
    cov = torch.einsum("nki,nkj->nij", c, c) / kk
    count = torch.full((n,), float(kk), dtype=REAL, device=device)
    return torch.where(torch.as_tensor(valid, device=device), count, 0.0), cov


def _moments(xyz: np.ndarray, valid: np.ndarray, k: int, device):
    """Radius neighbourhoods from RADIUS_FROM rows, else the k nearest."""
    if xyz.shape[0] >= RADIUS_FROM:
        return neighbourhoods(xyz, valid, neighbour_radius(xyz, valid, k), device)
    return knn_neighbourhoods(xyz, valid, k, device)


def _cof(M: torch.Tensor):
    a, b, c = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
    d, e, f = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
    g, h, i = M[:, 2, 0], M[:, 2, 1], M[:, 2, 2]
    return (a, b, c, d, e, f, g, h, i), (e * i - f * h, f * g - d * i, d * h - e * g)


def _det3(M: torch.Tensor) -> torch.Tensor:
    (a, b, c, *_), (A, B, C) = _cof(M)
    return a * A + b * B + c * C


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched 3 x 3 inverse by cofactors (the matrices here are
    regularised covariances, never near singular)."""
    (a, b, c, d, e, f, g, h, i), (A, B, C) = _cof(M)
    adj = torch.stack([
        torch.stack([A, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([C, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / (a * A + b * B + c * C)[:, None, None]


def smallest_eigenvector(A: torch.Tensor) -> torch.Tensor:
    """(n, 3) unit eigenvectors of the smallest eigenvalues of (n, 3, 3)
    symmetric matrices, in closed form (Smith 1961): the eigenvalue from
    the trigonometric solution of the characteristic cubic, the vector the
    largest cross product of two rows of A - lambda I. An isotropic matrix
    gets e_z."""
    a00, a11, a22 = A[:, 0, 0], A[:, 1, 1], A[:, 2, 2]
    a01, a02, a12 = A[:, 0, 1], A[:, 0, 2], A[:, 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(p2 / 6.0)
    ps = torch.where(p > 0, p, 1.0)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = (A - q[:, None, None] * eye) / ps[:, None, None]
    r = torch.clamp(_det3(B) / 2.0, -1.0, 1.0)
    lam = q + 2.0 * p * torch.cos(torch.arccos(r) / 3.0 + 2.0 * math.pi / 3.0)
    M = A - lam[:, None, None] * eye
    c = torch.stack([torch.linalg.cross(M[:, 0], M[:, 1], dim=-1),
                     torch.linalg.cross(M[:, 0], M[:, 2], dim=-1),
                     torch.linalg.cross(M[:, 1], M[:, 2], dim=-1)], dim=1)
    norms = torch.linalg.vector_norm(c, dim=-1)
    best = torch.argmax(norms, dim=1)
    v = c[torch.arange(len(A), device=A.device), best]
    nv = norms.max(dim=1).values
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device)
    return torch.where((nv > 0)[:, None], v / torch.where(nv > 0, nv, 1.0)[:, None], ez)


def normals(xyz: np.ndarray, valid: np.ndarray, k: int, device, viewpoint=(0.0, 0.0, 0.0)):
    """(n, 3) float64 unit normals on `device`, 0 where a row has fewer
    than 3 neighbours or is invalid."""
    count, cov = _moments(xyz, valid, k, device)
    nrm = smallest_eigenvector(cov)
    x = torch.as_tensor(xyz, dtype=REAL, device=device)
    vp = torch.as_tensor(viewpoint, dtype=REAL, device=device)
    flip = (nrm * (vp[None, :] - x)).sum(-1) < 0.0
    nrm = torch.where(flip[:, None], -nrm, nrm)
    return torch.where((count >= 3.0)[:, None], nrm, 0.0)


def gicp_covariances(xyz: np.ndarray, valid: np.ndarray, k: int, device, epsilon: float = 1e-3):
    """(n, 3, 3) float64 plane-to-plane covariances on `device`: the
    neighbourhood's eigenvalues replaced by (epsilon, 1, 1); the identity
    where a row has fewer than 3 neighbours or is invalid."""
    count, cov = _moments(xyz, valid, k, device)
    v0 = smallest_eigenvector(cov)
    eye = torch.eye(3, dtype=REAL, device=device).expand(len(v0), 3, 3)
    # V diag(epsilon, 1, 1) V^T = I - (1 - epsilon) v0 v0^T
    reg = eye - (1.0 - epsilon) * v0[:, :, None] * v0[:, None, :]
    return torch.where((count >= 3.0)[:, None, None], reg, eye)


# ---- rigid transforms (4 x 4 float64 numpy) ----------------------------------------------


def rot(axis: np.ndarray, angle: float) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    K = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
    return np.eye(3) + math.sin(angle) * K + (1.0 - math.cos(angle)) * (K @ K)


def se3(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


def inv(T: np.ndarray) -> np.ndarray:
    return se3(T[:3, :3].T, -T[:3, :3].T @ T[:3, 3])


def _axis_angle(v: np.ndarray):
    n = float(np.linalg.norm(v))
    return (v / n if n > _EPS else np.array([0.0, 0.0, 1.0])), n


def rotation_angle(R: np.ndarray) -> float:
    """The angle of a rotation, from its skew part where it is small (the
    trace form cannot resolve angles below ~1e-4 rad)."""
    w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = float(np.linalg.norm(w))
    c = 0.5 * (float(np.trace(R)) - 1.0)
    return math.atan2(s, c)


def gap(a: np.ndarray, b: np.ndarray):
    """(rotation angle, translation distance) between two transforms."""
    return rotation_angle(a[:3, :3].T @ b[:3, :3]), float(np.linalg.norm(a[:3, 3] - b[:3, 3]))


# ---- ICP ---------------------------------------------------------------------------------


@dataclass(frozen=True)
class Settings:
    """The configured ICP semantics."""

    objective: str = "symmetric"  # symmetric | gicp
    max_iters: int = 10
    rmse_change_tol: float = 0.0
    diff_threshold: float = 0.0
    max_corr_dist: float = float("inf")
    robust: str = "none"  # none | huber
    damping: float = 1e-6
    coarse_iters: int = 0
    coarse_stride: int = 1


@dataclass
class Answer:
    T: np.ndarray  # (4, 4) float64, target ~ T(source)
    rmse: float
    iters: int


def _mad_scale(r: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    vals = torch.sort(torch.where(valid, r, float("inf"))).values
    mid = int(valid.sum()) // 2
    med = vals[min(mid, r.shape[0] - 1)]
    med = med if bool(torch.isfinite(med)) else torch.ones_like(med)
    return 1.4826 * torch.clamp(med, min=_EPS)


def _weights(s: Settings, p, q, n_p, n_q, dist, valid):
    vmask = valid.to(REAL)
    if s.robust == "none":
        return vmask
    if s.robust != "huber":
        raise ValueError(f"robust kernel {s.robust!r} is not in the reference")
    if s.objective == "symmetric":
        r = ((p - q) * (n_p + n_q)).sum(-1).abs()
    else:
        r = dist
    x = r / _mad_scale(r, valid)
    return vmask * torch.clamp(1.0 / torch.clamp(x, min=_EPS), max=1.0)


def _solve(JtJ: np.ndarray, Jtr: np.ndarray, damping: float) -> np.ndarray:
    A = JtJ + np.diag(damping * np.diag(JtJ) + 1e-9)
    dt = np.float64 if REAL == torch.float64 else np.float32
    return np.linalg.solve(A.astype(dt), -Jtr.astype(dt)).astype(np.float64)


def _increment(s: Settings, p, q, n_p, n_q, w) -> np.ndarray:
    wsum = float(w.sum())
    denom = max(wsum, _EPS)
    p_bar = (p * w[:, None]).sum(0) / denom
    q_bar = (q * w[:, None]).sum(0) / denom
    if s.objective == "symmetric":
        pt, qt = p - p_bar, q - q_bar
        n = n_p + n_q
        r = ((pt - qt) * n).sum(-1)
        J = torch.cat([torch.linalg.cross(pt + qt, n, dim=-1), n], dim=-1)
        wJ = J * w[:, None]
        x = _solve((wJ.T @ J).cpu().numpy(), (wJ.T @ r).cpu().numpy(), s.damping)
        axis, norm = _axis_angle(x[:3])
        theta = math.atan(norm)
        Rh = rot(axis, theta)
        pb, qb = p_bar.cpu().numpy(), q_bar.cpu().numpy()
        # x -> Rh (Rh (x - p_bar) + t cos(theta)) + q_bar
        return se3(np.eye(3), qb) @ se3(Rh, Rh @ (x[3:] * math.cos(theta))) @ se3(Rh, -Rh @ pb)
    if s.objective == "gicp":
        W = _inv3(n_q + n_p)
        r = p - q
        d = p - p_bar
        S = torch.zeros((p.shape[0], 3, 3), dtype=REAL, device=p.device)
        S[:, 0, 1], S[:, 0, 2], S[:, 1, 2] = -d[:, 2], d[:, 1], -d[:, 0]
        S[:, 1, 0], S[:, 2, 0], S[:, 2, 1] = d[:, 2], -d[:, 1], d[:, 0]
        wW = W * w[:, None, None]
        StW = torch.einsum("nji,njk->nik", S, wW)
        H_rr = torch.einsum("nij,njk->ik", StW, S)
        H_rt = -StW.sum(0)
        H_tt = wW.sum(0)
        g = torch.cat([-torch.einsum("nij,nj->i", StW, r), torch.einsum("nij,nj->i", wW, r)])
        JtJ = torch.cat([torch.cat([H_rr, H_rt], 1), torch.cat([H_rt.T, H_tt], 1)], 0)
        x = _solve(JtJ.cpu().numpy(), g.cpu().numpy(), s.damping)
        axis, angle = _axis_angle(x[:3])
        R = rot(axis, angle)
        pb = p_bar.cpu().numpy()
        return se3(R, x[3:] + pb - R @ pb)
    raise ValueError(f"objective {s.objective!r} is not in the reference")


def _apply(T: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    R = torch.as_tensor(T[:3, :3], dtype=REAL, device=x.device)
    t = torch.as_tensor(T[:3, 3], dtype=REAL, device=x.device)
    return x @ R.T + t


def _rotate_aux(s: Settings, T: np.ndarray, aux: torch.Tensor) -> torch.Tensor:
    R = torch.as_tensor(T[:3, :3], dtype=REAL, device=aux.device)
    if s.objective == "gicp":
        return R @ aux @ R.T
    return aux @ R.T


def _scan(s: Settings, max_iters: int, src, src_valid, src_aux, tree, tgt_v, tgt_aux_v, T,
          prev_rmse: float):
    """`max_iters` iterations of the configured loop from T: (T, rmse, iters)."""
    it = 0
    while it < max_iters:
        p = _apply(T, src)
        n_p = _rotate_aux(s, T, src_aux)
        d, j = tree.query(p.cpu().numpy(), k=1, workers=-1)
        jj = torch.as_tensor(j, device=src.device)
        dist = torch.as_tensor(d, dtype=REAL, device=src.device)
        q, n_q = tgt_v[jj], tgt_aux_v[jj]
        valid = src_valid & (dist <= s.max_corr_dist) & torch.isfinite(dist)
        w = _weights(s, p, q, n_p, n_q, dist, valid)
        T_new = _increment(s, p, q, n_p, n_q, w) @ T
        d_new = torch.linalg.vector_norm(_apply(T_new, src) - q, dim=-1)
        vm = valid.to(REAL)
        count = float(vm.sum())
        diff = float((d_new * vm).sum())
        rmse = math.sqrt(float((vm * d_new * d_new).sum()) / max(count, 1.0))
        ok = (math.isfinite(rmse) and math.isfinite(diff) and count >= 3.0
              and bool(np.isfinite(T_new).all()))
        it += 1
        if not ok:
            return T, prev_rmse, it
        stop = diff < s.diff_threshold
        if s.rmse_change_tol > 0:
            stop = stop or abs(prev_rmse - rmse) < s.rmse_change_tol
        T, prev_rmse = T_new, rmse
        if stop:
            break
    return T, prev_rmse, it


def register(src: np.ndarray, src_valid: np.ndarray, src_aux: torch.Tensor,
             tgt: np.ndarray, tgt_valid: np.ndarray, tgt_aux: torch.Tensor, s: Settings,
             device, init: Optional[np.ndarray] = None) -> Answer:
    """Register src onto tgt (target ~ T(source)); `*_aux` are (n, 3)
    normals or (n, 3, 3) covariances, float64 on `device`."""
    center = tgt[tgt_valid].astype(np.float64).mean(0)
    shift, unshift = se3(np.eye(3), -center), se3(np.eye(3), center)
    T = shift @ (np.eye(4) if init is None else init) @ unshift
    src_c = torch.as_tensor(src.astype(np.float64) - center, dtype=REAL, device=device)
    sv = torch.as_tensor(src_valid, device=device)
    tgt_c = tgt[tgt_valid].astype(np.float64) - center
    tree = _tree(tgt_c)
    tgt_v = torch.as_tensor(tgt_c, dtype=REAL, device=device)
    tv_rows = torch.as_tensor(np.nonzero(tgt_valid)[0], device=device)
    tgt_aux_v = tgt_aux[tv_rows]
    prev, iters = float("inf"), 0
    if s.coarse_iters > 0 and s.coarse_stride > 1:
        k = s.coarse_stride
        T, prev, iters = _scan(s, s.coarse_iters, src_c[::k], sv[::k], src_aux[::k], tree, tgt_v,
                               tgt_aux_v, T, prev)
    T, rmse, it = _scan(s, s.max_iters, src_c, sv, src_aux, tree, tgt_v, tgt_aux_v, T, prev)
    return Answer(T=unshift @ T @ shift, rmse=rmse, iters=iters + it)

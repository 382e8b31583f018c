"""The plain reference of online odometry's frame loop: each frame
registered against its keyframe from the constant-velocity guess, the
motion gate, the velocity model and the keyframe rule, in float64.

It imports numpy, scipy's KD tree (through `reference.py`, whose ICP loop,
normals and transforms it uses) and torch, and nothing of the program.

What it follows from the project's documented semantics (bench.py
`--odometry`, the reference package's compiled odometry):

* the initial guess of frame k is prev_rel @ velocity, prev_rel the last
  frame's measurement from the current keyframe (the identity right after
  a spawn); the velocity is a twist-space blend of the model with
  prev_rel^-1 @ rel (a fixed weight `velocity_damping` below 1, else an
  adaptive one), fed from each frame's measurement;
* the motion gate: once a frame has been accepted, and while fewer than 2
  frames in a row were rejected, a frame whose correction init^-1 @ rel
  moves more than `max_correction_trans` or turns more than
  `max_correction_rot` is rejected and keeps the guess (a non-finite
  answer always is);
* the keyframe rule: an accepted frame that lies more than
  `keyframe_trans` or `keyframe_rot` from its keyframe becomes the next
  keyframe;
* each registration runs in the keyframe's valid-centroid coordinates; on
  the block path (from `block_auto_threshold` rows, or forced) its first
  `max_iters - refine_full_iters` iterations take every `refine_stride`-th
  row of each source query tile, the query tiles being the source's
  median-cut tiles of `q_tile` rows (`kd_order`, the documented KD build),
  and the last `refine_full_iters` every row, the RMSE carried over for
  the stop rule; the brute path takes every row for `max_iters`.

Where it departs from the program:

* correspondences on the block path follow the candidate-tile
  definition: the `block_k` keyframe tiles (median-cut tiles of
  `block_tile` rows) nearest each query tile by box distance (x 100, plus
  the centroids' squared distance) at the frame's initial pose (at each
  iteration's pose where candidates are not frozen), and among their rows
  the exact nearest valid point, in float64, where the program scores the
  fp32 expansion ||r||^2 - 2 q.r; the flat ranking only (under 8,192
  keyframe tiles); on the brute path the exact nearest valid point. The
  exact nearest point on the block path too was tried and left: at
  65,536 rows the frozen candidates miss enough true neighbours that the
  program's RMSE gap from it (0.064-0.086 m) came within 2.3 x of the TF32
  program's (0.198-0.201 m);
* the tiles come from coordinates centred on the float64 centroid and
  rounded to float32, where the program centres on its float32 centroid,
  so a row can sit in another tile where the two differ in the last bit;
  tile boxes and centroids are float64;
* normals are the reference's own (`reference.normals`), not the
  program's.

The ladders (q-tile, refine stride, frozen candidates) and the block
settings are the project's documented defaults, copied here
(`ICP_DEFAULTS`, `ladders`) so that a change to the program cannot move
the yardstick.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch

import reference as ref

PAD = 1.0e8  # the coordinate of a sentinel row
# The block path's documented defaults (the program's ICPConfig fields)
ICP_DEFAULTS = dict(nn_method="auto", block_tile=128, block_q_tile=64, block_q_tile_large=128,
                    block_k=8, refine_full_iters=2, refine_stride=0, block_auto_threshold=8192,
                    payload_infold_threshold=2 * 1024 * 1024)
# KD build constants: Morton segments of at most _KD_SEG rows; 4-way
# cuts while a node has >= _FAN4_MIN tiles below it (16 under _FAN4_DEEP
# tiles), then 2-way
_KD_SEG = 65536
_FAN4_MIN = 8
_FAN4_DEEP = 8192
_SUPER_G = 64  # the keyframe index is trimmed to a multiple of this many tiles
_HIER_MIN_TILES = 8192


# ---- the KD build's tile order --------------------------------------------------------------


def kd_schedule(n: int, s: int) -> Tuple[int, int, Tuple[int, ...]]:
    """(t2, c0, fans) of a median-cut build of n rows in tiles of s: the
    padded tile count t2, the Morton segments c0 the cuts start from, and
    each level's fan-out."""
    t = max(1, -(-n // s))
    if t >= 4096:
        k = t.bit_length() - 7
        q0 = -(-t // (1 << k))
        t2 = q0 << k
    else:
        q0, t2 = 1, 1 << (t - 1).bit_length()
    total = t2 * s
    c0 = q0
    while total // c0 > _KD_SEG and c0 < t2:
        c0 *= 2
    fans, c = [], c0
    min4 = _FAN4_MIN if t2 >= _FAN4_DEEP else 16
    while c < t2:
        fans.append(4 if t2 // c >= min4 else 2)
        c *= fans[-1]
    return t2, c0, tuple(fans)


def _spread(x: np.ndarray) -> np.ndarray:
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    return (x | (x << 2)) & 0x9249249


def _valid_bounds(pts: np.ndarray, valid: np.ndarray, axis: int):
    v = valid[..., None]
    return np.where(v, pts, np.float32(PAD)).min(axis), np.where(v, pts, np.float32(-PAD)).max(axis)


def kd_order(xyz32: np.ndarray, valid: np.ndarray, s: int) -> np.ndarray:
    """The median-cut tile order of float32 (n, 3) rows in tiles of s:
    (t2 * s,) original row at each sorted position, -1 on padding. One
    Morton sort cuts the cloud into segments of at most 65,536 rows, then
    each level sorts every segment stably by its widest axis (over its
    valid rows; the first axis among ties; invalid rows last) and cuts it
    4 or 2 ways at equal counts."""
    n = xyz32.shape[0]
    t2, c0, fans = kd_schedule(n, s)
    total = t2 * s
    pts = np.full((total, 3), np.float32(PAD), np.float32)
    pts[:n] = xyz32
    orig = np.full((total,), -1, np.int64)
    orig[:n] = np.where(valid, np.arange(n), -1)
    if c0 > 1:
        ok = orig >= 0
        lo, hi = _valid_bounds(pts, ok, 0)
        inv = np.float32(1.0) / np.maximum(hi - lo, np.float32(1e-6))
        u = np.clip((pts - lo) * inv, np.float32(0.0), np.float32(1.0 - 1e-7))
        q = (u * np.float32(1024.0)).astype(np.int64)
        keys = _spread(q[:, 0]) | (_spread(q[:, 1]) << 1) | (_spread(q[:, 2]) << 2)
        perm = np.argsort(np.where(ok, keys, 2**30), kind="stable")
        pts, orig = pts[perm], orig[perm]
    c = c0
    for fan in fans:
        m = total // c
        seg, og = pts.reshape(c, m, 3), orig.reshape(c, m)
        v = og >= 0
        lo, hi = _valid_bounds(seg, v, 1)
        widest = np.argmax(hi - lo, axis=1)
        vals = np.take_along_axis(seg, widest[:, None, None], 2)[..., 0]
        perm = np.argsort(np.where(v, vals, np.float32(PAD)) + np.float32(0.0), axis=1, kind="stable")
        pts = np.take_along_axis(seg, perm[..., None], 1).reshape(total, 3)
        orig = np.take_along_axis(og, perm, 1).reshape(total)
        c *= fan
    return orig


def trimmed(order: np.ndarray, n: int, s: int, multiple: int = 1) -> np.ndarray:
    """The leading tiles that can hold valid rows, rounded up to a
    multiple of `multiple` tiles: (T, s) original rows, -1 on padding."""
    t = order.shape[0] // s
    keep = min(t, -(-n // s))
    keep = min(t, -(-keep // multiple) * multiple)
    return order[:keep * s].reshape(keep, s)


# ---- the documented ladders -----------------------------------------------------------------


def ladders(n: int, icp: dict, odo: dict) -> Tuple[bool, int, int, bool]:
    """(block path, q_tile, refine stride, frozen candidates) of scans of
    n rows: an explicit setting wins, else the documented ladder (q-tile
    256 from 65,536 rows and 128 from 8,192; stride 4 from 131,072 rows
    and 2 from 65,536; frozen candidates from 16,384)."""
    c = {**ICP_DEFAULTS, **icp}
    block = c["nn_method"] == "block" or (c["nn_method"] == "auto" and n >= c["block_auto_threshold"])
    own_q = c["block_q_tile_large"] if (c["block_q_tile_large"] > 0
                                        and n >= c["payload_infold_threshold"]) else c["block_q_tile"]
    if odo.get("q_tile"):
        q_tile = int(odo["q_tile"])
    elif c["block_q_tile"] != ICP_DEFAULTS["block_q_tile"]:
        q_tile = own_q
    else:
        q_tile = 256 if n >= 65536 else 128 if n >= 8192 else own_q
    stride = int(odo.get("refine_stride") or c["refine_stride"]
                 or (4 if n >= 131072 else 2 if n >= 65536 else 1))
    freeze = odo.get("freeze_candidates")
    return block, q_tile, stride, bool(n >= 16384 if freeze is None else freeze)


# ---- SE(3) in float64 -----------------------------------------------------------------------


def _skew(v: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])


def se3_log(T: np.ndarray) -> np.ndarray:
    """The twist [omega, v] of a 4 x 4 transform."""
    R, t = T[:3, :3], T[:3, 3]
    th = ref.rotation_angle(R)
    w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if th < 1e-9:
        return np.concatenate([w, (np.eye(3) - 0.5 * _skew(w)) @ t])
    omega = w * (th / math.sin(th))
    K = _skew(omega / th)
    half = 0.5 * th
    Vinv = np.eye(3) - half * K + (1.0 - half * math.cos(half) / math.sin(half)) * (K @ K)
    return np.concatenate([omega, Vinv @ t])


def se3_exp(xi: np.ndarray) -> np.ndarray:
    omega, v = xi[:3], xi[3:]
    th = float(np.linalg.norm(omega))
    if th < 1e-9:
        return ref.se3(np.eye(3) + _skew(omega), v)
    K = _skew(omega / th)
    R = np.eye(3) + math.sin(th) * K + (1.0 - math.cos(th)) * (K @ K)
    V = np.eye(3) + ((1.0 - math.cos(th)) / th) * K + (1.0 - math.sin(th) / th) * (K @ K)
    return ref.se3(R, V @ v)


# ---- the frame loop's bookkeeping -----------------------------------------------------------


@dataclass(frozen=True)
class Loop:
    """The frame loop's settings."""

    keyframe_trans: float = 1.0
    keyframe_rot: float = 0.2
    max_correction_trans: float = 1.0
    max_correction_rot: float = 0.5
    velocity_damping: float = 1.0
    adaptive_velocity: bool = True
    innovation_scale: float = 0.5
    velocity_damping_min: float = 0.25

    @classmethod
    def of(cls, odo: dict) -> "Loop":
        keep = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in odo.items() if k in keep})


def blend_velocity(velocity: np.ndarray, raw: np.ndarray, s: Loop) -> np.ndarray:
    if s.velocity_damping >= 1.0 and not s.adaptive_velocity:
        return raw
    if s.velocity_damping < 1.0:
        b = s.velocity_damping
    else:
        d = se3_log(ref.inv(velocity) @ raw)
        innov = float(np.linalg.norm(d[:3]) + np.linalg.norm(d[3:]))
        b = min(max(innov / s.innovation_scale, s.velocity_damping_min), 1.0)
    return se3_exp((1.0 - b) * se3_log(velocity) + b * se3_log(raw))


@dataclass(frozen=True)
class State:
    """What frame k is registered from: its keyframe, the initial guess,
    and the gate's state."""

    kf: int
    init: np.ndarray  # (4, 4) kf_T_frame guess
    warm: bool
    rejects: int


def replay(rels, is_kf, rejected, s: Loop):
    """The frame loop fed the program's own measurements (4 x 4 kf_T_frame
    of frames 0..F-1), keyframe flags and gate decisions: the `State` of
    each frame 1..F-1, in order."""
    prev, vel, kf, warm, rejects = np.eye(4), np.eye(4), 0, False, 0
    out = []
    for k in range(1, len(rels)):
        out.append(State(kf=kf, init=prev @ vel, warm=warm, rejects=rejects))
        vel = blend_velocity(vel, ref.inv(prev) @ rels[k], s)
        warm = warm or not rejected[k]
        rejects = rejects + 1 if rejected[k] else 0
        if is_kf[k]:
            prev, kf = np.eye(4), k
        else:
            prev = rels[k]
    return out


def gate(st: State, rel: np.ndarray, s: Loop) -> bool:
    """Whether the motion gate rejects measurement `rel` in state `st`."""
    corr = ref.inv(st.init) @ rel
    if not (np.isfinite(corr).all() and np.isfinite(rel).all()):
        return True
    on = st.warm and st.rejects < 2 and s.max_correction_trans > 0
    return bool(on and (np.linalg.norm(corr[:3, 3]) > s.max_correction_trans
                        or ref.rotation_angle(corr[:3, :3]) > s.max_correction_rot))


def spawns(rel: np.ndarray, rejected: bool, s: Loop) -> bool:
    """Whether an accepted frame measured at `rel` becomes the keyframe."""
    return bool(not rejected and (np.linalg.norm(rel[:3, 3]) > s.keyframe_trans
                                  or ref.rotation_angle(rel[:3, :3]) > s.keyframe_rot))


# ---- one frame's registration ----------------------------------------------------------------


class _TileNN:
    """The candidate-tile correspondence search: the keyframe's valid rows
    (`kf_pts`) in its median-cut tiles (`kf_tiles`, positions into
    `kf_pts`, -1 on padding), each query row's tile given by `tile_of`."""

    def __init__(self, kf_pts: np.ndarray, kf_tiles: np.ndarray, k: int, device):
        self.kf = torch.as_tensor(kf_pts, dtype=ref.REAL, device=device)
        self.tiles = torch.as_tensor(kf_tiles, device=device)
        self.k, self.device = min(k, kf_tiles.shape[0]), device
        ok = kf_tiles >= 0
        rows = kf_pts[np.where(ok, kf_tiles, 0)]
        self.lo = np.where(ok[..., None], rows, np.inf).min(1)
        self.hi = np.where(ok[..., None], rows, -np.inf).max(1)
        cnt = ok.sum(1)
        self.cent = np.where(cnt[:, None] > 0, (rows * ok[..., None]).sum(1)
                             / np.maximum(cnt, 1)[:, None], PAD)

    def rank(self, p: np.ndarray, tile_of: np.ndarray) -> np.ndarray:
        """(Tq, k) keyframe tiles nearest each query tile of rows p."""
        tq = int(tile_of.max()) + 1
        lo = np.full((tq, 3), np.inf)
        hi = np.full((tq, 3), -np.inf)
        np.minimum.at(lo, tile_of, p)
        np.maximum.at(hi, tile_of, p)
        cent = np.zeros((tq, 3))
        np.add.at(cent, tile_of, p)
        cent /= np.maximum(np.bincount(tile_of, minlength=tq), 1)[:, None]
        gap = np.maximum(np.maximum(self.lo[None] - hi[:, None], lo[:, None] - self.hi[None]), 0.0)
        score = 100.0 * (gap * gap).sum(-1) + ((cent[:, None] - self.cent[None]) ** 2).sum(-1)
        return np.argsort(score, axis=1, kind="stable")[:, :self.k]

    def query(self, p: np.ndarray, tile_of: np.ndarray, cand: Optional[np.ndarray],
              chunk: int = 4096):
        """(distance, position in `kf_pts`) of each row's nearest point
        among its tile's candidates (ranked at p where `cand` is None),
        as a KD tree's `query` gives them."""
        cand = self.rank(p, tile_of) if cand is None else cand
        rows = self.tiles[torch.as_tensor(cand, device=self.device)].reshape(cand.shape[0], -1)
        ds, js = [], []
        for a in range(0, len(p), chunk):
            pt = torch.as_tensor(p[a:a + chunk], dtype=ref.REAL, device=self.device)
            mine = rows[torch.as_tensor(tile_of[a:a + chunk], device=self.device)]
            d2 = ((self.kf[mine.clamp(min=0)] - pt[:, None, :]) ** 2).sum(-1)
            d2 = torch.where(mine >= 0, d2, float("inf"))
            best = torch.argmin(d2, dim=1, keepdim=True)  # the first among ties
            js.append(mine.gather(1, best)[:, 0])
            ds.append(torch.sqrt(d2.gather(1, best)[:, 0]))
        return torch.cat(ds).cpu().numpy(), torch.cat(js).cpu().numpy()


@dataclass
class FrameAnswer:
    T: np.ndarray  # (4, 4) kf_T_frame after the gate
    rmse: float  # inf where the gate rejected the frame
    iters: int
    rejected: bool


def register_frame(src: np.ndarray, src_valid: np.ndarray, src_n: torch.Tensor,
                   kf: np.ndarray, kf_valid: np.ndarray, kf_n: torch.Tensor,
                   s: ref.Settings, icp: dict, odo: dict, st: State, device,
                   guarantee: bool = False) -> FrameAnswer:
    """Frame `src` registered against keyframe `kf` from `st.init` on the
    program's schedule, then the motion gate; normals float64 on
    `device`. "guarantee" runs the bulk phase for a third of its
    iterations, as a cheaper registration would."""
    c = {**ICP_DEFAULTS, **icp}
    n = src.shape[0]
    block, q_tile, stride, frozen = ladders(n, icp, odo)
    center = kf[kf_valid].astype(np.float64).mean(0)
    shift, unshift = ref.se3(np.eye(3), -center), ref.se3(np.eye(3), center)
    T = shift @ st.init @ unshift
    src_c = src.astype(np.float64) - center
    kf_c = kf[kf_valid].astype(np.float64) - center
    kv_rows = torch.as_tensor(np.nonzero(kf_valid)[0], device=device)
    kf_t = torch.as_tensor(kf_c, dtype=ref.REAL, device=device)
    kf_aux = kf_n[kv_rows]

    if block:
        tiles = trimmed(kd_order(np.where(src_valid[:, None], src_c, src).astype(np.float32),
                                 src_valid, q_tile), n, q_tile)
    else:
        tiles = np.nonzero(src_valid)[0][None, :]
    flat = tiles.reshape(-1)
    pos = np.nonzero(flat >= 0)[0]
    rows, tile_of = flat[pos], pos // tiles.shape[1]

    if block:
        kf32 = np.where(kf_valid[:, None], kf.astype(np.float64) - center, kf).astype(np.float32)
        kt = trimmed(kd_order(kf32, kf_valid, c["block_tile"]), n, c["block_tile"], _SUPER_G)
        if kt.shape[0] >= _HIER_MIN_TILES:
            raise ValueError("the reference ranks candidate tiles flat only")
        at = np.cumsum(kf_valid) - 1  # original row -> position among the valid rows
        kt = np.where(kt >= 0, at[np.maximum(kt, 0)], -1)
        search = _TileNN(kf_c, kt, c["block_k"], device)
        cand = search.rank(src_c[rows] @ T[:3, :3].T + T[:3, 3], tile_of) if frozen else None

        def tree_for(sel):
            # what `ref._scan` calls: `query(p, k=1, workers=-1)` of the rows `sel`
            return SimpleNamespace(query=lambda p, *_, **__: search.query(p, tile_of[sel], cand))
    else:
        exact = ref._tree(kf_c)

        def tree_for(sel):
            return exact

    def scan(sel, iters, settings, T, prev):
        r = rows[sel]
        x = torch.as_tensor(src_c[r], dtype=ref.REAL, device=device)
        v = torch.ones(len(r), dtype=torch.bool, device=device)
        return ref._scan(settings, iters, x, v, src_n[torch.as_tensor(r, device=device)],
                         tree_for(sel), kf_t, kf_aux, T, prev)

    rfi = int(c["refine_full_iters"])
    everything = np.arange(len(rows))
    mid = (block and stride > 1 and q_tile % stride == 0 and q_tile // stride >= 8
           and s.max_iters > rfi)
    if mid:
        bulk = s.max_iters - rfi
        if guarantee:
            bulk = max(bulk // 3, 1)
        sel = np.nonzero(pos[everything] % stride == 0)[0]
        s_mid = dataclasses.replace(s, diff_threshold=s.diff_threshold / stride)
        T, prev, it = scan(sel, bulk, s_mid, T, float("inf"))
        T, rmse, it2 = scan(everything, rfi, s, T, prev)
        iters = it + it2
    else:
        its = max(s.max_iters // 3, 1) if guarantee else s.max_iters
        T, rmse, iters = scan(everything, its, s, T, float("inf"))
    rel = unshift @ T @ shift
    rejected = gate(st, rel, Loop.of(odo))
    if rejected:
        return FrameAnswer(T=st.init, rmse=float("inf"), iters=iters, rejected=True)
    return FrameAnswer(T=rel, rmse=rmse, iters=iters, rejected=False)

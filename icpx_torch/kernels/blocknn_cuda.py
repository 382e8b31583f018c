"""Block-NN kernels: radius moments, the frozen-candidate folds, payload
selection, the fused union fold and the union radius moments.

Six hand-written CUDA kernels (`csrc/blocknn.cu`, built by `cuda_build`),
each beside its plain PyTorch version with the same contract:

* `moments6` replaces the Pallas `blocknn_pallas._moments6_kernel`: for each
  query row, the count, mean and covariance of the candidate-tile rows
  within radius r, over its query tile's k candidate tiles, everything
  centred on the query-tile centroid. `block_radius_moments_fused6` wraps it
  as the reference's wrapper does (candidates from `_candidate_tiles`,
  covariance as six SoA component vectors). The kernel screens pairs by a
  centred expansion against a proven margin (`moments6_screen_margin`) and
  decides the pairs within it in the direct form, so its counts are the
  plain version's, bit for bit (`moments6_plan` is its launch shape).
* `fold6` replaces `blocknn_pallas._fold6_kernel`: each query's nearest row
  among its tile's k frozen candidate tiles, its d2, and that row of a
  `(T*S, D)` payload table copied exactly. `fold6_prepare` runs once per
  frozen-candidate phase and `block_fold_fused_pre` once per iteration, as
  in the reference. The kernel screens pairs by a centred expansion against
  a proven margin (`fold6_screen_margin`; centres and radii from the tile
  boxes) and rescores the few rows that pass in the direct form,
  so its outputs are the plain version's, bit for bit (`fold6_plan` is its
  launch shape).
* `fold7` replaces `blocknn_pallas._fold7_kernel` (`payload_mode="vmem7"`):
  fold6's outputs, scored in bf16 on operands centred on the frozen-phase
  query-tile centroids. The kernel makes each candidate row's operands as
  it stages the row, so `fold7_prepare` gathers nothing (`fold7_plan` is
  its launch shape; `fold7_operands` makes the operands in plain torch).
* `select` replaces `blocknn_pallas._select_kernel`
  (`payload_mode="select"`): flat positions from the plain `block_nn` fold
  to payload rows (see `payload_select_fused`).
* `fused4` replaces `blocknn_pallas._vpu_kernel` (`block_fused="on"`): 1-NN
  over per-group unions of candidate tiles (see `block_nn_fused4`).
* `moments_fused` replaces `blocknn_pallas._moments_kernel`: radius moments
  over the same per-group unions (see `block_radius_moments_fused`, the
  fused branch of `normals._block_radius_cov`).

Contracts kept from the TPU kernels (moments6 and fold6; the other four
state theirs in their sections below): moments count a row when d2 <= r^2 and
the row is not a sentinel row (PAD_COORD); the fold takes the least d2, then
the lowest lane (position in the tile), then the earliest candidate; a query
whose candidates are all sentinel gets d2 = +inf and the payload of the
sentinel row it landed on (finite PAD_COORD coordinates, zero normals).

Score: both versions use the direct form (q - r)^2, rounded step by step, so
the kernels and their plain versions agree on every d2 bit. The TPU kernels
use the expansion ||r||^2 - 2 q.r + ||q||^2, whose fp32 cancellation moves a
d2 by ~1e-7 |q|^2: radius-border counts and near-tie winners may differ
from the JAX package on a few rows.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version. Each wrapper adds one to its kernel's key of
`profiling.LAUNCHES` where it launches, and nowhere else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from icpx_torch.kernels import cuda_build
from icpx_torch.kernels.blocknn import _VALID_ABS, TileIndex, _candidate_tiles, _query_boxes
from icpx_torch.utils import profiling

_MISS_D2 = 1.0e15  # a fold d2 at or beyond this is a miss
# Query tiles (fused4: groups) per step of the plain versions: bounds their
# (chunk, Sq, k*S) temporaries (~200 MB each at the flagship's fold shapes;
# fused4's (chunk, G*Sq, U*S) ~128 MB at U = 32).
_PLAIN_CHUNK = {"moments6": 512, "fold6": 1024, "fold7": 1024, "fused4": 32, "moments_fused": 8}


class Moments6Shape(NamedTuple):
    """The moments6 kernel's constants, as the built library reports them."""

    threads: int  # threads of a block
    queries_per_thread: int
    group: int  # rows a mask word covers
    stage_lanes: int  # lanes of one candidate tile a stage holds, at most
    stage_rows: int  # packed rows a stage holds, over the block's query tiles


class Fold6Shape(NamedTuple):
    """A fold kernel's constants (fold6's; fold7 has the same four, with
    values of its own), as the built library reports them."""

    threads: int  # threads of a block
    queries_per_thread: int
    group: int  # rows a screened group
    stage_rows: int  # packed rows a stage holds, over the block's query tiles


class Fused4Shape(NamedTuple):
    """A union kernel's constants (fused4's; moments_fused has the same
    four, with values of its own), as the built library reports them."""

    threads: int  # threads of a block
    queries_per_thread: int
    lane_threads: int  # neighbouring threads that split the lanes of the same queries
    chunk_rows: int  # union rows a block stages at a time


_lib: Optional[ctypes.CDLL] = None
_moments6_shape: Optional[Moments6Shape] = None
_fold6_shape: Optional[Fold6Shape] = None
_fold7_shape: Optional[Fold6Shape] = None
_fused4_shape: Optional[Fused4Shape] = None
_moments_fused_shape: Optional[Fused4Shape] = None


def _read_shape(lib: ctypes.CDLL, name: str, kind=Fused4Shape):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * len(kind._fields)
    fn.restype = None
    vals = [ctypes.c_int() for _ in kind._fields]
    fn(*map(ctypes.byref, vals))
    return kind(*(v.value for v in vals))


def build() -> ctypes.CDLL:
    """Compile (if the cache misses) and load the kernel library, and read
    the shapes of the kernels that plan from them."""
    global _lib, _moments6_shape, _fold6_shape, _fold7_shape, _fused4_shape, _moments_fused_shape
    if _lib is not None:
        return _lib
    lib = cuda_build.load("blocknn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.icpx_moments6_forward.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p, i, p]
    lib.icpx_moments6_forward.restype = i
    lib.icpx_fold6_forward.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p, p, i, p]
    lib.icpx_fold6_forward.restype = i
    lib.icpx_fold7_forward.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p, p, i, p]
    lib.icpx_fold7_forward.restype = i
    lib.icpx_select_forward.argtypes = [p, p, p, i, i, i, i, i, i, i, p, i, p]
    lib.icpx_select_forward.restype = i
    lib.icpx_fused4_forward.argtypes = [p, p, p, i, i, i, i, p, p, i, p]
    lib.icpx_fused4_forward.restype = i
    lib.icpx_moments_fused_forward.argtypes = [p, p, p, p, p, i, i, i, i, p, i, p]
    lib.icpx_moments_fused_forward.restype = i
    _moments6_shape = _read_shape(lib, "icpx_moments6_shape", Moments6Shape)
    _fold6_shape = _read_shape(lib, "icpx_fold6_shape", Fold6Shape)
    _fold7_shape = _read_shape(lib, "icpx_fold7_shape", Fold6Shape)
    _fused4_shape = _read_shape(lib, "icpx_fused4_shape")
    _moments_fused_shape = _read_shape(lib, "icpx_moments_fused_shape")
    _lib = lib
    return lib


def moments6_shape() -> Moments6Shape:
    """The built moments6 kernel's shape."""
    build()
    return _moments6_shape


def fold6_shape() -> Fold6Shape:
    """The built fold6 kernel's shape."""
    build()
    return _fold6_shape


def fold7_shape() -> Fold6Shape:
    """The built fold7 kernel's shape."""
    build()
    return _fold7_shape


def fused4_shape() -> Fused4Shape:
    """The built fused4 kernel's shape."""
    build()
    return _fused4_shape


def moments_fused_shape() -> Fused4Shape:
    """The built moments_fused kernel's shape."""
    build()
    return _moments_fused_shape


def library_path():
    return cuda_build.library_path("blocknn")


def _check(name: str, x: torch.Tensor, dtype, ndim: int, device) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _sqdist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(..., A, 3) x (..., B, 3) -> (..., A, B), ((dx^2 + dy^2) + dz^2) with
    each step rounded, as the kernels compute it."""
    dx = q[..., :, None, 0] - r[..., None, :, 0]
    dy = q[..., :, None, 1] - r[..., None, :, 1]
    dz = q[..., :, None, 2] - r[..., None, :, 2]
    return dx * dx + dy * dy + dz * dz


# ---- kernel #2: radius moments ----------------------------------------------


def moments6_screen_margin(qq: torch.Tensor, big_r: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """delta of the moments6 kernel's screen, in float32 as the kernel
    computes it: 2^-18 ((|qc| + R)^2 + |r2|) + 2^-100, from |qc|^2 (the
    centred query's, rounded), R (the root of the stage's largest rr) and
    r2. Four times a bound (15 u W, u = 2^-24, W = (|qc| + R)^2 + |r2|, to
    first order) on |(s - fl(r2 - qq)) - (d - r2)| over every valid pair, s
    the centred fp32 screen score and d the direct form, with room for
    rounding the thresholds; the source note of the kernel in
    `csrc/blocknn.cu` gives the argument."""
    total = torch.sqrt(qq.to(torch.float32)) + big_r.to(torch.float32)
    w = total * total + torch.abs(r2.to(torch.float32))
    return (2.0 ** -18) * w + 2.0 ** -100


def moments6_plan(tq: int, sq: int, s: int, k: int, shape: Moments6Shape) -> Dict[str, int]:
    """How the moments6 kernel of `shape` covers tq query tiles of sq queries
    against k candidate tiles of s lanes: query tiles a block (a tile's
    queries take ceil(sq / queries_per_thread) threads; above a block's
    threads, parts of one tile a block), lanes a stage (at most
    stage_lanes), padded to whole mask words, mask words a query a stage,
    stages (candidates x runs of lanes) and the grid. The C entry refuses a
    plan that does not fit the kernel."""
    nqt = -(-sq // shape.queries_per_thread)
    nqs = max(1, min(nqt, shape.threads))
    lanes = max(1, min(s, shape.stage_lanes))
    padded = -(-lanes // shape.group) * shape.group
    tpb = max(1, min(shape.threads // nqs, shape.stage_rows // padded))
    return dict(tiles_per_block=tpb, lanes_per_stage=lanes, padded_lanes=padded,
                words=padded // shape.group, stages=k * -(-s // lanes),
                blocks=(-(-tq // tpb), -(-nqt // nqs)))


def moments6_cuda(query_tiles, tiles, cand, q_cent, r2) -> torch.Tensor:
    """Launch the moments kernel: (10, Tq*Sq) f32 rows count, mean x/y/z,
    c00, c01, c02, c11, c12, c22 (see `moments6_reference`)."""
    dev = query_tiles.device
    if not query_tiles.is_cuda:
        raise ValueError("the block-NN kernels need CUDA tensors")
    _check("query_tiles", query_tiles, torch.float32, 3, dev)
    _check("tiles", tiles, torch.float32, 3, dev)
    _check("cand", cand, torch.int32, 2, dev)
    _check("q_cent", q_cent, torch.float32, 2, dev)
    _check("r2", r2, torch.float32, 1, dev)
    tq, sq, _ = query_tiles.shape
    k, s = cand.shape[1], tiles.shape[1]
    if (cand.shape[0] != tq or q_cent.shape != (tq, 3) or query_tiles.shape[2] != 3
            or tiles.shape[2] != 3 or r2.shape != (1,)):
        raise ValueError(f"shapes do not fit: query {tuple(query_tiles.shape)}, tiles "
                         f"{tuple(tiles.shape)}, cand {tuple(cand.shape)}, q_cent "
                         f"{tuple(q_cent.shape)}, r2 {tuple(r2.shape)}")
    if max(tiles.numel(), query_tiles.numel(), 10 * tq * sq) >= 2**31:
        raise ValueError("too many rows for the kernel's int32 indices")
    lib = build()
    plan = moments6_plan(tq, sq, s, k, _moments6_shape)
    out = torch.empty((10, tq * sq), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.icpx_moments6_forward(
        query_tiles.data_ptr(), tiles.data_ptr(), cand.data_ptr(), q_cent.data_ptr(),
        r2.data_ptr(), tq, sq, s, k, plan["tiles_per_block"], plan["lanes_per_stage"],
        out.data_ptr(), dev.index, stream,
    )
    cuda_build.check(lib, rc, "moments6 kernel")
    profiling.LAUNCHES["moments6"] += 1
    return out


def moments6_reference(query_tiles, tiles, cand, q_cent, r2) -> torch.Tensor:
    """The moments kernel's plain version, any device, chunked over query
    tiles: the same centring, radius test and finishing arithmetic; only
    the order of the moment sums differs."""
    tq, sq, _ = query_tiles.shape
    k, s = cand.shape[1], tiles.shape[1]
    cand = cand.to(torch.int64)
    chunk = _PLAIN_CHUNK["moments6"]
    parts = []
    for t0 in range(0, tq, chunk):
        qc = q_cent[t0:t0 + chunk]
        raw = tiles[cand[t0:t0 + chunk]].reshape(-1, k * s, 3)
        rvalid = raw.abs().amax(2) < _VALID_ABS
        r = raw - qc[:, None, :]
        q = query_tiles[t0:t0 + chunk] - qc[:, None, :]
        w = ((_sqdist(q, r) <= r2) & rvalid[:, None, :]).to(torch.float32)
        r = torch.where(rvalid[..., None], r, 0.0)
        x, y, z = r[..., 0], r[..., 1], r[..., 2]
        feat = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y, x * z,
                            y * y, y * z, z * z], dim=2)
        sums = torch.bmm(w, feat)  # (chunk, Sq, 10); w is 0/1, fp32 sums
        cnt = sums[..., 0]
        safe = torch.clamp(cnt, min=1.0)
        m = sums[..., 1:4] / safe[..., None]
        second = sums[..., 4:] / safe[..., None]
        mm = torch.stack([m[..., 0] * m[..., 0], m[..., 0] * m[..., 1], m[..., 0] * m[..., 2],
                          m[..., 1] * m[..., 1], m[..., 1] * m[..., 2], m[..., 2] * m[..., 2]], -1)
        mean = m + qc[:, None, :]
        parts.append(torch.cat([cnt[..., None], mean, second - mm], dim=-1).reshape(-1, 10))
    if not parts:
        return torch.empty((10, 0), dtype=torch.float32, device=query_tiles.device)
    return torch.cat(parts).T.contiguous()


def moments6(query_tiles, tiles, cand, q_cent, r2) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if query_tiles.is_cuda:
        return moments6_cuda(query_tiles.contiguous(), tiles.contiguous(),
                             cand.to(torch.int32).contiguous(), q_cent.contiguous(),
                             r2.reshape(1).contiguous())
    return moments6_reference(query_tiles, tiles, cand, q_cent, r2)


def block_radius_moments_fused6(query_tiles: torch.Tensor, index: TileIndex, radius, *,
                                k_tiles: int = 2):
    """Radius moments of each query over its tile's `k_tiles` candidate
    tiles: (count (N,), mean (N, 3), (c00, c01, c02, c11, c12, c22) each
    (N,)), N = Tq*Sq in query-tile order. The reference wrapper's
    `soa=True` form; candidates are ranked in plain torch."""
    cand, q_cent = _candidate_tiles(query_tiles, index, k_tiles)
    radius = torch.as_tensor(radius, dtype=torch.float32, device=query_tiles.device)
    out = moments6(query_tiles, index.tiles, cand, q_cent, radius * radius)
    return out[0], out[1:4].T, tuple(out[4:10])


# ---- kernel #3: the frozen-candidate fold -------------------------------------


@dataclasses.dataclass(frozen=True)
class Fold6Operands:
    """What `block_fold_fused_pre` needs besides the queries, made once per
    frozen-candidate phase by `fold6_prepare`."""

    cand: torch.Tensor  # (Tq, k) int32 candidate tile ids
    tiles: torch.Tensor  # (T, S, 3) f32 index tiles
    payload: torch.Tensor  # (T*S, D) f32 payload table in sorted tile order
    box_lo: torch.Tensor  # (T, 3) f32 index tile boxes, for the kernel's screen centre
    box_hi: torch.Tensor  # and radius


def fold6_prepare(cand_tiles: torch.Tensor, index: TileIndex,
                  payload_table: torch.Tensor) -> Fold6Operands:
    """Check the fold's loop-invariant operands and make them contiguous,
    int32 candidate ids included. Unlike the TPU prep it gathers nothing:
    the kernel reads candidate rows from the index itself, and its screen
    centres and radii from the index's tile boxes."""
    t, s, _ = index.tiles.shape
    if payload_table.ndim != 2 or payload_table.shape[0] != t * s:
        raise ValueError(f"payload table must be ({t * s}, D), got {tuple(payload_table.shape)}")
    if cand_tiles.ndim != 2:
        raise ValueError(f"cand_tiles must be (Tq, k), got {tuple(cand_tiles.shape)}")
    return Fold6Operands(
        cand=cand_tiles.to(torch.int32).contiguous(),
        tiles=index.tiles.contiguous(),
        payload=payload_table.to(torch.float32).contiguous(),
        box_lo=index.box_lo.to(torch.float32).contiguous(),
        box_hi=index.box_hi.to(torch.float32).contiguous(),
    )


def fold6_screen_margin(qq: torch.Tensor, big_r: torch.Tensor) -> torch.Tensor:
    """delta_q of the fold6 kernel's screen, in float32 as the kernel
    computes it: 2^-18 (|q - c| + R)^2 from |q - c|^2 (the centred query's,
    rounded) and R (the tile's screen radius). More than twice a bound (15 u
    (|q - c| + R)^2, u = 2^-24, to first order) on |s + |q - c|^2 - d| over
    every valid pair, s the centred fp32 screen score and d the uncentred
    fp32 direct form, with room for rounding the threshold; the source note
    of the kernel in `csrc/blocknn.cu` gives the argument."""
    total = torch.sqrt(qq.to(torch.float32)) + big_r.to(torch.float32)
    return (2.0 ** -18) * (total * total)


def fold6_plan(tq: int, sq: int, s: int, k: int, shape: Fold6Shape) -> Dict[str, int]:
    """How the fold6 kernel of `shape` covers tq query tiles of sq queries
    against k candidate tiles of s lanes: query tiles a block (a tile's
    queries take ceil(sq / queries_per_thread) threads; above a block's
    threads, parts of one tile a block), lanes a stage (at most stage_rows),
    padded to whole groups, groups a thread screens a stage, stages
    (candidates x runs of lanes) and the grid. The C entry refuses a plan
    that does not fit the kernel."""
    nq4 = -(-sq // shape.queries_per_thread)
    nqs = max(1, min(nq4, shape.threads))
    lanes = max(1, min(s, shape.stage_rows))
    padded = -(-lanes // shape.group) * shape.group
    tpb = max(1, min(shape.threads // nqs, shape.stage_rows // padded))
    return dict(tiles_per_block=tpb, lanes_per_stage=lanes, padded_lanes=padded,
                groups=padded // shape.group, stages=k * -(-s // lanes),
                blocks=(-(-tq // tpb), -(-nq4 // nqs)))


def fold6_cuda(query_tiles: torch.Tensor, ops: Fold6Operands) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fold kernel: (d2 (Tq*Sq,), payload rows (Tq*Sq, D))."""
    dev = query_tiles.device
    if not query_tiles.is_cuda:
        raise ValueError("the block-NN kernels need CUDA tensors")
    _check("query_tiles", query_tiles, torch.float32, 3, dev)
    _check("tiles", ops.tiles, torch.float32, 3, dev)
    _check("cand", ops.cand, torch.int32, 2, dev)
    _check("box_lo", ops.box_lo, torch.float32, 2, dev)
    _check("box_hi", ops.box_hi, torch.float32, 2, dev)
    _check("payload", ops.payload, torch.float32, 2, dev)
    tq, sq, _ = query_tiles.shape
    t, s, _ = ops.tiles.shape
    k, d_pl = ops.cand.shape[1], ops.payload.shape[1]
    if (ops.cand.shape[0] != tq or ops.box_lo.shape != (t, 3) or ops.box_hi.shape != (t, 3)
            or query_tiles.shape[2] != 3 or ops.tiles.shape[2] != 3 or ops.payload.shape[0] != t * s):
        raise ValueError(f"shapes do not fit: query {tuple(query_tiles.shape)}, tiles "
                         f"{tuple(ops.tiles.shape)}, cand {tuple(ops.cand.shape)}, boxes "
                         f"{tuple(ops.box_lo.shape)}, payload {tuple(ops.payload.shape)}")
    if max(ops.tiles.numel(), query_tiles.numel(), ops.payload.numel(), k * s) >= 2**31:
        raise ValueError("too many rows for the kernel's int32 indices")
    lib = build()
    plan = fold6_plan(tq, sq, s, k, _fold6_shape)
    d = torch.empty((tq * sq,), dtype=torch.float32, device=dev)
    pl = torch.empty((tq * sq, d_pl), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.icpx_fold6_forward(
        query_tiles.data_ptr(), ops.tiles.data_ptr(), ops.cand.data_ptr(), ops.box_lo.data_ptr(),
        ops.box_hi.data_ptr(), ops.payload.data_ptr(), tq, sq, s, k, d_pl, plan["tiles_per_block"],
        plan["lanes_per_stage"], d.data_ptr(), pl.data_ptr(), dev.index, stream,
    )
    cuda_build.check(lib, rc, "fold6 kernel")
    profiling.LAUNCHES["fold6"] += 1
    return d, pl


def fold6_reference(query_tiles: torch.Tensor, ops: Fold6Operands) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fold kernel's plain version, any device, chunked over query
    tiles: the same d2 bits, the same scan order (lane-major,
    candidate-minor, first minimum wins) and the same miss rule."""
    tq, sq, _ = query_tiles.shape
    k, s = ops.cand.shape[1], ops.tiles.shape[1]
    cand = ops.cand.to(torch.int64)
    chunk = _PLAIN_CHUNK["fold6"]
    d_parts, pos_parts = [], []
    for t0 in range(0, tq, chunk):
        c = cand[t0:t0 + chunk]
        r = ops.tiles[c].transpose(1, 2).reshape(-1, s * k, 3)  # row j = lane * k + cand
        best, j = _sqdist(query_tiles[t0:t0 + chunk], r).min(dim=2)  # first among ties
        pos = torch.gather(c, 1, j % k) * s + j // k
        d_parts.append(best.reshape(-1))
        pos_parts.append(pos.reshape(-1))
    if not d_parts:
        dev = query_tiles.device
        return (torch.empty((0,), device=dev),
                torch.empty((0, ops.payload.shape[1]), device=dev))
    d = torch.cat(d_parts)
    return torch.where(d < _MISS_D2, d, float("inf")), ops.payload[torch.cat(pos_parts)]


def block_fold_fused_pre(query_tiles: torch.Tensor, ops: Fold6Operands) -> Tuple[torch.Tensor, torch.Tensor]:
    """One refine iteration's NN and payload: (d2 (Tq*Sq,), payload rows
    (Tq*Sq, D)). The kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if query_tiles.is_cuda:
        return fold6_cuda(query_tiles.contiguous(), ops)
    return fold6_reference(query_tiles, ops)


def block_fold_fused(query_tiles: torch.Tensor, cand_tiles: torch.Tensor, index: TileIndex,
                     payload_tiles: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's one-shot wrapper, `fold6_prepare` then
    `block_fold_fused_pre`: (d2 (Tq*Sq,), payload rows (Tq*Sq, D)) from
    payload tiles (T, S, D). The registration prepares once a phase and
    folds once an iteration instead. The reference's `group` (its Pallas
    screen's) has no counterpart: the kernel's is its compiled shape's
    (`fold6_shape()`)."""
    t, s, _ = index.tiles.shape
    ops = fold6_prepare(cand_tiles, index, payload_tiles.reshape(t * s, -1))
    return block_fold_fused_pre(query_tiles, ops)


# ---- kernel #4: the bf16-scored frozen-candidate fold ---------------------------
#
# Contract (blocknn_pallas.py:694-855): fold6's outputs, but scored in bf16
# on operands centred on the FROZEN-phase query-tile centroids c = q_cent[t]:
# qc = q - c, a = bf16(qc), and for each candidate row rc = r - c,
# rr = (rc_x^2 + rc_y^2) + rc_z^2, B = bf16([-2 rc; rr]), every bf16 rounded
# to nearest even; score = ((a_x B_x + a_y B_y) + a_z B_z) + B_w with each
# step rounded in fp32 (a bf16 x bf16 product is exact there), the same
# fixed order in both versions; d = max(smin + |qc|^2, 0), that qq in fp32
# from the unrounded qc, inf from 1e15 on. Ties: the least j = lane * k + c
# (the lowest lane, then the earliest candidate; scan order lane-major,
# candidate-minor, first minimum wins). Sentinel rows and pad queries are
# scored like any other row: their operands are finite.


@dataclasses.dataclass(frozen=True)
class Fold7Operands:
    """What `block_fold7_pre` needs besides the queries, made once per
    frozen-candidate phase by `fold7_prepare`: the inputs themselves, no
    per-candidate copy."""

    cand: torch.Tensor  # (Tq, k) int32 candidate tile ids
    tiles: torch.Tensor  # (T, S, 3) f32 index tiles
    q_cent: torch.Tensor  # (Tq, 3) f32 frozen-phase query-tile centroids
    payload: torch.Tensor  # (T*S, D) f32 payload table in sorted tile order


def fold7_prepare(cand_tiles: torch.Tensor, q_cent: torch.Tensor, index: TileIndex,
                  payload_table: torch.Tensor) -> Fold7Operands:
    """Check the fold's loop-invariant operands and make them contiguous,
    int32 candidate ids included. Unlike the TPU prep it gathers nothing:
    the kernel makes each candidate row's bf16 operands from the index and
    the centroids as it stages the row (the plain version, a chunk of query
    tiles at a time, with `fold7_operands`)."""
    t, s, _ = index.tiles.shape
    if payload_table.ndim != 2 or payload_table.shape[0] != t * s:
        raise ValueError(f"payload table must be ({t * s}, D), got {tuple(payload_table.shape)}")
    if cand_tiles.ndim != 2 or q_cent.shape != (cand_tiles.shape[0], 3):
        raise ValueError(f"cand_tiles (Tq, k) and q_cent (Tq, 3) do not fit: "
                         f"{tuple(cand_tiles.shape)}, {tuple(q_cent.shape)}")
    return Fold7Operands(cand=cand_tiles.to(torch.int32).contiguous(),
                         tiles=index.tiles.contiguous(),
                         q_cent=q_cent.to(torch.float32).contiguous(),
                         payload=payload_table.to(torch.float32).contiguous())


def fold7_operands(ops: Fold7Operands, lo: int, hi: int) -> torch.Tensor:
    """The bf16 score operands [-2 rc; |rc|^2], rc = r - q_cent[t], of the
    candidate rows of query tiles lo..hi: (hi - lo, k, S, 4), in the
    contract's order of operations (the TPU prep's `b`, with each row's 4
    operands last)."""
    rc = ops.tiles[ops.cand[lo:hi].to(torch.int64)] - ops.q_cent[lo:hi, None, None, :]
    x, y, z = rc.unbind(-1)
    rrc = x * x + y * y + z * z
    return torch.stack([-2.0 * x, -2.0 * y, -2.0 * z, rrc], dim=-1).to(torch.bfloat16)


def fold7_plan(tq: int, sq: int, s: int, k: int, shape: Fold6Shape) -> Dict[str, int]:
    """How the fold7 kernel of `shape` covers tq query tiles of sq queries
    against k candidate tiles of s lanes: query tiles a block (a tile's
    queries take ceil(sq / queries_per_thread) threads; above a block's
    threads, parts of one tile a block; no more tiles than stages of k rows
    fit), lanes a stage (each of the block's tiles holds lanes x k rows,
    padded to whole groups, in its share of stage_rows; a multiple of 4
    where it splits S, so that a stage's rows start on 16 bytes), the packed
    rows a tile a stage, stages and the grid. The C entry refuses a plan
    that does not fit the kernel."""
    g = shape.group
    nq4 = -(-sq // shape.queries_per_thread)
    nqs = max(1, min(nq4, shape.threads))
    tpb = max(1, min(shape.threads // nqs, shape.stage_rows // (-(-k // g) * g)))
    lanes = max(1, min(s, shape.stage_rows // tpb // g * g // k))
    if 4 <= lanes < s:
        lanes -= lanes % 4
    return dict(tiles_per_block=tpb, lanes_per_stage=lanes, padded_rows=-(-lanes * k // g) * g,
                stages=-(-s // lanes), blocks=(-(-tq // tpb), -(-nq4 // nqs)))


def fold7_cuda(query_tiles: torch.Tensor, ops: Fold7Operands) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fold7 kernel: (d2 (Tq*Sq,), payload rows (Tq*Sq, D))."""
    dev = query_tiles.device
    if not query_tiles.is_cuda:
        raise ValueError("the block-NN kernels need CUDA tensors")
    _check("query_tiles", query_tiles, torch.float32, 3, dev)
    _check("tiles", ops.tiles, torch.float32, 3, dev)
    _check("cand", ops.cand, torch.int32, 2, dev)
    _check("q_cent", ops.q_cent, torch.float32, 2, dev)
    _check("payload", ops.payload, torch.float32, 2, dev)
    tq, sq, _ = query_tiles.shape
    t, s, _ = ops.tiles.shape
    k, d_pl = ops.cand.shape[1], ops.payload.shape[1]
    if (ops.cand.shape[0] != tq or ops.q_cent.shape != (tq, 3) or query_tiles.shape[2] != 3
            or ops.tiles.shape[2] != 3 or ops.payload.shape[0] != t * s):
        raise ValueError(f"shapes do not fit: query {tuple(query_tiles.shape)}, tiles "
                         f"{tuple(ops.tiles.shape)}, cand {tuple(ops.cand.shape)}, q_cent "
                         f"{tuple(ops.q_cent.shape)}, payload {tuple(ops.payload.shape)}")
    if max(ops.tiles.numel(), query_tiles.numel(), ops.payload.numel(), k * s) >= 2**31:
        raise ValueError("too many rows for the kernel's int32 indices")
    lib = build()
    plan = fold7_plan(tq, sq, s, k, _fold7_shape)
    if plan["tiles_per_block"] * plan["padded_rows"] > _fold7_shape.stage_rows:
        raise ValueError(f"k = {k} candidate tiles exceed the kernel's stage of "
                         f"{_fold7_shape.stage_rows} rows")
    d = torch.empty((tq * sq,), dtype=torch.float32, device=dev)
    pl = torch.empty((tq * sq, d_pl), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.icpx_fold7_forward(
        query_tiles.data_ptr(), ops.tiles.data_ptr(), ops.cand.data_ptr(), ops.q_cent.data_ptr(),
        ops.payload.data_ptr(), tq, sq, s, k, d_pl, plan["tiles_per_block"],
        plan["lanes_per_stage"], d.data_ptr(), pl.data_ptr(), dev.index, stream,
    )
    cuda_build.check(lib, rc, "fold7 kernel")
    profiling.LAUNCHES["fold7"] += 1
    return d, pl


def fold7_reference(query_tiles: torch.Tensor, ops: Fold7Operands) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fold7 kernel's plain version, any device, chunked over query
    tiles: the operands of each chunk's candidate rows (`fold7_operands`),
    then the same products, sum order, scan order and miss rule, so the same
    d2 bits and winners."""
    tq, sq, _ = query_tiles.shape
    k, s = ops.cand.shape[1], ops.tiles.shape[1]
    cand = ops.cand.to(torch.int64)
    chunk = _PLAIN_CHUNK["fold7"]
    d_parts, pos_parts = [], []
    for t0 in range(0, tq, chunk):
        qc = query_tiles[t0:t0 + chunk] - ops.q_cent[t0:t0 + chunk, None, :]
        x, y, z = qc.unbind(-1)
        qq = x * x + y * y + z * z
        a = qc.to(torch.bfloat16).to(torch.float32)[..., None, :]  # (c, Sq, 1, 3)
        b = fold7_operands(ops, t0, t0 + chunk).to(torch.float32).transpose(1, 2)  # (c, S, k, 4)
        b = b.reshape(b.shape[0], 1, s * k, 4)  # row j = lane * k + cand
        score = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2] + b[..., 3]
        best, j = score.min(dim=2)  # first among ties
        pos = torch.gather(cand[t0:t0 + chunk], 1, j % k) * s + j // k
        d_parts.append(torch.clamp(best + qq, min=0.0).reshape(-1))
        pos_parts.append(pos.reshape(-1))
    if not d_parts:
        dev = query_tiles.device
        return (torch.empty((0,), device=dev),
                torch.empty((0, ops.payload.shape[1]), device=dev))
    d = torch.cat(d_parts)
    return torch.where(d < _MISS_D2, d, float("inf")), ops.payload[torch.cat(pos_parts)]


def block_fold7_pre(query_tiles: torch.Tensor, ops: Fold7Operands) -> Tuple[torch.Tensor, torch.Tensor]:
    """One refine iteration's NN and payload under `payload_mode="vmem7"`:
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if query_tiles.is_cuda:
        return fold7_cuda(query_tiles.contiguous(), ops)
    return fold7_reference(query_tiles, ops)


# ---- kernel #5: payload selection -------------------------------------------------
#
# Contract (blocknn_pallas.py:358-477): each query's output is the sum, over
# the candidate slots c of its query tile and lanes l with
# cand[t, c] * S + l == pos, of that payload row: with distinct candidates
# the row itself, exactly; zeros where pos lies in no candidate tile; a
# candidate tile listed twice doubles the row, as the TPU's one-hot product
# does. Membership is tested as pos // S against the k ids; the sum runs in
# candidate order in both versions.


def select_width(payload_table: torch.Tensor) -> int:
    """Floats a thread of the select kernel copies: 4 (float4) where D is a
    multiple of 4 and the table is 16-byte aligned, 2 (float2) where D is
    even and it is 8-byte aligned, else 1. The output, a fresh allocation
    with the same row width, is then as aligned as the table."""
    d_pl, ptr = payload_table.shape[-1], payload_table.data_ptr()
    for width in (4, 2):
        if d_pl % width == 0 and ptr % (4 * width) == 0:
            return width
    return 1


def select_cuda(pos: torch.Tensor, cand: torch.Tensor, payload_table: torch.Tensor,
                s: int) -> torch.Tensor:
    """Launch the select kernel: (Tq*Sq, D) payload rows from pos (Tq, Sq)
    and cand (Tq, k), contiguous int32, and the contiguous float32
    (n_rows, D) table, all on one CUDA device. It runs once a refine
    iteration, so the checks are one test each, and the error names them
    all."""
    dev = pos.device
    tq, sq = pos.shape
    n_rows, d_pl = payload_table.shape
    if not (pos.is_cuda and pos.dtype == torch.int32 and cand.dtype == torch.int32
            and payload_table.dtype == torch.float32 and cand.device == dev
            and payload_table.device == dev and pos.is_contiguous() and cand.is_contiguous()
            and payload_table.is_contiguous() and cand.ndim == 2 and cand.shape[0] == tq
            and n_rows % s == 0 and payload_table.numel() < 2**31 and tq * sq * d_pl < 2**31):
        raise ValueError(
            "select needs contiguous int32 pos (Tq, Sq) and cand (Tq, k) and a float32 "
            f"(n_rows, D) table (n_rows a multiple of S = {s}, fewer than 2^31 floats in and "
            f"out) on one CUDA device; got pos {pos.dtype} {tuple(pos.shape)} on {pos.device}, "
            f"cand {cand.dtype} {tuple(cand.shape)} on {cand.device}, table "
            f"{payload_table.dtype} {tuple(payload_table.shape)} on {payload_table.device}")
    lib = build()
    out = torch.empty((tq * sq, d_pl), dtype=torch.float32, device=dev)
    rc = lib.icpx_select_forward(
        pos.data_ptr(), cand.data_ptr(), payload_table.data_ptr(), tq, sq, s, cand.shape[1], d_pl,
        n_rows, select_width(payload_table), out.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, rc, "select kernel")
    profiling.LAUNCHES["select"] += 1
    return out


def select_reference(pos: torch.Tensor, cand: torch.Tensor, payload_table: torch.Tensor,
                     s: int) -> torch.Tensor:
    """The select kernel's plain version, any device: the same membership
    test and the same candidate-order sum."""
    n_rows, d_pl = payload_table.shape
    p = pos.to(torch.int64)
    rows = payload_table[p.clamp(0, n_rows - 1)]  # (Tq, Sq, D)
    tile = torch.where((p >= 0) & (p < n_rows), torch.div(p, s, rounding_mode="floor"), -1)
    out = torch.zeros_like(rows)
    for c in range(cand.shape[1]):
        hit = cand[:, c:c + 1].to(torch.int64) == tile
        out = out + torch.where(hit[..., None], rows, 0.0)
    return out.reshape(-1, d_pl)


def payload_select_fused(pos: torch.Tensor, cand_tiles: torch.Tensor,
                         payload_tiles: torch.Tensor) -> torch.Tensor:
    """Payload rows (Tq*Sq, D) for the flat positions (Tq, Sq) that
    `block_nn(..., return_pos=True, cand_tiles=cand_tiles)` returned, from
    (T, S, D) payload tiles: the kernel on a CUDA tensor, the plain version
    on a CPU tensor. A caller that selects every iteration of a phase
    passes the candidates as contiguous int32, converted once (the
    registration does): nothing is then converted here."""
    t, s, d_pl = payload_tiles.shape
    table = payload_tiles.reshape(t * s, d_pl)
    if pos.is_cuda:
        if pos.dtype != torch.int32:
            pos = pos.to(torch.int32)
        if cand_tiles.dtype != torch.int32:
            cand_tiles = cand_tiles.to(torch.int32)
        if table.dtype != torch.float32:
            table = table.to(torch.float32)
        return select_cuda(pos.contiguous(), cand_tiles.contiguous(), table.contiguous(), s)
    return select_reference(pos, cand_tiles, table, s)


# ---- kernel #6: the fused union fold -------------------------------------------------
#
# Contract (blocknn_pallas.py:64-196): the query tiles of a group share one
# union of their candidate tiles (`group_unions`: sorted unique ids, padded
# with the group's smallest id, the largest id in the last slot on
# overflow). Score on uncentred coordinates, rr - 2 (qx rx + qy ry + qz rz)
# with rr = (x^2 + y^2) + z^2, rounded step by step; qq is added at the end,
# d = max(smin + qq, 0), inf from 1e15 on. Ties: within a lane the earliest
# union slot (strict '<'); across lanes the largest u * S + lane among the
# lanes whose minimum equals smin. pos = unions[g, u] * S + lane.


def group_unions(cand_tiles: torch.Tensor, group: int, u_max: int) -> torch.Tensor:
    """(Tq, K) candidate tile ids -> (Tq // group, u_max) int32 per-group
    unions, as `blocknn_pallas.group_unions`: the sorted unique ids,
    unfilled slots padded with the group's smallest id; on overflow the
    largest id takes the last slot (the reference's scatter with duplicate
    slots keeps the last write; here it is chosen directly, with no
    scatter). int32 here, once, is what the union kernels take."""
    tq, k = cand_tiles.shape
    g = tq // group
    ids = torch.sort(cand_tiles[:g * group].reshape(g, group * k), dim=1).values
    first = torch.ones_like(ids, dtype=torch.bool)
    first[:, 1:] = ids[:, 1:] != ids[:, :-1]
    n_unique = first.sum(1, keepdim=True)
    # the unique ids to the front, in order: a stable sort of "not first"
    front = torch.sort((~first).to(torch.int8), dim=1, stable=True).indices[:, :u_max]
    uniq = torch.gather(ids, 1, front)
    if uniq.shape[1] < u_max:
        uniq = torch.cat([uniq, ids[:, :1].expand(g, u_max - uniq.shape[1])], dim=1)
    slot = torch.arange(u_max, device=ids.device)
    out = torch.where(slot < n_unique, uniq, ids[:, :1])
    out[:, -1] = torch.where(n_unique[:, 0] >= u_max, ids[:, -1], out[:, -1])
    return out.to(torch.int32)


def fused4_plan(gq: int, s: int, n_u: int, shape: Fused4Shape) -> Dict[str, int]:
    """How a union kernel of `shape` (fused4, or moments_fused, which stages
    and splits a union the same way) covers a group of gq queries against a
    union of n_u slots of s lanes: query blocks a group, lanes a staged
    chunk holds (every slot of them, at most chunk_rows rows, a multiple of
    lane_threads, no more than s needs), chunks, and the longest union it
    takes (a chunk must hold lane_threads lanes)."""
    per_block = shape.threads // shape.lane_threads * shape.queries_per_thread
    lt = shape.lane_threads
    lanes = min(shape.chunk_rows // n_u // lt * lt, -(-s // lt) * lt)
    return dict(query_blocks=max(1, math.ceil(gq / per_block)), lanes_per_chunk=lanes,
                chunks=math.ceil(s / lanes) if lanes else 0,
                max_union=shape.chunk_rows // lt)


def fused4_cuda(query_tiles: torch.Tensor, tiles: torch.Tensor, unions: torch.Tensor,
                group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused4 kernel: (d2 (Tq*Sq,), flat sorted position
    (Tq*Sq,) int32)."""
    dev = query_tiles.device
    if not query_tiles.is_cuda:
        raise ValueError("the block-NN kernels need CUDA tensors")
    _check("query_tiles", query_tiles, torch.float32, 3, dev)
    _check("tiles", tiles, torch.float32, 3, dev)
    _check("unions", unions, torch.int32, 2, dev)
    tq, sq, _ = query_tiles.shape
    s = tiles.shape[1]
    g, u_max = unions.shape
    if g * group != tq or query_tiles.shape[2] != 3 or tiles.shape[2] != 3:
        raise ValueError(f"shapes do not fit: query {tuple(query_tiles.shape)}, "
                         f"tiles {tuple(tiles.shape)}, unions {tuple(unions.shape)}, group {group}")
    lib = build()
    max_union = fused4_plan(group * sq, s, 1, _fused4_shape)["max_union"]
    if u_max > max_union:
        raise ValueError(f"unions of {u_max} slots exceed the kernel's {max_union}")
    if tiles.numel() >= 2**31 or query_tiles.numel() >= 2**31:
        raise ValueError("too many rows for the kernels' int32 tile ids")
    d = torch.empty((tq * sq,), dtype=torch.float32, device=dev)
    pos = torch.empty((tq * sq,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.icpx_fused4_forward(
        query_tiles.data_ptr(), tiles.data_ptr(), unions.data_ptr(), g, group * sq, s, u_max,
        d.data_ptr(), pos.data_ptr(), dev.index, stream,
    )
    cuda_build.check(lib, rc, "fused4 kernel")
    profiling.LAUNCHES["fused4"] += 1
    return d, pos


def fused4_reference(query_tiles: torch.Tensor, tiles: torch.Tensor, unions: torch.Tensor,
                     group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused4 kernel's plain version, any device, chunked over groups:
    the same score bits, tie rule and miss rule."""
    tq, sq, _ = query_tiles.shape
    s = tiles.shape[1]
    g, u_max = unions.shape
    gq = group * sq
    q = query_tiles.reshape(g, gq, 3)
    x, y, z = tiles.unbind(-1)
    rr = x * x + y * y + z * z  # (T, S)
    unions = unions.to(torch.int64)
    lane = torch.arange(s, device=tiles.device)
    chunk = _PLAIN_CHUNK["fused4"]
    d_parts, pos_parts = [], []
    for g0 in range(0, g, chunk):
        u = unions[g0:g0 + chunk]
        r = tiles[u][:, None]  # (c, 1, U, S, 3)
        qc = q[g0:g0 + chunk][:, :, None, None, :]  # (c, GQ, 1, 1, 3)
        dot = qc[..., 0] * r[..., 0] + qc[..., 1] * r[..., 1] + qc[..., 2] * r[..., 2]
        score = rr[u][:, None] - 2.0 * dot  # (c, GQ, U, S)
        bs, bu = score.min(dim=2)  # per lane: the earliest slot among ties
        smin = bs.min(dim=2, keepdim=True).values
        lpos = torch.where(bs == smin, bu * s + lane, -1).amax(dim=2)  # the largest u*S + lane
        qx, qy, qz = q[g0:g0 + chunk].unbind(-1)
        d_parts.append(torch.clamp(smin[..., 0] + (qx * qx + qy * qy + qz * qz), min=0.0).reshape(-1))
        tid = torch.gather(u, 1, torch.div(lpos, s, rounding_mode="floor"))
        pos_parts.append((tid * s + lpos % s).reshape(-1))
    if not d_parts:
        dev = query_tiles.device
        return torch.empty((0,), device=dev), torch.empty((0,), dtype=torch.int32, device=dev)
    d = torch.cat(d_parts)
    return torch.where(d < _MISS_D2, d, float("inf")), torch.cat(pos_parts).to(torch.int32)


def block_nn_fused4(query_tiles: torch.Tensor, index: TileIndex, *, k_tiles: int = 8,
                    group: int = 4, u_max: int = 16,
                    return_pos: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for `blocknn.block_nn` (`block_fused="on"`): candidates
    ranked per query tile, merged into per-group unions, then the kernel on
    a CUDA tensor or the plain version on a CPU tensor. Returns (d2, flat
    sorted position) with `return_pos`, else (d2, original index), pad and
    miss rows at d = inf."""
    tq = query_tiles.shape[0]
    if tq % group:
        raise ValueError(f"tq={tq} not divisible by group={group}")
    cand, _ = _candidate_tiles(query_tiles, index, k_tiles)
    unions = group_unions(cand, group, u_max)
    if query_tiles.is_cuda:
        d, pos = fused4_cuda(query_tiles.contiguous(), index.tiles.contiguous(), unions, group)
    else:
        d, pos = fused4_reference(query_tiles, index.tiles, unions, group)
    if return_pos:
        return d, pos
    ridx = index.order[pos.to(torch.int64)]
    return torch.where(ridx >= 0, d, float("inf")), torch.clamp(ridx, min=0)


def use_fused_default() -> bool:
    """Whether the union kernels are the default: no, as in the reference
    (`blocknn_pallas.use_fused_default`), whose TPU measurements found them
    no faster than the plain folds. `block_fused="on"` and
    `normals._block_radius_cov(..., fused=True)` opt in; no measurement on
    the card has changed this yet."""
    return False


# ---- kernel #7: the union radius moments -------------------------------------------
#
# Contract (blocknn_pallas.py:199-330): the query tiles of a group share one
# union of their candidate tiles (`group_unions`, as for fused4). Queries and
# union rows are centred on the group's valid-query centroid; a row counts
# when score = (((ax rx + ay ry) + az rz) + rr) + c <= 0 with a = -2 q_c,
# rr = (rx^2 + ry^2) + rz^2 and c = |q_c|^2 - r^2, rounded step by step (the
# TPU kernel's expansion d^2 - r^2; the same order in both versions, so the
# same counts). The TPU kernel sums all u_max slots, and the padded slots
# repeat slot 0's tile, so slot 0's rows count (u_max - n_u + 1) times, n_u
# the slots before the first repeat: a row can count more neighbours than
# the cloud holds within the radius. Both versions keep that multiplicity.
# They return the count and the nine centred moment sums, (10, N) rows:
# count, x, y, z, xx, yy, zz, xy, xz, yz; `block_radius_moments_fused`
# finishes mean and covariance in torch, as the reference does in XLA.


def _slot_weights(unions: torch.Tensor) -> torch.Tensor:
    """(G, u_max) f32 multiplicity of each union slot: slot 0 once for itself
    and once for every padded slot, the slots before the first repeat of
    slot 0's id once, the rest 0."""
    u_max = unions.shape[1]
    fresh = torch.cumprod((unions[:, 1:] != unions[:, :1]).to(torch.int64), dim=1)
    n_u = 1 + fresh.sum(1, keepdim=True)
    return torch.cat([u_max - n_u + 1, fresh], dim=1).to(torch.float32)


def group_centroids(query_tiles: torch.Tensor, group: int) -> torch.Tensor:
    """(Tq // group, 3) centroid of each group's valid (non-sentinel)
    queries, the point the union moments are centred on; the origin for a
    group with none."""
    tq, sq, _ = query_tiles.shape
    return _query_boxes(query_tiles.reshape(tq // group, group * sq, 3))[2]


def moments_fused_cuda(query_tiles: torch.Tensor, tiles: torch.Tensor, unions: torch.Tensor,
                       q_cent: torch.Tensor, r2: torch.Tensor, group: int) -> torch.Tensor:
    """Launch the union moments kernel: (10, Tq*Sq) f32 (see
    `moments_fused_reference`)."""
    dev = query_tiles.device
    if not query_tiles.is_cuda:
        raise ValueError("the block-NN kernels need CUDA tensors")
    _check("query_tiles", query_tiles, torch.float32, 3, dev)
    _check("tiles", tiles, torch.float32, 3, dev)
    _check("unions", unions, torch.int32, 2, dev)
    _check("q_cent", q_cent, torch.float32, 2, dev)
    _check("r2", r2, torch.float32, 1, dev)
    tq, sq, _ = query_tiles.shape
    s = tiles.shape[1]
    g, u_max = unions.shape
    if g * group != tq or q_cent.shape != (g, 3) or query_tiles.shape[2] != 3 or tiles.shape[2] != 3:
        raise ValueError(f"shapes do not fit: query {tuple(query_tiles.shape)}, tiles "
                         f"{tuple(tiles.shape)}, unions {tuple(unions.shape)}, q_cent "
                         f"{tuple(q_cent.shape)}, group {group}")
    lib = build()
    max_union = fused4_plan(group * sq, s, 1, _moments_fused_shape)["max_union"]
    if u_max > max_union:
        raise ValueError(f"unions of {u_max} slots exceed the kernel's {max_union}")
    if tiles.numel() >= 2**31 or query_tiles.numel() >= 2**31:
        raise ValueError("too many rows for the kernels' int32 tile ids")
    out = torch.empty((10, tq * sq), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.icpx_moments_fused_forward(
        query_tiles.data_ptr(), tiles.data_ptr(), unions.data_ptr(), q_cent.data_ptr(),
        r2.data_ptr(), g, group * sq, s, u_max, out.data_ptr(), dev.index, stream,
    )
    cuda_build.check(lib, rc, "moments_fused kernel")
    profiling.LAUNCHES["moments_fused"] += 1
    return out


def moments_fused_reference(query_tiles: torch.Tensor, tiles: torch.Tensor, unions: torch.Tensor,
                            q_cent: torch.Tensor, r2: torch.Tensor, group: int) -> torch.Tensor:
    """The union moments kernel's plain version, any device, chunked over
    groups: the same centring, score order and slot multiplicities (so the
    same counts); only the order of the moment sums differs."""
    tq, sq, _ = query_tiles.shape
    s = tiles.shape[1]
    g, u_max = unions.shape
    q = query_tiles.reshape(g, group * sq, 3)
    weight = _slot_weights(unions).repeat_interleave(s, dim=1)  # (G, U*S)
    unions = unions.to(torch.int64)
    chunk = _PLAIN_CHUNK["moments_fused"]
    parts = []
    for g0 in range(0, g, chunk):
        qc = q_cent[g0:g0 + chunk]
        x, y, z = (tiles[unions[g0:g0 + chunk]] - qc[:, None, None, :]).reshape(
            -1, u_max * s, 3).unbind(-1)
        rr = x * x + y * y + z * z
        qx, qy, qz = (q[g0:g0 + chunk] - qc[:, None, :]).unbind(-1)
        c = (qx * qx + qy * qy + qz * qz) - r2
        score = ((-2.0 * qx)[..., None] * x[:, None, :] + (-2.0 * qy)[..., None] * y[:, None, :]) \
            + (-2.0 * qz)[..., None] * z[:, None, :]
        score = (score + rr[:, None, :]) + c[..., None]  # (c, GQ, U*S)
        w = (score <= 0.0).to(torch.float32) * weight[g0:g0 + chunk, None, :]
        feat = torch.stack([torch.ones_like(x), x, y, z, x * x, y * y, z * z,
                            x * y, x * z, y * z], dim=2)  # (c, U*S, 10)
        parts.append(torch.bmm(w, feat).reshape(-1, 10))  # counts: exact integer sums
    if not parts:
        return torch.empty((10, 0), dtype=torch.float32, device=query_tiles.device)
    return torch.cat(parts).T.contiguous()


def moments_fused(query_tiles, tiles, unions, q_cent, r2, group) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if query_tiles.is_cuda:
        return moments_fused_cuda(query_tiles.contiguous(), tiles.contiguous(),
                                  unions.to(torch.int32).contiguous(), q_cent.contiguous(),
                                  r2.reshape(1).contiguous(), group)
    return moments_fused_reference(query_tiles, tiles, unions, q_cent, r2, group)


def block_radius_moments_fused(query_tiles: torch.Tensor, index: TileIndex, radius, *,
                               k_tiles: int = 8, group: int = 4, u_max: int = 16):
    """Drop-in for `blocknn.block_radius_moments` over per-group candidate
    unions: (count (N,), mean (N, 3), cov (N, 3, 3)) in query-tile order,
    N = Tq*Sq. Candidates are ranked and merged in plain torch."""
    tq, sq, _ = query_tiles.shape
    if tq % group:
        raise ValueError(f"tq={tq} not divisible by group={group}")
    gq = group * sq
    cand, _ = _candidate_tiles(query_tiles, index, k_tiles)
    unions = group_unions(cand, group, u_max)
    q_cent = group_centroids(query_tiles, group)
    radius = torch.as_tensor(radius, dtype=torch.float32, device=query_tiles.device)
    m = moments_fused(query_tiles, index.tiles, unions, q_cent, radius * radius, group)
    return finish_union_moments(m, q_cent, gq)


def finish_union_moments(m: torch.Tensor, q_cent: torch.Tensor, gq: int):
    """(count, mean, cov) from the union moments' (10, N) sums centred on
    each group's centroid q_cent (gq queries a group): the reference's XLA
    epilogue; a row without neighbours gets its group centroid and zeros."""
    cnt = m[0]
    safe = torch.clamp(cnt, min=1.0)[:, None]
    mean_c = m[1:4].T / safe
    exx = torch.stack([
        torch.stack([m[4], m[7], m[8]], dim=1),
        torch.stack([m[7], m[5], m[9]], dim=1),
        torch.stack([m[8], m[9], m[6]], dim=1),
    ], dim=1) / safe[..., None]
    cov = exx - mean_c[:, :, None] * mean_c[:, None, :]
    return cnt, mean_c + torch.repeat_interleave(q_cent, gq, dim=0), cov

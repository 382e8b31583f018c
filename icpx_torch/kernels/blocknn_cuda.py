"""Block-NN kernels: radius moments and the frozen-candidate fold.

Two hand-written CUDA kernels (`csrc/blocknn.cu`, built by `cuda_build`),
each beside its plain PyTorch version with the same contract:

* `moments6` replaces the Pallas `blocknn_pallas._moments6_kernel`: for each
  query row, the count, mean and covariance of the candidate-tile rows
  within radius r, over its query tile's k candidate tiles, everything
  centred on the query-tile centroid. `block_radius_moments_fused6` wraps it
  as the reference's wrapper does (candidates from `_candidate_tiles`,
  covariance as six SoA component vectors).
* `fold6` replaces `blocknn_pallas._fold6_kernel`: each query's nearest row
  among its tile's k frozen candidate tiles, its d2, and that row of a
  `(T*S, D)` payload table copied exactly. `fold6_prepare` runs once per
  frozen-candidate phase and `block_fold_fused_pre` once per iteration, as
  in the reference.

Contracts kept from the TPU kernels: moments count a row when d2 <= r^2 and
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
tensor it runs the plain version. `LAUNCHES[name]` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from icpx_torch.kernels import cuda_build
from icpx_torch.kernels.blocknn import _VALID_ABS, TileIndex, _candidate_tiles

# Kernel launches in this process, by kernel: each wrapper adds one where it
# launches and nowhere else, so a caller can show that a run went through the
# kernels (reset to 0, run, read).
LAUNCHES = {"moments6": 0, "fold6": 0}

_MISS_D2 = 1.0e15  # a fold d2 at or beyond this is a miss
_MAX_ROWS = 3072  # k * S candidate rows a block stages (48 KB of float4)
# Query tiles per step of the plain versions: bounds their (chunk, Sq, k*S)
# temporaries (~200 MB each at the flagship's fold shapes).
_PLAIN_CHUNK = {"moments6": 512, "fold6": 1024}

_lib: Optional[ctypes.CDLL] = None


def build() -> ctypes.CDLL:
    """Compile (if the cache misses) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load("blocknn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.icpx_moments6_forward.argtypes = [p, p, p, p, p, i, i, i, i, p, i, p]
    lib.icpx_moments6_forward.restype = i
    lib.icpx_fold6_forward.argtypes = [p, p, p, p, i, i, i, i, i, p, p, i, p]
    lib.icpx_fold6_forward.restype = i
    _lib = lib
    return lib


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


def _check_launch(query_tiles, tiles, cand) -> None:
    dev = query_tiles.device
    if not query_tiles.is_cuda:
        raise ValueError("the block-NN kernels need CUDA tensors")
    _check("query_tiles", query_tiles, torch.float32, 3, dev)
    _check("tiles", tiles, torch.float32, 3, dev)
    _check("cand", cand, torch.int32, 2, dev)
    tq, k = cand.shape
    if query_tiles.shape[0] != tq or query_tiles.shape[2] != 3 or tiles.shape[2] != 3:
        raise ValueError(f"shapes do not fit: query {tuple(query_tiles.shape)}, "
                         f"tiles {tuple(tiles.shape)}, cand {tuple(cand.shape)}")
    if k * tiles.shape[1] > _MAX_ROWS:
        raise ValueError(f"k * S = {k * tiles.shape[1]} candidate rows exceed {_MAX_ROWS}")
    if tiles.numel() >= 2**31 or query_tiles.numel() >= 2**31:
        raise ValueError("too many rows for the kernels' int32 tile ids")


def _sqdist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(..., A, 3) x (..., B, 3) -> (..., A, B), ((dx^2 + dy^2) + dz^2) with
    each step rounded, as the kernels compute it."""
    dx = q[..., :, None, 0] - r[..., None, :, 0]
    dy = q[..., :, None, 1] - r[..., None, :, 1]
    dz = q[..., :, None, 2] - r[..., None, :, 2]
    return dx * dx + dy * dy + dz * dz


# ---- kernel #2: radius moments ----------------------------------------------


def moments6_cuda(query_tiles, tiles, cand, q_cent, r2) -> torch.Tensor:
    """Launch the moments kernel: (10, Tq*Sq) f32 rows count, mean x/y/z,
    c00, c01, c02, c11, c12, c22 (see `moments6_reference`)."""
    _check_launch(query_tiles, tiles, cand)
    dev = query_tiles.device
    _check("q_cent", q_cent, torch.float32, 2, dev)
    _check("r2", r2, torch.float32, 1, dev)
    tq, sq, _ = query_tiles.shape
    k, s = cand.shape[1], tiles.shape[1]
    lib = build()
    out = torch.empty((10, tq * sq), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.icpx_moments6_forward(
        query_tiles.data_ptr(), tiles.data_ptr(), cand.data_ptr(), q_cent.data_ptr(),
        r2.data_ptr(), tq, sq, s, k, out.data_ptr(), dev.index, stream,
    )
    cuda_build.check(lib, rc, "moments6 kernel")
    LAUNCHES["moments6"] += 1
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


def fold6_prepare(cand_tiles: torch.Tensor, index: TileIndex,
                  payload_table: torch.Tensor) -> Fold6Operands:
    """Check the fold's loop-invariant operands and make them contiguous,
    int32 candidate ids included. Unlike the TPU prep it gathers nothing:
    the kernel reads candidate rows from the index itself."""
    t, s, _ = index.tiles.shape
    if payload_table.ndim != 2 or payload_table.shape[0] != t * s:
        raise ValueError(f"payload table must be ({t * s}, D), got {tuple(payload_table.shape)}")
    if cand_tiles.ndim != 2:
        raise ValueError(f"cand_tiles must be (Tq, k), got {tuple(cand_tiles.shape)}")
    return Fold6Operands(
        cand=cand_tiles.to(torch.int32).contiguous(),
        tiles=index.tiles.contiguous(),
        payload=payload_table.to(torch.float32).contiguous(),
    )


def fold6_cuda(query_tiles: torch.Tensor, ops: Fold6Operands) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fold kernel: (d2 (Tq*Sq,), payload rows (Tq*Sq, D))."""
    _check_launch(query_tiles, ops.tiles, ops.cand)
    dev = query_tiles.device
    _check("payload", ops.payload, torch.float32, 2, dev)
    tq, sq, _ = query_tiles.shape
    k, s = ops.cand.shape[1], ops.tiles.shape[1]
    d_pl = ops.payload.shape[1]
    lib = build()
    d = torch.empty((tq * sq,), dtype=torch.float32, device=dev)
    pl = torch.empty((tq * sq, d_pl), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.icpx_fold6_forward(
        query_tiles.data_ptr(), ops.tiles.data_ptr(), ops.cand.data_ptr(),
        ops.payload.data_ptr(), tq, sq, s, k, d_pl, d.data_ptr(), pl.data_ptr(),
        dev.index, stream,
    )
    cuda_build.check(lib, rc, "fold6 kernel")
    LAUNCHES["fold6"] += 1
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

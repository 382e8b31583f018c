"""Block-sparse (IVF-style) nearest neighbour: the large-cloud NN path.

Mirrors `icpx/kernels/blocknn.py`. A reference cloud is cut once into T
spatially compact tiles of S points (`build_kd_index`: a Morton pre-sort
into segments, then median cuts along each segment's widest axis); a
spatially sorted query tile is scored only against its K nearest tiles by
AABB gap plus centroid distance (`_candidate_tiles`), so an NN query costs
Nq * K * S pairs instead of Nq * Nr. A query's true NN is found iff its
tile's candidates hold the NN's tile; a miss returns a genuine but larger
distance.

Everything here is plain PyTorch on every device, as it is XLA in the
reference, except the KD build's median-level sorts, which go through the
segmented sort kernel (`sort_cuda.sort_segments`) on a CUDA tensor. The
block path's other hand-written kernels (the folds and the radius moments)
live in `blocknn_cuda.py`. Differences from the reference, none of which
changes a result:

* the KD build's Morton sort is `torch.sort(..., stable=True)` plus a row
  gather in place of the multi-operand `lax.sort` (the same permutation),
  and its level sorts on the CPU are the sort kernel's plain version, the
  same;
* top-k ranking sorts one int64 key per entry (the score's fp32 bit
  pattern over the entry's index), so ties go to the lower index as in
  `lax.top_k`; `torch.topk` alone promises no tie order;
* chunking over query tiles is a Python loop instead of `lax.map` over
  sentinel-padded chunks (a chunk's candidates and query features are
  sliced with it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from icpx_torch.cloud import PAD_COORD
from icpx_torch.kernels.sort_cuda import sort_segments


@dataclasses.dataclass(frozen=True)
class TileIndex:
    """Spatially sorted, fixed-tile partition of a reference cloud."""

    tiles: torch.Tensor  # (T, S, 3) sorted coords, PAD_COORD padding
    box_lo: torch.Tensor  # (T, 3) per-tile AABB (sentinel-free)
    box_hi: torch.Tensor  # (T, 3)
    centroids: torch.Tensor  # (T, 3) masked tile centroids
    order: torch.Tensor  # (T*S,) int32 sorted position -> original index, -1 pad

    @property
    def n_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def tile_size(self) -> int:
        return self.tiles.shape[1]


# Build constants, as in the reference (see its comments for the chip A/Bs
# behind them): Morton segments handed to the median phase hold at most
# _KD_SEG points; 4-way fan-out while a node has >= _FAN4_MIN tiles below it
# (16 for builds under _FAN4_DEEP tiles), 2-way for the last levels.
_KD_SEG = 65536
_FAN4_MIN = 8
_FAN4_DEEP = 8192

# Candidate ranking goes hierarchical from _HIER_MIN_TILES reference tiles:
# rank super-tiles of _SUPER_G adjacent tiles (KD subtrees) first, then only
# the children of the best _SUPER_K.
_SUPER_G = 64
_SUPER_K = 4
_HIER_MIN_TILES = 8192

_VALID_ABS = 1.0e6  # coordinates at or beyond this are sentinel rows


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd bit (Morton interleave helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_keys(xyz: torch.Tensor, lo: torch.Tensor, inv_extent: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N,) int32 30-bit Morton codes over the given bounding box."""
    u = torch.clamp((xyz - lo) * inv_extent, 0.0, 1.0 - 1e-7)
    q = (u * 1024.0).to(torch.int32)
    return _part1by2(q[..., 0]) | (_part1by2(q[..., 1]) << 1) | (_part1by2(q[..., 2]) << 2)


def _bounds(pts: torch.Tensor, valid: torch.Tensor, dim: int):
    """(lo, hi) of valid rows along `dim`; (PAD, -PAD) where none is valid."""
    v = valid[..., None]
    lo = torch.where(v, pts, PAD_COORD).amin(dim)
    hi = torch.where(v, pts, -PAD_COORD).amax(dim)
    return lo, hi


def _finish_index(tiles: torch.Tensor, order: torch.Tensor) -> TileIndex:
    """Per-tile boxes and centroids of (T, S, 3) tiles whose rows with
    order < 0 are padding."""
    t, s, _ = tiles.shape
    tvalid = (order >= 0).reshape(t, s)
    box_lo, box_hi = _bounds(tiles, tvalid, 1)
    n_valid = tvalid.sum(1, keepdim=True)
    centroids = torch.where(tvalid[..., None], tiles, 0.0).sum(1) / n_valid.clamp(min=1)
    # empty tiles get a sentinel centroid so they never rank as candidates
    centroids = torch.where(n_valid > 0, centroids, PAD_COORD)
    return TileIndex(tiles=tiles, box_lo=box_lo, box_hi=box_hi,
                     centroids=centroids, order=order)


def _full_mask(xyz: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.ones((xyz.shape[0],), dtype=torch.bool, device=xyz.device)
    return mask


def build_tile_index(xyz: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                     tile_size: int = 256) -> TileIndex:
    """Morton-sort (N, 3) points into (T, S, 3) tiles."""
    n = xyz.shape[0]
    mask = _full_mask(xyz, mask)
    s = tile_size
    t = -(-n // s)
    pad = t * s - n
    lo, hi = _bounds(xyz, mask, 0)
    inv_extent = 1.0 / torch.clamp(hi - lo, min=1e-6)
    keys = torch.where(mask, morton_keys(xyz, lo, inv_extent), 2**30)  # pads sort last
    order = torch.sort(keys, stable=True).indices
    ok = mask[order]
    sorted_xyz = torch.where(ok[:, None], xyz[order], PAD_COORD)
    order = torch.where(ok, order, -1).to(torch.int32)
    if pad:
        dev = xyz.device
        sorted_xyz = torch.cat([sorted_xyz, torch.full((pad, 3), PAD_COORD, device=dev)])
        order = torch.cat([order, torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    return _finish_index(sorted_xyz.reshape(t, s, 3), order)


def _kd_tile_count(n: int, s: int) -> Tuple[int, int]:
    """(q0, t2): the padded tile count t2 = q0 * 2^k of a KD build. From
    4,096 tiles t rounds up to q0 * 2^k with 64 <= q0 <= 127 (padding under
    ~1.6%); smaller builds round to a power of two."""
    t = max(1, -(-n // s))
    if t >= 4096:
        k = t.bit_length() - 7
        q0 = -(-t // (1 << k))
        return q0, q0 << k
    return 1, 1 << (t - 1).bit_length()


def _kd_schedule(n: int, s: int) -> Tuple[int, int, int, Tuple[int, ...]]:
    """(q0, t2, c0, fans) of a KD build of n points in tiles of s: the
    padded tile count t2 = q0 * 2^k, the Morton segments c0 the median
    phase starts from, and each median level's fan-out (4 while a node has
    enough tiles below it, then 2): one level sort a fan."""
    q0, t2 = _kd_tile_count(n, s)
    total = t2 * s
    c0 = q0
    while total // c0 > _KD_SEG and c0 < t2:
        c0 *= 2
    fans, c = [], c0
    min4 = _FAN4_MIN if t2 >= _FAN4_DEEP else 16
    while c < t2:
        fans.append(4 if t2 // c >= min4 else 2)
        c *= fans[-1]
    return q0, t2, c0, tuple(fans)


def kd_level_sorts(n: int, tile_size: int) -> int:
    """How many level sorts (sort kernel launches on the card) a KD build of
    n points in tiles of `tile_size` runs."""
    return len(_kd_schedule(n, tile_size)[3])


def build_kd_index(xyz: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                   tile_size: int = 256) -> TileIndex:
    """Median-cut (KD-split) partition into compact, balanced tiles.

    One global Morton sort cuts the cloud into segments of at most
    `_KD_SEG` points, then each level sorts every segment by its widest
    axis (stable) and splits it 4 or 2 ways at equal counts. Invalid rows
    carry sentinel keys and sink to each segment's tail, ending as tile
    padding; valid rows stay a global prefix (see `trim_index`).
    """
    n = xyz.shape[0]
    dev = xyz.device
    mask = _full_mask(xyz, mask)
    s = tile_size
    q0, t2, c0, fans = _kd_schedule(n, s)
    total = t2 * s
    pad = total - n

    pts = xyz.to(torch.float32)
    orig = torch.where(mask, torch.arange(n, dtype=torch.int32, device=dev), -1)
    if pad:
        pts = torch.cat([pts, torch.full((pad, 3), PAD_COORD, device=dev)])
        orig = torch.cat([orig, torch.full((pad,), -1, dtype=torch.int32, device=dev)])

    if c0 > 1:
        # one segment, an int32 key: a plain stable torch.sort, as the
        # reference runs lax.sort here outside any kernel
        valid = orig >= 0
        lo, hi = _bounds(pts, valid, 0)
        inv_extent = 1.0 / torch.clamp(hi - lo, min=1e-6)
        mkeys = torch.where(valid, morton_keys(pts, lo, inv_extent), 2**30)
        perm = torch.sort(mkeys, stable=True).indices
        pts, orig = pts[perm], orig[perm]

    c = c0
    for fan in fans:
        m = total // c
        seg = pts.reshape(c, m, 3)
        v = (orig >= 0).reshape(c, m)
        lo, hi = _bounds(seg, v, 1)
        widest = torch.argmax(hi - lo, dim=1)  # (c,): first axis among ties
        vals = torch.take_along_dim(seg, widest[:, None, None], dim=2)[..., 0]
        # the level sort: the sort kernel on a CUDA tensor
        _, pts, orig = sort_segments(torch.where(v, vals, PAD_COORD), (seg, orig.reshape(c, m)))
        pts, orig = pts.reshape(total, 3), orig.reshape(total)
        c *= fan

    valid = orig >= 0
    tiles = torch.where(valid[:, None], pts, PAD_COORD).reshape(t2, s, 3)
    return _finish_index(tiles, orig)


def sort_queries(xyz: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                 tile_size: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Morton-sort queries once: (query_tiles (Tq, S, 3), perm (Tq*S,)
    int32), perm mapping each sorted position to its original row (-1 on
    padding), to unsort the answers. Rigid motion keeps the sort's spatial
    coherence, so a registration sorts once and moves the sorted copy."""
    idx = build_tile_index(xyz, mask, tile_size=tile_size)
    return idx.tiles, idx.order.reshape(-1)


def trim_index(index: TileIndex, capacity: int, multiple: int = 1) -> TileIndex:
    """View of the leading tiles that can hold valid rows (both builders keep
    valid rows in a global prefix), rounded up to a multiple of `multiple`
    tiles: hierarchical ranking wants T % 64 == 0, the coarse phase
    Tq % 4 == 0."""
    t, s, _ = index.tiles.shape
    keep = min(t, -(-capacity // s))
    keep = min(t, -(-keep // multiple) * multiple)
    if keep == t:
        return index
    return TileIndex(
        tiles=index.tiles[:keep],
        box_lo=index.box_lo[:keep],
        box_hi=index.box_hi[:keep],
        centroids=index.centroids[:keep],
        order=index.order[: keep * s],
    )


def coarsen_index(index: TileIndex, factor: int) -> TileIndex:
    """Merge `factor` adjacent tiles into one (T/factor, S*factor, 3) index
    over the same flat point order (adjacent KD tiles are siblings)."""
    t, s, _ = index.tiles.shape
    if t % factor:
        raise ValueError(f"tile count {t} not divisible by {factor}")
    return _finish_index(index.tiles.reshape(t // factor, s * factor, 3), index.order)


# ---- candidate ranking -------------------------------------------------------


def _smallest_k(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries along the last dim, ascending, ties
    to the lower index (`lax.top_k(-score, k)[1]`). Scores must be finite
    and >= 0, so their fp32 bit patterns order like the values."""
    idx = torch.arange(score.shape[-1], device=score.device)
    key = (score.contiguous().view(torch.int32).to(torch.int64) << 32) | idx
    return (torch.topk(key, k, dim=-1, largest=False).values & 0xFFFFFFFF).to(torch.int64)


def _box_sqdist(lo_a, hi_a, lo_b, hi_b) -> torch.Tensor:
    """Pairwise squared distance between AABBs (..., A, 3) x (..., B, 3)
    -> (..., A, B); zero where boxes overlap."""
    gap = torch.maximum(
        lo_b[..., None, :, :] - hi_a[..., :, None, :],
        lo_a[..., :, None, :] - hi_b[..., None, :, :],
    )
    gap = torch.clamp(gap, min=0.0)
    return (gap * gap).sum(-1)


def _query_boxes(query_tiles: torch.Tensor):
    """(lo, hi, centroid) of each query tile's valid rows, (Tq, 3) each."""
    qv = query_tiles.abs().amax(2) < _VALID_ABS  # (Tq, Sq)
    q_lo, q_hi = _bounds(query_tiles, qv, 1)
    nvalid = qv.sum(1, keepdim=True).to(torch.float32).clamp(min=1.0)
    q_cent = torch.where(qv[..., None], query_tiles, 0.0).sum(1) / nvalid
    return q_lo, q_hi, q_cent


def _rank_boxes(q_lo, q_hi, q_cent, box_lo, box_hi, cent, k) -> torch.Tensor:
    """Top-k reference boxes per query box by gap distance, centroid
    distance breaking the zero-gap ties of overlapping boxes."""
    box_d = _box_sqdist(q_lo, q_hi, box_lo, box_hi)
    cent_d = (q_cent * q_cent).sum(1, keepdim=True) + (cent * cent).sum(1)[None, :] \
        - 2.0 * (q_cent @ cent.T)
    cd = 100.0 * box_d + torch.clamp(cent_d, min=0.0)
    return _smallest_k(cd, k)


def _rank_pool(q_lo, q_hi, q_cent, index: TileIndex, sup, g, k) -> torch.Tensor:
    """Top-k child tiles from each query's selected super-tiles; children of
    super-tile s are the id block [s*g, (s+1)*g)."""
    tq, k_s = sup.shape
    ts = index.n_tiles // g
    box_d = torch.zeros((tq, k_s, g), dtype=torch.float32, device=sup.device)
    cent_d = torch.zeros_like(box_d)
    for a in range(3):
        lo_a = index.box_lo[:, a].reshape(ts, g)[sup]
        hi_a = index.box_hi[:, a].reshape(ts, g)[sup]
        ct_a = index.centroids[:, a].reshape(ts, g)[sup]
        qa_lo = q_lo[:, a][:, None, None]
        qa_hi = q_hi[:, a][:, None, None]
        gap = torch.clamp(torch.maximum(lo_a - qa_hi, qa_lo - hi_a), min=0.0)
        box_d = box_d + gap * gap
        dc = ct_a - q_cent[:, a][:, None, None]
        cent_d = cent_d + dc * dc
    cd = (100.0 * box_d + cent_d).reshape(tq, k_s * g)
    child = (sup[:, :, None] * g + torch.arange(g, device=sup.device)).reshape(tq, k_s * g)
    return torch.take_along_dim(child, _smallest_k(cd, k), dim=1)


def _candidate_tiles(query_tiles: torch.Tensor, index: TileIndex,
                     k_tiles: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate reference tiles per query tile: (cand (Tq, K) int64 tile
    ids, best first; query-tile centroids (Tq, 3)). K is clamped to the
    number of reference tiles. From `_HIER_MIN_TILES` tiles (and T % _SUPER_G
    == 0) the ranking is two-level."""
    q_lo, q_hi, q_cent = _query_boxes(query_tiles)
    t = index.n_tiles
    g = _SUPER_G
    if t >= _HIER_MIN_TILES and t % g == 0:
        ts = t // g
        s_lo = index.box_lo.reshape(ts, g, 3).amin(1)
        s_hi = index.box_hi.reshape(ts, g, 3).amax(1)
        # super centroid: mean of the non-empty children's centroids (an
        # all-empty super-tile gets 0, its inverted box keeps it unranked)
        cg = index.centroids.reshape(ts, g, 3)
        c_ok = (cg.abs().amax(2) < _VALID_ABS)[..., None]
        s_cent = torch.where(c_ok, cg, 0.0).sum(1) / c_ok.sum(1).to(torch.float32).clamp(min=1.0)
        k_s = min(_SUPER_K, ts)
        sup = _rank_boxes(q_lo, q_hi, q_cent, s_lo, s_hi, s_cent, k_s)
        cand = _rank_pool(q_lo, q_hi, q_cent, index, sup, g, min(k_tiles, k_s * g))
        return cand, q_cent
    cand = _rank_boxes(q_lo, q_hi, q_cent, index.box_lo, index.box_hi, index.centroids,
                       min(k_tiles, t))
    return cand, q_cent


# ---- the plain fold ----------------------------------------------------------


def _bf16_values(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """Batched a @ b at the reference's matmul precision: "highest" = fp32
    (TF32 stays off); "bf16" = one pass on bf16-rounded inputs with fp32
    accumulation; "high" = the three-pass bf16 split (hi*hi + hi*lo +
    lo*hi). Rounded inputs are multiplied in fp32, where the product of two
    bf16 values is exact, as on the TPU's matrix unit."""
    if prec == "highest":
        return torch.bmm(a, b)
    a_hi, b_hi = _bf16_values(a), _bf16_values(b)
    if prec == "bf16":
        return torch.bmm(a_hi, b_hi)
    if prec != "high":
        raise ValueError(f"unknown precision {prec!r}")
    a_lo, b_lo = _bf16_values(a - a_hi), _bf16_values(b - b_hi)
    return torch.bmm(a_hi, b_hi) + torch.bmm(a_hi, b_lo) + torch.bmm(a_lo, b_hi)


def _score_einsum(q4: torch.Tensor, r4: torch.Tensor, prec: str) -> torch.Tensor:
    """The fold's (Tq, Sq, C) x (Tq, S, C) -> (Tq, Sq, S) score product."""
    return _matmul(q4, r4.transpose(1, 2), prec)


def _chunk_size(tq: int, max_chunk: int) -> int:
    """Query tiles per chunk: an exact divisor of tq in [max_chunk/2,
    max_chunk] where one exists (no ragged last chunk), else max_chunk."""
    if tq <= max_chunk:
        return tq
    for c in range(max_chunk, max_chunk // 2 - 1, -1):
        if tq % c == 0:
            return c
    return max_chunk


def _query_operand(q_cen: torch.Tensor, query_feat: Optional[torch.Tensor], feat_weight: float):
    """The score's query operand [-2 q, 1] (Tq, Sq, 4), with a feature
    channel [-2 q, 1, -2 w^2 f_q] (Tq, Sq, 5); and w^2 in fp32."""
    tq, sq, _ = q_cen.shape
    lam2 = torch.tensor(feat_weight, dtype=torch.float32) ** 2
    ops = [-2.0 * q_cen, torch.ones((tq, sq, 1), dtype=torch.float32, device=q_cen.device)]
    if query_feat is not None:
        ops.append((-2.0 * lam2.to(q_cen.device) * query_feat)[..., None])
    return torch.cat(ops, dim=2), lam2.to(q_cen.device)


def _ref_operand(r: torch.Tensor, f_r: Optional[torch.Tensor], lam2: torch.Tensor) -> torch.Tensor:
    """The reference operand [r, |r|^2] (Tq, S, 4), with a feature channel
    [r, |r|^2 + w^2 f_r^2, f_r] (Tq, S, 5)."""
    rr = (r * r).sum(2)
    if f_r is None:
        return torch.cat([r, rr[..., None]], dim=2)
    return torch.cat([r, (rr + lam2 * f_r * f_r)[..., None], f_r[..., None]], dim=2)


def _query_norm(q_cen: torch.Tensor, query_feat: Optional[torch.Tensor],
                lam2: torch.Tensor) -> torch.Tensor:
    """|q|^2 (Tq, Sq), plus w^2 f_q^2 with a feature channel."""
    qq = (q_cen * q_cen).sum(2)
    if query_feat is not None:
        qq = qq + lam2 * query_feat * query_feat
    return qq


def block_nn(
    query_tiles: torch.Tensor,
    index: TileIndex,
    *,
    k_tiles: int = 8,
    max_chunk: int = 32768,
    return_pos: bool = False,
    cand_tiles: Optional[torch.Tensor] = None,
    query_feat: Optional[torch.Tensor] = None,
    feat_tiles: Optional[torch.Tensor] = None,
    feat_weight: float = 1.0,
    score_prec: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NN of spatially coherent query tiles (Tq, Sq, 3) into the index.

    Returns (sqdist (Tq*Sq,), original ref index (Tq*Sq,) int32), or with
    `return_pos` the sorted flat position into `index.tiles.reshape(-1, 3)`
    (pad matches, >= ~1e15 from the sentinel, get d = inf). `cand_tiles`
    (Tq, K) overrides candidate selection (frozen refine candidates). The
    score is the reference's expansion ||r||^2 - 2 q.r from augmented
    coordinates, at `score_prec` (bf16 on query-tile-centred coordinates).
    Ties go to the earliest candidate, then the lowest lane. Above
    `max_chunk` query tiles the work runs in chunks so the (chunk, Sq, S)
    score stays bounded.

    Feature-augmented matching: with `query_feat` (Tq, Sq) and `feat_tiles`
    (T, S) scalar channels, the NN runs in the 4D metric ||p - q||^2 +
    feat_weight^2 (f_p - f_q)^2. The feature rides the same contraction as
    one more lane ([..., -2 w^2 f_q] against [..., f_r], w^2 f_r^2 in the
    rr lane), while candidate ranking stays spatial; the returned squared
    distances are in the augmented metric.
    """
    if (query_feat is None) != (feat_tiles is None):
        raise ValueError("the feature metric needs both query_feat and feat_tiles")
    tq, sq, _ = query_tiles.shape
    if tq > max_chunk:
        chunk = _chunk_size(tq, max_chunk)
        parts = [
            block_nn(query_tiles[t0:t0 + chunk], index, k_tiles=k_tiles,
                     max_chunk=max_chunk, return_pos=return_pos,
                     cand_tiles=None if cand_tiles is None else cand_tiles[t0:t0 + chunk],
                     query_feat=None if query_feat is None else query_feat[t0:t0 + chunk],
                     feat_tiles=feat_tiles, feat_weight=feat_weight, score_prec=score_prec)
            for t0 in range(0, tq, chunk)
        ]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    s = index.tile_size
    if cand_tiles is None:
        cand_tiles, _ = _candidate_tiles(query_tiles, index, k_tiles)
    cand_tiles = cand_tiles.to(torch.int64)

    qc = _query_boxes(query_tiles)[2] if score_prec == "bf16" else None  # tile centroid
    q_cen = query_tiles - qc[:, None, :] if qc is not None else query_tiles
    q4, lam2 = _query_operand(q_cen, query_feat, feat_weight)

    best_s = torch.full((tq, sq), float("inf"), device=query_tiles.device)
    best_p = torch.zeros((tq, sq), dtype=torch.int64, device=query_tiles.device)
    for kk in range(cand_tiles.shape[1]):
        tid = cand_tiles[:, kk]
        r = index.tiles[tid]  # (Tq, S, 3) contiguous-row gather
        if qc is not None:
            r = r - qc[:, None, :]
        r4 = _ref_operand(r, None if feat_tiles is None else feat_tiles[tid], lam2)
        smin, sarg = _score_einsum(q4, r4, score_prec).min(dim=2)  # first lane among ties
        better = smin < best_s
        best_s = torch.where(better, smin, best_s)
        best_p = torch.where(better, tid[:, None] * s + sarg, best_p)

    qq = _query_norm(q_cen, query_feat, lam2)
    d = torch.clamp(best_s + qq, min=0.0).reshape(-1)
    best_p = best_p.reshape(-1)
    if return_pos:
        return torch.where(d < 1e15, d, float("inf")), best_p.to(torch.int32)
    ridx = index.order[best_p]
    return torch.where(ridx >= 0, d, float("inf")), torch.clamp(ridx, min=0)


def block_nn_payload(
    query_tiles: torch.Tensor,
    index: TileIndex,
    payload_tiles: torch.Tensor,
    *,
    k_tiles: int = 8,
    max_chunk: int = 32768,
    cand_tiles: Optional[torch.Tensor] = None,
    query_feat: Optional[torch.Tensor] = None,
    feat_tiles: Optional[torch.Tensor] = None,
    feat_weight: float = 1.0,
    score_prec: str = "highest",
    payload_prec: str = "high",
    payload_xyz: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like `block_nn`, but returns each query's matched payload row
    (`payload_mode="infold"`): (sqdist (Tq*Sq,), payload (Tq*Sq, D)).

    Per candidate tile the winner is the lowest lane among the least
    scores; across candidates a strict `<` keeps the earliest. Sentinel
    rows score inf, so a query whose candidates are all sentinel gets
    d = inf and a zero payload (unlike the gather path's sentinel row).
    `payload_prec="high"` copies the winning row exactly (the reference's
    one-hot product on its matrix unit); "bf16" rounds the payload values
    to bf16, with the first `payload_xyz` channels centred on the
    query-tile centroid first and un-centred in fp32 after (this needs
    `score_prec="bf16"`, which provides the centroid). `cand_tiles`, the
    feature metric (`query_feat`, `feat_tiles`, `feat_weight`) and chunking
    behave as in `block_nn`.
    """
    if (query_feat is None) != (feat_tiles is None):
        raise ValueError("the feature metric needs both query_feat and feat_tiles")
    tq, sq, _ = query_tiles.shape
    if tq > max_chunk:
        chunk = _chunk_size(tq, max_chunk)
        parts = [
            block_nn_payload(query_tiles[t0:t0 + chunk], index, payload_tiles, k_tiles=k_tiles,
                             max_chunk=max_chunk,
                             cand_tiles=None if cand_tiles is None else cand_tiles[t0:t0 + chunk],
                             query_feat=None if query_feat is None else query_feat[t0:t0 + chunk],
                             feat_tiles=feat_tiles, feat_weight=feat_weight,
                             score_prec=score_prec, payload_prec=payload_prec,
                             payload_xyz=payload_xyz)
            for t0 in range(0, tq, chunk)
        ]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    if cand_tiles is None:
        cand_tiles, _ = _candidate_tiles(query_tiles, index, k_tiles)
    cand_tiles = cand_tiles.to(torch.int64)
    dev = query_tiles.device
    d_pl = payload_tiles.shape[2]

    qc = _query_boxes(query_tiles)[2] if score_prec == "bf16" else None
    q_cen = query_tiles - qc[:, None, :] if qc is not None else query_tiles
    pl_bf16 = payload_prec == "bf16"
    center_pl = pl_bf16 and payload_xyz > 0
    if center_pl and qc is None:
        raise ValueError("payload_prec='bf16' with payload_xyz needs bf16 scoring "
                         "(the query-tile centroid that makes centring available)")
    q4, lam2 = _query_operand(q_cen, query_feat, feat_weight)

    best_s = torch.full((tq, sq), float("inf"), device=dev)
    best_pl = torch.zeros((tq, sq, d_pl), dtype=torch.float32, device=dev)
    best_valid = torch.zeros((tq, sq), dtype=torch.bool, device=dev)
    for kk in range(cand_tiles.shape[1]):
        tid = cand_tiles[:, kk]
        r = index.tiles[tid]  # (Tq, S, 3)
        pl = payload_tiles[tid]  # (Tq, S, D)
        if center_pl:
            pl = torch.cat([pl[..., :payload_xyz] - qc[:, None, :payload_xyz],
                            pl[..., payload_xyz:]], dim=2)
        rvalid = r.abs().amax(2) < _VALID_ABS
        if qc is not None:
            r = r - qc[:, None, :]
        r4 = _ref_operand(r, None if feat_tiles is None else feat_tiles[tid], lam2)
        score = torch.where(rvalid[:, None, :], _score_einsum(q4, r4, score_prec), float("inf"))
        smin, win = score.min(dim=2)  # the lowest lane among ties
        cand_pl = torch.take_along_dim(pl, win[..., None], dim=1)  # (Tq, Sq, D)
        if pl_bf16:
            cand_pl = _bf16_values(cand_pl)
        better = smin < best_s
        best_s = torch.where(better, smin, best_s)
        best_pl = torch.where(better[..., None], cand_pl, best_pl)
        best_valid = torch.where(better, torch.isfinite(smin), best_valid)

    if center_pl:  # un-centre in fp32; misses keep their zero payload
        xyz = torch.where(best_valid[..., None],
                          best_pl[..., :payload_xyz] + qc[:, None, :payload_xyz], 0.0)
        best_pl = torch.cat([xyz, best_pl[..., payload_xyz:]], dim=2)
    qq = _query_norm(q_cen, query_feat, lam2)
    d = torch.where(best_valid, torch.clamp(best_s + qq, min=0.0), float("inf"))
    return d.reshape(-1), best_pl.reshape(tq * sq, d_pl)


def _smallest_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k smallest entries along the last dim,
    ascending, ties to the lower index (`lax.top_k(-x, k)`) for any values,
    inf included: a stable sort."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def block_knn(query_tiles: torch.Tensor, index: TileIndex, k: int, *,
              k_tiles: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours through the tile index: (sqdists (Tq*Sq, k)
    ascending, original reference indices (Tq*Sq, k)), with `block_nn`'s
    candidate tiles. Two stages a candidate tile, as in the reference: the
    tile's own k best by the expansion score, then the k best of those and
    the running list (the running list first among ties). Rows that end on
    a pad row, or on no row at all, get (inf, 0)."""
    tq, sq, _ = query_tiles.shape
    s = index.tile_size
    dev = query_tiles.device
    cand_tiles, _ = _candidate_tiles(query_tiles, index, k_tiles)
    cand_tiles = cand_tiles.to(torch.int64)
    q4, _ = _query_operand(query_tiles, None, 1.0)

    best_s = torch.full((tq, sq, k), float("inf"), device=dev)
    best_p = torch.zeros((tq, sq, k), dtype=torch.int64, device=dev)
    for kk in range(cand_tiles.shape[1]):
        tid = cand_tiles[:, kk]
        r = index.tiles[tid]
        score = _score_einsum(q4, _ref_operand(r, None, None), "highest")  # (Tq, Sq, S)
        cs, cloc = _smallest_k_stable(score, min(k, s))
        cpos = tid[:, None, None] * s + cloc
        best_s, sel = _smallest_k_stable(torch.cat([best_s, cs], dim=2), k)
        best_p = torch.take_along_dim(torch.cat([best_p, cpos], dim=2), sel, dim=2)

    qq = (query_tiles * query_tiles).sum(2)[..., None]
    d = torch.clamp(best_s + qq, min=0.0).reshape(tq * sq, k)
    ridx = index.order[best_p.reshape(tq * sq, k)]
    return torch.where(ridx >= 0, d, float("inf")), torch.clamp(ridx, min=0)


def tile_payload(index: TileIndex, payload: torch.Tensor) -> torch.Tensor:
    """Per-point payload (N, D) in original order -> the index's (T, S, D)
    sorted-tile layout (zeros on padding)."""
    order = index.order.to(torch.int64)
    ok = order >= 0
    flat = torch.where(ok[:, None], payload[torch.clamp(order, min=0)], 0.0)
    return flat.reshape(index.n_tiles, index.tile_size, payload.shape[1])


def fused_payload_table(index: TileIndex, aux: torch.Tensor) -> torch.Tensor:
    """The fused (T*S, 3+D) `[xyz || aux]` table in sorted tile order: the
    rows that `block_nn(..., return_pos=True)` positions index into."""
    return torch.cat([index.tiles.reshape(-1, 3),
                      tile_payload(index, aux).reshape(-1, aux.shape[1])], dim=1)


def block_radius_moments(
    query_tiles: torch.Tensor,
    index: TileIndex,
    radius,
    *,
    k_tiles: int = 8,
    max_chunk: int = 8192,
    prec: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Neighbourhood moments within `radius` of each query: the reference's
    XLA moments path (`moments_mode="xla"`).

    Over every candidate-tile point within `radius` it accumulates count,
    sum(x) and sum(x x^T), with coordinates centred on the query-tile
    centroid first so the E[xx] - E[x]E[x] subtraction is safe in fp32.
    The radius test uses the reference's expansion score. Returns (count
    (N,), mean (N, 3), cov (N, 3, 3)) in sorted-query order, N = Tq*Sq.
    """
    tq, sq, _ = query_tiles.shape
    if tq > max_chunk:
        chunk = _chunk_size(tq, max_chunk)
        parts = [block_radius_moments(query_tiles[t0:t0 + chunk], index, radius,
                                      k_tiles=k_tiles, max_chunk=max_chunk, prec=prec)
                 for t0 in range(0, tq, chunk)]
        return tuple(torch.cat([p[i] for p in parts]) for i in range(3))
    cand_tiles, q_cent = _candidate_tiles(query_tiles, index, k_tiles)
    r2 = torch.as_tensor(radius, dtype=torch.float32, device=query_tiles.device) ** 2

    qc = query_tiles - q_cent[:, None, :]
    ones = torch.ones((tq, sq, 1), dtype=torch.float32, device=query_tiles.device)
    q4 = torch.cat([-2.0 * qc, ones], dim=2)
    qq = (qc * qc).sum(2)
    m_prec = "high" if prec == "bf16" else prec

    moments = torch.zeros((tq, sq, 10), dtype=torch.float32, device=query_tiles.device)
    for kk in range(cand_tiles.shape[1]):
        r = index.tiles[cand_tiles[:, kk]] - q_cent[:, None, :]  # (Tq, S, 3) centred
        rvalid = r.abs().amax(2) < _VALID_ABS
        r4 = torch.cat([r, (r * r).sum(2, keepdim=True)], dim=2)
        d = _score_einsum(q4, r4, prec) + qq[..., None]
        w = ((d <= r2) & rvalid[:, None, :]).to(torch.float32)
        x, y, z = r[..., 0], r[..., 1], r[..., 2]
        feat = torch.stack([torch.ones_like(x), x, y, z, x * x, y * y, z * z,
                            x * y, x * z, y * z], dim=2)  # (Tq, S, 10)
        moments = moments + _matmul(w, feat, m_prec)

    m = moments.reshape(tq * sq, 10)
    cnt = m[:, 0]
    safe = torch.clamp(cnt, min=1.0)[:, None]
    mean_c = m[:, 1:4] / safe
    exx = torch.stack([
        torch.stack([m[:, 4], m[:, 7], m[:, 8]], dim=1),
        torch.stack([m[:, 7], m[:, 5], m[:, 9]], dim=1),
        torch.stack([m[:, 8], m[:, 9], m[:, 6]], dim=1),
    ], dim=1) / safe[..., None]
    cov = exx - mean_c[:, :, None] * mean_c[:, None, :]
    mean = mean_c + torch.repeat_interleave(q_cent, sq, dim=0)
    return cnt, mean, cov

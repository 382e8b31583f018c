"""Ring nearest-neighbour passes: the ring-attention analogue.

Mirrors `icpx/distributed/ring.py`. When the target cloud is sharded over
the points axis too (too large to replicate on each device), each rank
keeps its query shard and the target shards rotate around the ring; each
step folds the visiting shard into a running (least distance, answer)
accumulator, with `d < best` keeping the earlier step on ties. Step s on
rank r folds shard (r + s) % W.

Communication hides behind the fold: each step posts the shift of the
shard it is about to fold (`comm.ring_shift`: send to rank - 1, receive
from rank + 1), folds, then waits, so the transfer runs under the fold.
The last step posts nothing: the reference's W-th permute only rotates the
shards back home, and its result is never read.

Call with the ring axis's process group (`mesh.get_group("points")`);
every rank of the group must call together.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from icpx_torch.distributed import comm
from icpx_torch.kernels.blocknn import TileIndex, block_nn_payload
from icpx_torch.kernels.knn import nearest_neighbor

_INDEX_FIELDS = tuple(f.name for f in dataclasses.fields(TileIndex))


def ring_nearest_neighbor(
    query: torch.Tensor,
    ref_shard: torch.Tensor,
    ref_mask_shard: torch.Tensor,
    group,
    *,
    payload_shard: Optional[torch.Tensor] = None,
    tile_q: int = 2048,
    tile_r: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """NN of the local `query` (Nq, 3) against the union of every rank's
    `ref_shard` (Ns, 3): each fold is one exact brute pass
    (`nearest_neighbor`, the nn kernel on the card).

    Returns (sqdist (Nq,), global index (Nq,) int32, gathered payload or
    None). A global index is `owner * Ns + local index`, the row in the
    concatenation of the shards in rank order. `payload_shard` (Ns, D)
    rides the ring with the coordinates and is gathered at fold time."""
    n_dev = comm.axis_size(group)
    owner = comm.axis_index(group)
    nq, shard_n = query.shape[0], ref_shard.shape[0]
    has_payload = payload_shard is not None
    payload = payload_shard if has_payload else torch.zeros(
        (shard_n, 1), dtype=torch.float32, device=query.device)
    best_d = torch.full((nq,), float("inf"), dtype=torch.float32, device=query.device)
    best_i = torch.zeros((nq,), dtype=torch.int32, device=query.device)
    best_pl = torch.zeros((nq, payload.shape[1]), dtype=payload.dtype, device=query.device)
    cur = [ref_shard, ref_mask_shard, payload]
    for step in range(n_dev):
        shift = comm.ring_shift(cur, group) if step < n_dev - 1 else None
        d, li = nearest_neighbor(query, cur[0], ref_mask=cur[1], tile_q=tile_q, tile_r=tile_r)
        comm.note_fold()
        better = d < best_d
        best_d = torch.where(better, d, best_d)
        best_i = torch.where(better, (owner * shard_n + li).to(torch.int32), best_i)
        best_pl = torch.where(better[:, None], cur[2][li.long()], best_pl)
        if shift is not None:
            cur = shift.wait()
        owner = (owner + 1) % n_dev
    return best_d, best_i, (best_pl if has_payload else None)


def ring_block_nn(
    query_tiles: torch.Tensor,
    index: TileIndex,
    payload_tiles: torch.Tensor,
    group,
    *,
    k_tiles: int = 8,
    query_feat: Optional[torch.Tensor] = None,
    feat_tiles: Optional[torch.Tensor] = None,
    feat_weight: float = 1.0,
    score_prec: str = "highest",
    payload_prec: str = "high",
    payload_xyz: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block (tile-index) NN of the local query tiles against the union of
    every rank's target shard: each rank holds a `TileIndex` over its
    shard and the matching (T, S, D) payload tiles (`tile_payload`); both,
    and the feature tiles of the feature-augmented metric, rotate around
    the ring while each step folds a `block_nn_payload` answer.

    Returns (sqdist (Nq,), payload rows (Nq, D)); inf distance and a zero
    payload where no shard held a valid candidate. Every shard's index must
    have the same shape (the same trim on every rank)."""
    n_dev = comm.axis_size(group)
    nq = query_tiles.shape[0] * query_tiles.shape[1]
    dev = query_tiles.device
    has_feat = query_feat is not None
    best_d = torch.full((nq,), float("inf"), dtype=torch.float32, device=dev)
    best_pl = torch.zeros((nq, payload_tiles.shape[2]), dtype=payload_tiles.dtype, device=dev)
    n = len(_INDEX_FIELDS)  # the index's tensors, then the payload and feature tiles
    cur = [getattr(index, f) for f in _INDEX_FIELDS] + [payload_tiles]
    if has_feat:
        cur.append(feat_tiles)
    for step in range(n_dev):
        shift = comm.ring_shift(cur, group) if step < n_dev - 1 else None
        idx = TileIndex(*cur[:n])
        d, pl = block_nn_payload(
            query_tiles, idx, cur[n], k_tiles=k_tiles,
            query_feat=query_feat, feat_tiles=cur[n + 1] if has_feat else None,
            feat_weight=feat_weight, score_prec=score_prec, payload_prec=payload_prec,
            payload_xyz=payload_xyz,
        )
        comm.note_fold()
        better = d < best_d
        best_d = torch.where(better, d, best_d)
        best_pl = torch.where(better[:, None], pl, best_pl)
        if shift is not None:
            cur = shift.wait()
    return best_d, best_pl

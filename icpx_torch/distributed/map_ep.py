"""Map blocks and all-to-all scan routing: the distributed scan-to-map
correspondence engine.

Mirrors `icpx/distributed/map_ep.py`. The global map is cut into
contiguous Morton-key ranges ("map blocks"), one a rank along the
``blocks`` mesh axis. A scan, sharded by points, is matched against the
map by routing each point to the rank owning its Morton range (the
mixture-of-experts dispatch pattern):

  1. a point's destination is its Morton key's block (a count of the
     static block boundaries at or below the key);
  2. points pack into fixed-capacity per-destination send buffers
     (capacity factor x fair share); overflow drops, as MoE drops tokens,
     and a dropped point answers inf, absorbed by the robust gate;
  3. one all-to-all ships the buffers (`comm.all_to_all`);
  4. each rank answers the queries it received against its block: brute
     (`nearest_neighbor`, the nn kernel on the card) or through a tile
     index over the block, built once a registration (the sort kernel);
  5. a second all-to-all returns the (distance, matched xyz + normal) rows
     to the owners, which unpack them into point order.

The reference sends the distances and the payload back in two
all-to-alls; here they travel as one (n, cap, 7) buffer.

Boundary effect: a point near a block edge sees only the blocks it is
routed to. Extra hops (`n_route` > 1) go to spatial neighbour blocks: the
blocks of the point moved by +-`route_radius` along each axis, the first
distinct ones in a fixed order (`route_mode="spatial"`), or to
Morton-adjacent ranges (`route_mode="morton"`). The brute answer is
`nearest_neighbor`, whose contract is the reference's
`_nearest_neighbor_jnp`'s: least d^2, the lowest index among ties, and
(inf, 0) where nothing is valid.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import torch

from icpx_torch.cloud import PAD_COORD
from icpx_torch.distributed import comm
from icpx_torch.kernels.blocknn import block_nn, fused_payload_table, morton_keys, sort_queries
from icpx_torch.kernels.knn import nearest_neighbor

_BIG = 2**30


@dataclasses.dataclass(frozen=True)
class MapBlocks:
    """A Morton-partitioned map, one block a rank (every rank holds all of
    it; a rank reads its own row of each block array)."""

    block_xyz: torch.Tensor  # (B, S, 3) sentinel-padded block points
    block_normals: torch.Tensor  # (B, S, 3)
    block_mask: torch.Tensor  # (B, S)
    boundaries: torch.Tensor  # (B + 1,) int32 Morton key range edges
    lo: torch.Tensor  # (3,) the bbox corner the keys are taken from
    inv_extent: torch.Tensor  # (3,)

    @property
    def n_blocks(self) -> int:
        return self.block_xyz.shape[0]

    @property
    def block_size(self) -> int:
        return self.block_xyz.shape[1]


def partition_map(xyz: torch.Tensor, normals: torch.Tensor, mask: torch.Tensor, *,
                  n_blocks: int) -> MapBlocks:
    """Split a map cloud into `n_blocks` equal-count Morton-range blocks:
    a stable sort of the keys (invalid rows last), the sorted rows cut into
    equal blocks, each boundary the key at a block's first row."""
    n = xyz.shape[0]
    if n % n_blocks:
        raise ValueError(f"map capacity {n} not divisible by {n_blocks}")
    s = n // n_blocks
    dev = xyz.device
    lo = torch.where(mask[:, None], xyz, PAD_COORD).amin(0)
    hi = torch.where(mask[:, None], xyz, -PAD_COORD).amax(0)
    inv_extent = 1.0 / torch.clamp(hi - lo, min=1e-6)
    keys = torch.where(mask, morton_keys(xyz, lo, inv_extent), _BIG)
    order = torch.sort(keys, stable=True).indices
    sk = keys[order]
    ok = mask[order]
    sorted_xyz = torch.where(ok[:, None], xyz[order], PAD_COORD)
    sorted_nrm = torch.where(ok[:, None], normals[order], 0.0)
    i32 = dict(dtype=torch.int32, device=dev)
    boundaries = torch.cat([torch.tensor([-_BIG], **i32), sk[::s][1:].to(torch.int32),
                            torch.tensor([_BIG], **i32)])
    return MapBlocks(block_xyz=sorted_xyz.reshape(n_blocks, s, 3),
                     block_normals=sorted_nrm.reshape(n_blocks, s, 3),
                     block_mask=ok.reshape(n_blocks, s), boundaries=boundaries, lo=lo,
                     inv_extent=inv_extent)


def _destinations(query, boundaries, lo, inv_extent, n_dev, n_route, route_mode, route_radius):
    """Each point's destination blocks, one (Nq,) tensor a hop: its own
    block first."""
    inner = boundaries[1:-1]

    def block_of(k):
        return (k[:, None] >= inner[None, :]).to(torch.int32).sum(1)

    primary = block_of(morton_keys(query, lo, inv_extent))
    dests = [primary]
    if route_mode == "spatial" and n_route > 1:
        if route_radius is None:
            r = 0.04 * torch.mean(1.0 / inv_extent)
        else:
            r = torch.tensor(route_radius, dtype=torch.float32, device=query.device)
        # the blocks of the 6 axis-moved positions, in a fixed order
        nbr = []
        for a in range(3):
            for sgn in (1.0, -1.0):
                qp = query.clone()
                qp[:, a] = qp[:, a] + sgn * r
                nbr.append(block_of(morton_keys(qp, lo, inv_extent)))
        nbr = torch.stack(nbr, dim=1)  # (Nq, 6)
        for _ in range(n_route - 1):
            taken = torch.stack(dests, dim=1)
            is_new = (nbr[:, :, None] != taken[:, None, :]).all(2)
            first = torch.argmax(is_new.to(torch.int32), dim=1)
            pick = torch.gather(nbr, 1, first[:, None])[:, 0]
            # no distinct neighbour: resend to the primary (a harmless
            # duplicate answer that keeps the shapes fixed)
            dests.append(torch.where(is_new.any(1), pick, primary))
    else:
        for hop in (1, -1, 2, -2)[: max(n_route - 1, 0)]:
            dests.append(torch.clamp(primary + hop, 0, n_dev - 1))
    return dests


def routed_map_nn(
    query: torch.Tensor,  # (Nq_local, 3) this rank's scan shard
    my_block_xyz: torch.Tensor,  # (S, 3) this rank's map block
    my_block_normals: torch.Tensor,  # (S, 3)
    my_block_mask: torch.Tensor,  # (S,)
    boundaries: torch.Tensor,  # (B + 1,)
    lo: torch.Tensor,
    inv_extent: torch.Tensor,
    group,
    *,
    capacity_factor: float = 2.0,
    n_route: int = 2,
    tile_q: int = 512,
    tile_r: int = 2048,
    route_mode: str = "spatial",
    route_radius: Optional[float] = None,
    block_index=None,
    block_payload: Optional[torch.Tensor] = None,
    block_k_tiles: int = 8,
    block_q_tile: int = 1,
    score_prec: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All-to-all routed NN over the `blocks` group (every rank calls).

    Returns (sqdist (Nq_local,), matched xyz (Nq_local, 3), matched normals
    (Nq_local, 3)); inf distance for dropped or missed points.

    `route_radius` defaults to 4% of the map's mean extent. With
    `block_index` (a `TileIndex` over this rank's block, built once a
    registration) and `block_payload` (its fused (S, 6) xyz + normal
    table in sorted tile order), received queries are answered by
    `block_nn` instead of the brute pass; they arrive in packed order, so
    they are Morton-sorted first (dropped-slot sentinel rows masked out)
    and ranked per query (`block_q_tile=1`: routed queries are sparse
    against a block, and per-query ranking keeps the exact rate)."""
    n_dev = comm.axis_size(group)
    nq = query.shape[0]
    dev = query.device
    cap = int(capacity_factor * nq * n_route / n_dev)
    cap = max(64, ((cap + 7) // 8) * 8)
    nqf = n_dev * cap
    dests = _destinations(query, boundaries, lo, inv_extent, n_dev, n_route, route_mode,
                          route_radius)

    d_best = torch.full((nq,), float("inf"), dtype=torch.float32, device=dev)
    pl_best = torch.zeros((nq, 6), dtype=torch.float32, device=dev)
    idxs = torch.arange(nq, dtype=torch.int64, device=dev)
    for dest in dests:
        # pack: sort by destination, rank within it, drop past the capacity
        order = torch.sort(dest, stable=True).indices
        sd = dest[order].to(torch.int64)
        is_first = torch.ones((nq,), dtype=torch.bool, device=dev)
        is_first[1:] = sd[1:] != sd[:-1]
        first_pos = torch.cummax(torch.where(is_first, idxs, 0), dim=0).values
        rank = idxs - first_pos
        keep = rank < cap
        slot = torch.where(keep, sd * cap + rank, nqf)
        send = torch.full((nqf + 1, 3), PAD_COORD, dtype=torch.float32, device=dev)
        send[slot] = query[order]
        sent_slot = torch.full((nqf + 1,), -1, dtype=torch.int64, device=dev)
        sent_slot[slot] = order
        send, sent_slot = send[:nqf], sent_slot[:nqf]

        # ship the queries to the owners, answer, ship the answers back
        flat_q = comm.all_to_all(send.reshape(n_dev, cap, 3), group).reshape(nqf, 3)
        if block_index is not None:
            qmask = (flat_q.abs() < 0.5 * PAD_COORD).all(1)
            q_tiles, qperm = sort_queries(flat_q, qmask, tile_size=block_q_tile)
            d2_s, qpos = block_nn(q_tiles, block_index, k_tiles=block_k_tiles, return_pos=True,
                                  score_prec=score_prec)
            pl_s = block_payload[qpos.long()]
            safe_q = torch.where(qperm >= 0, qperm.long(), nqf)
            d2 = torch.full((nqf + 1,), float("inf"), dtype=torch.float32, device=dev)
            d2[safe_q] = d2_s
            matched = torch.zeros((nqf + 1, 6), dtype=torch.float32, device=dev)
            matched[safe_q] = pl_s
            d2, matched = d2[:nqf], matched[:nqf]
        else:
            d2, li = nearest_neighbor(flat_q, my_block_xyz, ref_mask=my_block_mask,
                                      tile_q=tile_q, tile_r=tile_r)
            li = li.long()
            matched = torch.cat([my_block_xyz[li], my_block_normals[li]], dim=1)
        answers = torch.cat([d2[:, None], matched], dim=1).reshape(n_dev, cap, 7)
        back = comm.all_to_all(answers, group).reshape(nqf, 7)

        # unpack: slot -> original row
        safe = torch.where(sent_slot >= 0, sent_slot, nq)
        d_back = torch.full((nq + 1,), float("inf"), dtype=torch.float32, device=dev)
        d_back = d_back.scatter_reduce(0, safe, back[:, 0], reduce="amin")[:nq]
        pl_back = torch.zeros((nq + 1, 6), dtype=torch.float32, device=dev)
        pl_back[safe] = back[:, 1:]
        pl_back = pl_back[:nq]
        better = d_back < d_best
        d_best = torch.where(better, d_back, d_best)
        pl_best = torch.where(better[:, None], pl_back, pl_best)
    return d_best, pl_best[:, :3], pl_best[:, 3:]


def sharded_map_register(scan, map_blocks: MapBlocks, config, mesh, init=None, *,
                         axis: str = "blocks", capacity_factor: float = 2.0, n_route: int = 2,
                         nn: str = "auto"):
    """Scan-to-map ICP: the scan's points sharded and the map blocks one a
    rank over `axis`; every rank passes the same scan and map.

    The scan must carry normals (estimate first), its capacity must divide
    by the axis size and the map's block count equal it. Returns the same
    `ICPResult` as `register`. `nn`: "brute" answers routed queries against
    the whole local block each hop; "block" builds a tile index over the
    block once a registration (the map does not move) and answers through
    `block_nn`; "auto" picks block from `config.block_auto_threshold`
    points a block."""
    from icpx_torch.geometry.se3 import SE3
    from icpx_torch.registration.icp import _icp_scan

    group = mesh.get_group(axis)
    n_dev = comm.axis_size(group)
    if map_blocks.n_blocks != n_dev:
        raise ValueError(f"map has {map_blocks.n_blocks} blocks but mesh axis '{axis}' "
                         f"has {n_dev} devices")
    if scan.capacity % n_dev:
        raise ValueError(f"scan capacity {scan.capacity} not divisible by {n_dev}")
    if scan.normals is None:
        raise ValueError("scan must carry normals (estimate_normals first)")
    if nn not in ("auto", "brute", "block"):
        raise ValueError(f"nn must be auto|brute|block, got {nn!r}")
    if init is None:
        init = SE3.identity(device=scan.device)
    use_block = nn == "block" or (nn == "auto"
                                  and map_blocks.block_size >= config.block_auto_threshold)
    me = comm.axis_index(group)
    b_xyz, b_n, b_mask = (map_blocks.block_xyz[me], map_blocks.block_normals[me],
                          map_blocks.block_mask[me])
    if use_block:
        # built once a registration: the map block never moves, only the scan
        b_idx = config.tile_builder()(b_xyz, b_mask, tile_size=config.block_tile)
        b_pl = fused_payload_table(b_idx, b_n)
    else:
        b_idx = b_pl = None

    def nn_fn(p):
        d2, q, n_q = routed_map_nn(
            p, b_xyz, b_n, b_mask, map_blocks.boundaries, map_blocks.lo, map_blocks.inv_extent,
            group, capacity_factor=capacity_factor, n_route=n_route, block_index=b_idx,
            block_payload=b_pl, block_k_tiles=config.block_k,
            score_prec=config.resolve_score_prec(),
        )
        return q, n_q, torch.sqrt(d2)

    return _icp_scan(config, comm.shard(scan.xyz, group), comm.shard(scan.mask, group),
                     comm.shard(scan.normals, group), init, nn_fn,
                     partial(comm.psum, group=group))

"""Sharded ICP over a device mesh.

Mirrors `icpx/distributed/sharded_icp.py`. The reference wraps the whole
ICP loop in one `shard_map`; here every rank of the mesh calls the same
entry point with the same global clouds, takes its own shard, and runs
`_icp_scan` with `reduce` a psum over the points group (`comm.psum`), so
every rank holds the same transform after each iteration and the result
is replicated:

  * `sharded_register`: one pair, the source points sharded over the
    ``points`` axis. The target is replicated (default), or sharded too
    with ring NN passes (`ring=True`: the target shards rotate around the
    ring). An iteration's traffic: the centroids, the 6x6 normal equations
    and the convergence sums (psum), the stop flag, plus the ring rotation
    when enabled. The NN a shard runs is the nn kernel (brute) or a
    per-shard KD index built through the sort kernel (block).
  * `sharded_register_pairs`: a batch of pairs sharded over ``pairs``, each
    pair's source points over ``points``; the ranks of one pairs row
    register their pairs one after another (as `register_batch` does) and
    the rows' results are gathered, so every rank returns the whole batch.

Hazard: any `reduce` but `identity_reduce` switches the robust statistics
to psum'd histogram quantiles (`registration.step`), even at one rank: a
sharded run equals `register()` only under exact robust settings (a fixed
`robust_scale` or robust "none", no trimming); with the MAD scale or
trimming it agrees to ~1e-4. Summation order: gloo's all-reduce and XLA's
psum round in their own orders, so a W-rank run agrees with the
reference's W-device run to ~1e-6 in the transform, not bit for bit.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from icpx_torch.cloud import PointCloud
from icpx_torch.distributed import comm
from icpx_torch.distributed.ring import ring_block_nn, ring_nearest_neighbor
from icpx_torch.geometry.se3 import SE3
from icpx_torch.kernels.blocknn import _SUPER_G, block_nn, tile_payload, trim_index
from icpx_torch.kernels.knn import nearest_neighbor
from icpx_torch.kernels.normals import estimate_covariances, estimate_normals
from icpx_torch.registration.icp import (
    ICPConfig,
    ICPResult,
    _centre_pair,
    _icp_scan,
    _stack_results,
    gicp_cov_rot,
)


def sharded_register(
    src: PointCloud,
    tgt: PointCloud,
    config: ICPConfig,
    mesh,
    init: Optional[SE3] = None,
    *,
    points_axis: str = "points",
    ring: bool = False,
) -> ICPResult:
    """Single-pair ICP with the source points sharded over `mesh`'s
    `points_axis`; every rank passes the same global clouds.

    Capacities must divide by the axis size (pad with `PointCloud.pad_to`).
    Normals (or GICP covariances) are estimated up front, replicated, when
    missing. With `ring=True` the target is sharded too and NN runs as ring
    passes. `config.nn_method` applies per shard: "block" sorts the local
    source shard into tiles once and answers NN through a tile index over
    the target (over the local target shard with `ring=True`, the whole
    target otherwise), built through the sort kernel. Both clouds are
    shifted by the target centroid and the shift is composed back into the
    returned transform, as `register()` does."""
    use_feat = bool(config.feat_nn) and config.feat_nn_weight > 0
    if use_feat and config.resolve_nn(tgt.capacity) != "block":
        raise ValueError(
            "feature-augmented matching (feat_nn) needs the block NN "
            "path (same constraint as single-device register)"
        )
    group = mesh.get_group(points_axis)
    n_shards = comm.axis_size(group)
    if src.capacity % n_shards or tgt.capacity % n_shards:
        raise ValueError(
            f"cloud capacities ({src.capacity}, {tgt.capacity}) must be "
            f"divisible by the '{points_axis}' axis size {n_shards}"
        )
    # target-centroid centring, conjugated back into the returned transform
    center = tgt.centroid()
    eye = torch.eye(3, dtype=torch.float32, device=center.device)
    shift, unshift = SE3(R=eye, t=-center), SE3(R=eye, t=center)
    src = src.with_xyz(src.xyz - center[None, :])
    tgt = tgt.with_xyz(tgt.xyz - center[None, :])
    if init is not None:
        init = shift @ init @ unshift
    if config.objective == "gicp":
        if src.covs is None:
            src = estimate_covariances(src, k=max(config.k_normals, 15))
        if tgt.covs is None:
            tgt = estimate_covariances(tgt, k=max(config.k_normals, 15))
        src_n = src.covs.reshape(src.capacity, 9)
        tgt_n = tgt.covs.reshape(tgt.capacity, 9)
        aux_rot = gicp_cov_rot
    else:
        needs_normals = config.objective in ("symmetric", "p2plane")
        if needs_normals and config.objective == "symmetric" and src.normals is None:
            src = estimate_normals(src, k=config.k_normals)
        if needs_normals and tgt.normals is None:
            tgt = estimate_normals(tgt, k=config.k_normals)
        src_n = src.normals if src.normals is not None else torch.zeros_like(src.xyz)
        tgt_n = tgt.normals if tgt.normals is not None else torch.zeros_like(tgt.xyz)
        aux_rot = None
    if init is None:
        init = SE3.identity(device=tgt.device)
    nn_method = config.resolve_nn(tgt.capacity)
    reduce = partial(comm.psum, group=group)

    s_xyz, s_mask, s_n = (comm.shard(x, group) for x in (src.xyz, src.mask, src_n))
    s_f = comm.shard(src.feat(config.feat_nn), group) if use_feat else None
    if ring:
        t_xyz, t_mask, t_n = (comm.shard(x, group) for x in (tgt.xyz, tgt.mask, tgt_n))
        t_f = comm.shard(tgt.feat(config.feat_nn), group) if use_feat else None
    else:
        t_xyz, t_mask, t_n = tgt.xyz, tgt.mask, tgt_n
        t_f = tgt.feat(config.feat_nn) if use_feat else None

    if nn_method == "block":
        # a per-shard spatial sort of the local source (point order does not
        # matter to the psum'd normal equations) and tile-index NN
        builder = config.tile_builder()
        local_cap = s_xyz.shape[0]
        sq = config.resolve_q_tile(local_cap)
        s_idx = trim_index(builder(s_xyz, s_mask, tile_size=sq), local_cap)
        sorder = s_idx.order.long()
        svalid = sorder >= 0
        ssafe = torch.clamp(sorder, min=0)
        s_xyz = s_idx.tiles.reshape(-1, 3)
        s_mask = svalid
        s_n = torch.where(svalid[:, None], s_n[ssafe], 0.0)
        local_tq = s_xyz.shape[0] // sq
        qf = torch.where(svalid, s_f[ssafe], 0.0).reshape(local_tq, sq) if use_feat else None
        # the same trim on every shard (a shared local capacity), so the
        # ring's shifts keep one shape
        t_idx = trim_index(builder(t_xyz, t_mask, tile_size=config.block_tile), t_xyz.shape[0],
                           multiple=_SUPER_G)
        ft = tile_payload(t_idx, t_f[:, None])[..., 0] if use_feat else None
        if ring:
            pl_tiles = tile_payload(t_idx, torch.cat([t_xyz, t_n], dim=1))

            def nn_fn(p):
                d2, pl = ring_block_nn(
                    p.reshape(local_tq, sq, 3), t_idx, pl_tiles, group,
                    k_tiles=config.block_k, query_feat=qf, feat_tiles=ft,
                    feat_weight=config.feat_nn_weight, score_prec=config.resolve_score_prec(),
                    payload_prec=config.resolve_payload_prec(), payload_xyz=3,
                )
                return pl[:, :3], pl[:, 3:], torch.sqrt(d2)
        else:

            def nn_fn(p):
                d2, idx = block_nn(
                    p.reshape(local_tq, sq, 3), t_idx, k_tiles=config.block_k,
                    query_feat=qf, feat_tiles=ft, feat_weight=config.feat_nn_weight,
                    score_prec=config.resolve_score_prec(),
                )
                idx = idx.long()
                return t_xyz[idx], t_n[idx], torch.sqrt(d2)
    elif ring:
        payload = torch.cat([t_xyz, t_n], dim=1)

        def nn_fn(p):
            d2, _, pl = ring_nearest_neighbor(p, t_xyz, t_mask, group, payload_shard=payload,
                                              tile_q=config.tile_q, tile_r=config.tile_r)
            return pl[:, :3], pl[:, 3:], torch.sqrt(d2)
    else:

        def nn_fn(p):
            d2, idx = nearest_neighbor(p, t_xyz, ref_mask=t_mask, tile_q=config.tile_q,
                                       tile_r=config.tile_r)
            idx = idx.long()
            return t_xyz[idx], t_n[idx], torch.sqrt(d2)

    res = _icp_scan(config, s_xyz, s_mask, s_n, init, nn_fn, reduce, aux_rot=aux_rot)
    return res.replace(transform=unshift @ res.transform @ shift)


def sharded_register_pairs(
    src_xyz: torch.Tensor,  # (B, N, 3)
    src_mask: torch.Tensor,  # (B, N)
    src_normals: torch.Tensor,  # (B, N, 3) or (B, N, 9)
    tgt_xyz: torch.Tensor,
    tgt_mask: torch.Tensor,
    tgt_normals: torch.Tensor,
    config: ICPConfig,
    mesh,
    *,
    pairs_axis: str = "pairs",
    points_axis: str = "points",
) -> ICPResult:
    """Data parallel over pairs x point sharding within each pair.

    Each rank takes its `pairs_axis` row's share of the batch and its
    `points_axis` shard of each of those pairs' source points; the target
    stays whole along `points_axis` (scan-to-scan shapes). Within a pair
    the step's statistics psum over `points_axis`; pairs on different rows
    never talk. Every rank returns the whole batch's (B,) result.

    The `*_normals` arguments are the per-point auxiliary channel: (B, N,
    3) normals for symmetric / p2plane, (B, N, 9) row-flattened
    covariances for objective="gicp" (`estimate_covariances` first)."""
    aux_w = src_normals.shape[2]
    if config.objective == "gicp":
        if aux_w != 9 or tgt_normals.shape[2] != 9:
            raise ValueError(
                "gicp pairs need (B, N, 9) flattened covariances in the "
                f"aux channel, got widths {aux_w}/{tgt_normals.shape[2]}"
            )
        aux_rot = gicp_cov_rot
    else:
        if aux_w != 3:
            raise ValueError(
                f"aux channel width {aux_w} != 3 (normals) for "
                f"objective={config.objective!r}"
            )
        aux_rot = None
    b, n = src_xyz.shape[0], src_xyz.shape[1]
    pgroup, group = mesh.get_group(pairs_axis), mesh.get_group(points_axis)
    dp, sp = comm.axis_size(pgroup), comm.axis_size(group)
    if b % dp or n % sp:
        raise ValueError(f"batch {b} / points {n} not divisible by mesh {tuple(mesh.shape)}")
    reduce = partial(comm.psum, group=group)
    per = b // dp
    first = comm.axis_index(pgroup) * per
    results = []
    for i in range(first, first + per):
        # per-pair target-centroid centring; the target is whole along the
        # points axis, so its masked centroid is the global one
        sx, tx, init_c, shift, unshift = _centre_pair(
            src_xyz[i], src_mask[i], tgt_xyz[i], tgt_mask[i],
            SE3.identity(device=src_xyz.device))
        tm, tn = tgt_mask[i], tgt_normals[i]

        def nn_fn(p, tx=tx, tm=tm, tn=tn):
            d2, idx = nearest_neighbor(p, tx, ref_mask=tm, tile_q=config.tile_q,
                                       tile_r=config.tile_r)
            idx = idx.long()
            return tx[idx], tn[idx], torch.sqrt(d2)

        res = _icp_scan(config, comm.shard(sx, group), comm.shard(src_mask[i], group),
                        comm.shard(src_normals[i], group), init_c, nn_fn, reduce,
                        aux_rot=aux_rot)
        results.append(res.replace(transform=unshift @ res.transform @ shift))
    local = _stack_results(results)
    if dp == 1:
        return local
    fields = (local.transform.R, local.transform.t, local.iters, local.converged,
              local.diff_history, local.rmse_history, local.final_rmse, local.inlier_count)
    R, t, iters, conv, dh, rh, fr, ic = comm.all_gather(fields, pgroup)
    return ICPResult(transform=SE3(R=R, t=t), iters=iters, converged=conv, diff_history=dh,
                     rmse_history=rh, final_rmse=fr, inlier_count=ic)

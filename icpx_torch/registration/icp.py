"""Iterate-to-convergence ICP on the brute-force and block NN paths.

Mirrors `icpx/registration/icp.py`: `ICPConfig` (every field, default and
validation, so a JAX config converts field for field), `ICPResult`,
`register`, `register_xyz`, the batched `register_batch` (brute NN) and
`register_batch_block` (block NN), the iteration core `_icp_scan`, and both
branches of `_register_jit`: brute-force NN (`_register_brute`) and block
NN (`_register_block`: KD tile indexes, in-registration normals, a coarse
phase, frozen candidates, the optional refine-stride mid phase and the
refine phase, with the optional feature-augmented metric), for every
objective of the reference: symmetric, point-to-plane, point-to-point and
GICP (whose per-point auxiliary channel is the flattened (N, 9) covariance
instead of the normal). The JAX `lax.while_loop` becomes a Python `while`
loop that reads the stop flag on the host once per iteration
(`profiling.fetch`); everything else stays on the clouds' device. The
block path runs every `payload_mode` ("gather", "infold", "select",
"vmem", "vmem7") and `block_fused` value of the reference. The batched
entry points run their pairs one after another through the single-pair
path and stack the results: each pair's result is what it would be alone,
as under the reference's `vmap`.

Spans (`profiling.span`, on only while a profiler records) name the entry
points (`icpx.register`, `icpx.register_batch` and its `icpx.pair`s), the
block path's KD builds and stages (`icpx.index`, `icpx.coarse`,
`icpx.freeze`, `icpx.mid`, `icpx.refine`), each phase's loop
(`icpx.loop`), each iteration (`icpx.iter`) and its parts (`icpx.nn`,
`icpx.weights`, `icpx.solve`, `icpx.stats`, `icpx.fetch`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from icpx_torch.cloud import PointCloud
from icpx_torch.distributed.fault import degenerate_solve_guard
from icpx_torch.geometry.se3 import SE3
from icpx_torch.kernels.blocknn import (
    _SUPER_G,
    _candidate_tiles,
    block_nn,
    block_nn_payload,
    block_radius_moments,
    build_kd_index,
    build_tile_index,
    coarsen_index,
    tile_payload,
    trim_index,
)
from icpx_torch.kernels.blocknn_cuda import (
    block_fold7_pre,
    block_fold_fused_pre,
    block_nn_fused4,
    block_radius_moments_fused6,
    fold6_prepare,
    fold7_prepare,
    payload_select_fused,
)
from icpx_torch.kernels.eigh3 import smallest_eigenvector_3x3, smallest_eigenvector_3x3_soa
from icpx_torch.kernels.knn import nearest_neighbor
from icpx_torch.kernels.normals import estimate_covariances, estimate_normals
from icpx_torch.kernels.voxel import auto_cell_size
from icpx_torch.registration.step import (
    correspondence_weights,
    estimate_increment,
    identity_reduce,
    step_stats,
)
from icpx_torch.utils import profiling

OBJECTIVES = ("symmetric", "p2plane", "p2p", "gicp")


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Static hyperparameters; the same fields, defaults and validation as
    `icpx.registration.icp.ICPConfig` (see its comments for each knob).

    The "auto" resolutions follow the device instead of the JAX backend,
    and none reuses a size threshold that was measured on the TPU:
    `payload_mode` resolves to "vmem" (the fold kernel) on a CUDA device,
    which engages only with a frozen candidate list
    (`_effective_payload_mode`), and `moments_mode` to "vmem" (the moments
    kernel), at every size; on the CPU both resolve as the JAX package does
    off the TPU ("gather", or "infold" from `payload_infold_threshold`,
    and "xla"). An explicit "gather" or "xla" runs the plain torch path on
    any device. `score_precision="auto"` resolves to "highest" (fp32, TF32
    off) everywhere until a measurement on the card says otherwise."""

    objective: str = "symmetric"
    max_iters: int = 10
    diff_threshold: float = 1.0
    rmse_change_tol: float = 0.0
    transform_tol: float = 0.0
    k_normals: int = 10
    max_corr_dist: float = float("inf")
    robust: str = "none"  # none|huber|tukey|welsch|cauchy
    robust_scale: float = 0.0  # <= 0 -> auto via MAD each iteration
    trim_fraction: float = 1.0
    damping: float = 1e-6
    degeneracy_clamp: float = 0.0
    nn_method: str = "auto"  # brute | block | auto (block from block_auto_threshold)
    block_tile: int = 128
    block_q_tile: int = 64
    block_q_tile_large: int = 128
    block_k: int = 8
    block_k_refine: int = 6
    coarse_iters: int = 2
    coarse_stride: int = 4
    feat_nn: str = ""
    feat_nn_weight: float = 0.0
    freeze_refine_candidates: bool = True
    refine_stride: int = 0
    refine_full_iters: int = 2
    refine_stride_threshold: int = 2 * 1024 * 1024
    score_precision: str = "auto"
    payload_mode: str = "auto"
    payload_infold_threshold: int = 2 * 1024 * 1024
    vmem_threshold: int = 1024 * 1024
    payload_prec: str = "auto"
    moments_mode: str = "auto"
    block_auto_threshold: int = 8192
    tile_index: str = "kd"
    src_tile_index: str = ""
    block_fused: str = "auto"
    block_group: int = 4
    vmem_group: int = 8
    block_u_max: int = 32
    tile_q: int = 2048
    tile_r: int = 4096

    def __post_init__(self):
        if self.objective not in OBJECTIVES:
            raise ValueError(f"objective must be one of {OBJECTIVES}")
        if self.nn_method not in ("auto", "brute", "block"):
            raise ValueError("nn_method must be auto|brute|block")
        if self.tile_index not in ("kd", "morton"):
            raise ValueError("tile_index must be kd|morton")
        if self.src_tile_index not in ("", "kd", "morton"):
            raise ValueError("src_tile_index must be ''|kd|morton")
        if self.block_fused not in ("auto", "on", "off"):
            raise ValueError("block_fused must be auto|on|off")
        if self.payload_mode not in (
            "auto", "gather", "infold", "select", "vmem", "vmem7"
        ):
            raise ValueError(
                "payload_mode must be auto|gather|infold|select|vmem|vmem7"
            )
        if self.moments_mode not in ("auto", "xla", "vmem"):
            raise ValueError("moments_mode must be auto|xla|vmem")
        if self.payload_prec not in ("auto", "high", "bf16"):
            raise ValueError("payload_prec must be auto|high|bf16")
        if self.score_precision not in ("auto", "highest", "high", "bf16"):
            raise ValueError("score_precision must be auto|highest|high|bf16")
        if self.refine_stride < 0:
            raise ValueError("refine_stride must be >= 0 (0 = auto)")
        if self.refine_full_iters < 1:
            raise ValueError("refine_full_iters must be >= 1")
        if bool(self.feat_nn) != (self.feat_nn_weight > 0):
            raise ValueError(
                "feature matching needs BOTH feat_nn (channel name) and "
                "feat_nn_weight > 0 — setting one without the other is "
                "almost certainly a mistake"
            )

    def resolve_nn(self, tgt_capacity: int) -> str:
        if self.nn_method != "auto":
            return self.nn_method
        return "block" if tgt_capacity >= self.block_auto_threshold else "brute"

    def tile_builder(self, kind: str = ""):
        return build_kd_index if (kind or self.tile_index) == "kd" else build_tile_index

    def resolve_fused(self) -> bool:
        # "auto" is off, as `use_fused_default()` is in the reference
        return self.block_fused == "on"

    def resolve_score_prec(self) -> str:
        return "highest" if self.score_precision == "auto" else self.score_precision

    def resolve_q_tile(self, capacity: int) -> int:
        if self.block_q_tile_large > 0 and capacity >= self.payload_infold_threshold:
            return self.block_q_tile_large
        return self.block_q_tile

    def resolve_payload(self, tgt_capacity: int, device) -> str:
        if self.payload_mode != "auto":
            return self.payload_mode
        if torch.device(device).type == "cuda":
            return "vmem"
        return "infold" if tgt_capacity >= self.payload_infold_threshold else "gather"

    def resolve_refine_stride(self, src_capacity: int, tgt_capacity: int) -> int:
        # auto = 1 (no mid phase) at every size, as in the reference
        return self.refine_stride if self.refine_stride else 1

    def resolve_moments(self, capacity: int, device) -> str:
        if self.moments_mode != "auto":
            return self.moments_mode
        return "vmem" if torch.device(device).type == "cuda" else "xla"

    def resolve_payload_prec(self) -> str:
        # "auto" = "high" (exact fp32 payload values), as in the reference
        return "high" if self.payload_prec == "auto" else self.payload_prec


@dataclasses.dataclass(frozen=True)
class ICPResult:
    """A registration's result. The batched entry points return one with a
    leading (B,) dimension on every field: `iters` a (B,) int32 tensor,
    the histories (B, max_iters), the transform a (B,) SE3."""

    transform: SE3  # accumulated src -> tgt
    iters: int  # number of iterations applied
    converged: torch.Tensor  # 0-d bool
    diff_history: torch.Tensor  # (max_iters,) evalDiff sums, NaN past `iters`
    rmse_history: torch.Tensor  # (max_iters,) inlier RMSE, NaN past `iters`
    final_rmse: torch.Tensor
    inlier_count: torch.Tensor  # 0-d int32

    def replace(self, **changes) -> "ICPResult":
        return dataclasses.replace(self, **changes)


def result_struct() -> ICPResult:
    """Shape-only ICPResult skeleton, every field 0, as in the reference."""
    return ICPResult(transform=SE3(R=0, t=0), iters=0, converged=0, diff_history=0,
                     rmse_history=0, final_rmse=0, inlier_count=0)


def _effective_payload_mode(config: ICPConfig, tgt_capacity: int, device, *,
                            use_feat: bool, fused: bool, will_freeze: bool) -> str:
    """The payload-delivery mode a block registration actually runs: the
    fold kernel ("vmem") needs a frozen candidate list and the 3D metric;
    without them it falls back, as in the reference, to "infold" from
    `payload_infold_threshold` target points and to "gather" below."""
    pmode = config.resolve_payload(tgt_capacity, device)
    if pmode in ("vmem", "vmem7") and (use_feat or fused or not will_freeze):
        pmode = "infold" if tgt_capacity >= config.payload_infold_threshold else "gather"
    return pmode


def register(
    src: PointCloud,
    tgt: PointCloud,
    config: ICPConfig = ICPConfig(),
    init: Optional[SE3] = None,
    *,
    src_weight: Optional[torch.Tensor] = None,
) -> ICPResult:
    """Register src onto tgt (returns transform with tgt ~= T(src)).

    Runs on the clouds' device. Estimates normals (k = config.k_normals)
    for either cloud that lacks them when the objective needs them, and
    for GICP covariances (k = max(k_normals, 15)) for either cloud that
    lacks them. Both clouds are first shifted by the target centroid and
    the shift is composed back into the returned transform; normals are
    estimated in that centred frame, so their orientation viewpoint is the
    target centroid, as in the JAX package.
    """
    with profiling.span("icpx.register"):
        dev = tgt.device
        if (config.feat_nn and config.feat_nn_weight > 0
                and config.resolve_nn(tgt.capacity) != "block"):
            raise ValueError(
                "feature-augmented matching (feat_nn) needs the block NN "
                "path; set nn_method='block'"
            )
        if init is None:
            init = SE3.identity(device=dev)

        # Centring first: normal estimation and NN scoring lose precision at
        # large coordinate magnitudes. Solve in target-centroid coordinates.
        center = tgt.centroid()
        eye = torch.eye(3, dtype=torch.float32, device=dev)
        shift, unshift = SE3(R=eye, t=-center), SE3(R=eye, t=center)
        src = src.with_xyz(src.xyz - center[None, :])
        tgt = tgt.with_xyz(tgt.xyz - center[None, :])
        init_c = shift @ init @ unshift

        needs_normals = config.objective in ("symmetric", "p2plane")
        block = config.resolve_nn(tgt.capacity) == "block"
        normals_for = []  # the block path estimates these off its own indexes
        if needs_normals and config.objective == "symmetric" and src.normals is None:
            if block:
                normals_for.append("src")
            else:
                src = estimate_normals(src, k=config.k_normals)
        if needs_normals and tgt.normals is None:
            if block:
                normals_for.append("tgt")
            else:
                tgt = estimate_normals(tgt, k=config.k_normals)
        if config.objective == "gicp":
            k_cov = max(config.k_normals, 15)
            if src.covs is None:
                src = estimate_covariances(src, k=k_cov)
            if tgt.covs is None:
                tgt = estimate_covariances(tgt, k=k_cov)

        if block:
            res = _register_block(src, tgt, init_c, config, tuple(normals_for), src_w=src_weight)
        else:
            res = _register_brute(src, tgt, init_c, config, src_w=src_weight)
        return res.replace(transform=unshift @ res.transform @ shift)


def gicp_cov_rot(T: SE3, aux: torch.Tensor) -> torch.Tensor:
    """Rotate flattened (N, 9) GICP covariances into T's frame: R C R^T."""
    C = aux.reshape(-1, 3, 3)
    return torch.einsum("ij,njk,lk->nil", T.R, C, T.R).reshape(-1, 9)


def _aux(cloud: PointCloud, config: ICPConfig) -> torch.Tensor:
    """A cloud's per-point auxiliary channel: the flattened (N, 9)
    covariances for GICP, else the normals (zeros where there are none)."""
    if config.objective == "gicp":
        if cloud.covs is None:
            raise ValueError("gicp needs covariances (estimate_covariances first)")
        return cloud.covs.reshape(cloud.capacity, 9)
    return cloud.normals if cloud.normals is not None else torch.zeros_like(cloud.xyz)


def _aux_rot(config: ICPConfig):
    return gicp_cov_rot if config.objective == "gicp" else None


def _register_brute(
    src: PointCloud,
    tgt: PointCloud,
    init: SE3,
    config: ICPConfig,
    src_w: Optional[torch.Tensor] = None,
) -> ICPResult:
    """The brute-force branch of the reference's `_register_jit`."""
    src_n, tgt_n = _aux(src, config), _aux(tgt, config)

    def nn_fn(p):
        d2, idx = nearest_neighbor(
            p, tgt.xyz, ref_mask=tgt.mask, tile_q=config.tile_q, tile_r=config.tile_r
        )
        return (
            tgt.xyz.index_select(0, idx),
            tgt_n.index_select(0, idx),
            torch.sqrt(d2),
        )

    return _icp_scan(config, src.xyz, src.mask, src_n, init, nn_fn, aux_rot=_aux_rot(config),
                     src_w=src_w)


def _index_normals(index, k_normals: int, k_tiles: int = 4, prec: str = "highest",
                   mode: str = "xla") -> torch.Tensor:
    """PCA normals for an index's own tiles from self-query radius moments,
    (N, 3) in sorted tile order: one KD build serves NN search and normal
    estimation. `mode="vmem"` runs the moments kernel and the SoA
    eigensolver; `"xla"` the plain `block_radius_moments`. Normals face the
    centred frame's origin; rows with fewer than 3 neighbours, and pad
    rows, get 0."""
    with profiling.span("icpx.normals"):
        flat = index.tiles.reshape(-1, 3)
        valid = index.order >= 0
        radius = auto_cell_size(flat, valid, scale=3.0 * math.sqrt(max(k_normals, 1) / 10.0))
        if mode == "vmem":
            cnt, _, comps = block_radius_moments_fused6(index.tiles, index, radius, k_tiles=k_tiles)
            (vx, vy, vz), _ = smallest_eigenvector_3x3_soa(*comps)
            flip = (vx * flat[:, 0] + vy * flat[:, 1] + vz * flat[:, 2]) > 0.0
            normal = torch.stack([vx, vy, vz], dim=1) * torch.where(flip, -1.0, 1.0)[:, None]
        else:
            cnt, _, cov = block_radius_moments(index.tiles, index, radius, k_tiles=k_tiles,
                                               prec=prec)
            normal, _ = smallest_eigenvector_3x3(cov)
            flip = (normal * (-flat)).sum(-1) < 0.0
            normal = torch.where(flip[:, None], -normal, normal)
        ok = (cnt >= 3.0) & valid
        return torch.where(ok[:, None], normal, 0.0)


def _register_block(
    src: PointCloud,
    tgt: PointCloud,
    init: SE3,
    config: ICPConfig,
    normals_for: tuple = (),
    src_w: Optional[torch.Tensor] = None,
) -> ICPResult:
    """The block-NN branch of the reference's `_register_jit`.

    Both clouds are tiled by KD indexes (source tiles of Sq rows, target
    tiles of S). Normals named in `normals_for` come from each index's own
    radius moments. A coarse phase of `coarse_iters` runs on every
    `coarse_stride`-th row of merged parent tiles; the refine phase's
    candidate tiles are then ranked once at the coarse pose and frozen,
    and each refine iteration's NN runs a fold kernel ("vmem": fold6,
    "vmem7": fold7), the plain `block_nn` plus the select kernel
    ("select") or a row gather of the fused `[xyz || normal]` table
    ("gather"), or the plain in-fold payload selection ("infold") in both
    phases. `block_fused="on"` freezes nothing and runs the fused4 kernel
    in both phases. The payload rows are `[xyz || aux]`: 6 wide with
    normals, 12 with GICP covariances.

    With `refine_stride` > 1 a mid phase runs first on every
    `refine_stride`-th row of each query tile (the same tiles and frozen
    candidates, `max_iters - refine_full_iters` iterations), then the full
    resolution tail for `refine_full_iters`. With `feat_nn` the NN runs in
    the feature-augmented metric: the plain fold (or in-fold selection) in
    every phase, as in the reference, no fold kernel and no fused4.

    `iters` counts every phase's iterations; `diff_history` and
    `rmse_history` hold the mid phase's and then the refine phase's.
    """
    dev = tgt.device
    q_tile = config.resolve_q_tile(src.capacity)
    with profiling.span("icpx.index"):
        src_idx = trim_index(
            config.tile_builder(config.src_tile_index)(src.xyz, src.mask, tile_size=q_tile),
            src.capacity,
            multiple=4,  # the coarse phase needs tq % 4 == 0
        )
    order = src_idx.order.long()
    valid = order >= 0
    safe = torch.clamp(order, min=0)
    src_xyz = src_idx.tiles.reshape(-1, 3)  # sorted, sentinel-filled
    src_mask = valid
    if src_w is not None:
        src_w = torch.where(valid, src_w[safe], 0.0)
    use_feat = bool(config.feat_nn) and config.feat_nn_weight > 0
    # the source's feature column in tile order, 0 on pad rows
    src_f = torch.where(valid, src.feat(config.feat_nn)[safe], 0.0) if use_feat else None
    with profiling.span("icpx.index"):
        tgt_index = trim_index(
            config.tile_builder()(tgt.xyz, tgt.mask, tile_size=config.block_tile),
            tgt.capacity,
            multiple=_SUPER_G,  # hierarchical ranking needs T % 64 == 0
        )
    tgt_f_tiles = (tile_payload(tgt_index, tgt.feat(config.feat_nn)[:, None])[..., 0]
                   if use_feat else None)

    if "src" in normals_for:
        # self-query at parent tiles: coarsen the fine source tiling to the
        # target's tile size (same flat point order)
        s_idx = src_idx
        f = config.block_tile // q_tile
        if f > 1 and s_idx.n_tiles % f == 0:
            s_idx = coarsen_index(s_idx, f)
        src_n_s = _index_normals(s_idx, config.k_normals, k_tiles=2,
                                 mode=config.resolve_moments(src.capacity, dev))
    else:
        src_n_s = torch.where(valid[:, None], _aux(src, config)[safe], 0.0)
    if "tgt" in normals_for:
        tgt_n_sorted = _index_normals(tgt_index, config.k_normals, k_tiles=2,
                                      mode=config.resolve_moments(tgt.capacity, dev))
    else:
        tgt_aux = _aux(tgt, config)
        tgt_n_sorted = tile_payload(tgt_index, tgt_aux).reshape(-1, tgt_aux.shape[1])
    # one fused (N, 3 + D) payload table in sorted tile order: one row gather
    # (or one kernel read) per iteration delivers coordinates and normals
    # (or covariances)
    tgt_pl = torch.cat([tgt_index.tiles.reshape(-1, 3), tgt_n_sorted], dim=1)

    sq = q_tile
    tq = src_xyz.shape[0] // sq
    coarse = (
        config.coarse_iters > 0
        and config.coarse_stride > 1
        and tq % 4 == 0
        and tq >= 8
        and (4 * sq) % config.coarse_stride == 0
    )
    fused = config.resolve_fused() and not use_feat
    group = config.block_group if tq % config.block_group == 0 else 1
    # the fused fold ranks its own candidates every iteration: nothing freezes
    will_freeze = coarse and not fused and config.freeze_refine_candidates
    pmode = _effective_payload_mode(config, tgt.capacity, dev, use_feat=use_feat, fused=fused,
                                    will_freeze=will_freeze)
    infold = not fused and pmode == "infold"
    select = not fused and pmode == "select"
    vmem_fold = not fused and not use_feat and pmode in ("vmem", "vmem7")
    score_prec = config.resolve_score_prec()
    tgt_pl_tiles = tgt_pl.reshape(tgt_index.n_tiles, tgt_index.tile_size, tgt_pl.shape[1])

    def make_nn(n_tiles, tile_rows, k_tiles, cand=None, qcent=None, qfeat=None):
        # "vmem"/"vmem7" and "select" engage on frozen-candidate phases;
        # elsewhere they fall back to the row gather, as in the reference
        if vmem_fold and cand is not None:
            if pmode == "vmem7" and qcent is not None:
                ops7 = fold7_prepare(cand, qcent, tgt_index, tgt_pl)  # once per phase

                def nn_fn_vmem7(p):
                    d2, pl = block_fold7_pre(p.reshape(n_tiles, tile_rows, 3), ops7)
                    return pl[:, :3], pl[:, 3:], torch.sqrt(d2)

                return nn_fn_vmem7
            ops = fold6_prepare(cand, tgt_index, tgt_pl)  # once per phase

            def nn_fn_vmem(p):
                d2, pl = block_fold_fused_pre(p.reshape(n_tiles, tile_rows, 3), ops)
                return pl[:, :3], pl[:, 3:], torch.sqrt(d2)

            return nn_fn_vmem

        # the frozen candidates as the select kernel takes them, once a phase
        cand32 = cand.to(torch.int32).contiguous() if select and cand is not None else None
        qf = None if qfeat is None else qfeat.reshape(n_tiles, tile_rows)
        feat = dict(query_feat=qf, feat_tiles=None if qf is None else tgt_f_tiles,
                    feat_weight=config.feat_nn_weight)

        def nn_fn(p):
            ptiles = p.reshape(n_tiles, tile_rows, 3)
            if fused:
                d2, pos = block_nn_fused4(ptiles, tgt_index, k_tiles=k_tiles, group=group,
                                          u_max=config.block_u_max, return_pos=True)
            elif infold:
                d2, pl = block_nn_payload(ptiles, tgt_index, tgt_pl_tiles, k_tiles=k_tiles,
                                          cand_tiles=cand, score_prec=score_prec,
                                          payload_prec=config.resolve_payload_prec(),
                                          payload_xyz=3, **feat)
                # miss/pad rows: d2 = inf with a zero payload, zero weight downstream
                return pl[:, :3], pl[:, 3:], torch.sqrt(d2)
            else:
                d2, pos = block_nn(ptiles, tgt_index, k_tiles=k_tiles, return_pos=True,
                                   cand_tiles=cand, score_prec=score_prec, **feat)
                if select and cand is not None:
                    pl = payload_select_fused(pos.reshape(n_tiles, tile_rows), cand32, tgt_pl_tiles)
                    return pl[:, :3], pl[:, 3:], torch.sqrt(d2)
            # pad/miss rows: d2 = inf and finite PAD_COORD rows, zero weight downstream
            pl = tgt_pl[pos.long()]
            return pl[:, :3], pl[:, 3:], torch.sqrt(d2)

        return nn_fn

    prev_rmse0 = None
    k_ref = config.block_k
    dn = src_n_s.shape[1]  # 3 (normals) or 9 (GICP covariances)
    aux_rot = _aux_rot(config)
    if coarse:
        # every stride-th row of 4 merged sibling tiles (the parent box)
        stride = config.coarse_stride

        def sub(x, d=None):
            rows = x.reshape((tq // 4, 4 * sq) + ((d,) if d else ()))[:, ::stride]
            return rows.reshape((-1, d) if d else (-1,))

        cfg_c = dataclasses.replace(config, max_iters=config.coarse_iters, diff_threshold=0.0)
        with profiling.span("icpx.coarse"):
            res_c = _icp_scan(
                cfg_c, sub(src_xyz, 3), sub(src_mask), sub(src_n_s, dn), init,
                make_nn(tq // 4, 4 * sq // stride, config.block_k,
                        qfeat=None if src_f is None else sub(src_f)),
                aux_rot=aux_rot, src_w=None if src_w is None else sub(src_w),
            )
        init = res_c.transform
        k_ref = config.block_k_refine if config.block_k_refine > 0 else config.block_k
        prev_rmse0 = res_c.final_rmse

    # the mid phase: every stride_r-th row of each query tile, against the
    # same tiles and frozen candidates, for all but the last
    # refine_full_iters iterations; its stop threshold scales with its rows
    stride_r = config.resolve_refine_stride(src.capacity, tgt.capacity)
    mid = (stride_r > 1 and sq % stride_r == 0 and sq // stride_r >= 8 and not fused
           and config.max_iters > config.refine_full_iters)

    def substride(x, d=None):
        rows = x.reshape((tq, sq) + ((d,) if d else ()))[:, ::stride_r]
        return rows.reshape((-1, d) if d else (-1,))

    def refine_nns():
        # the mid and refine phases' searches; the fold kernels prepare
        # their operands from the frozen candidates here, once a phase
        nn_m = (make_nn(tq, sq // stride_r, k_ref, cand=cand_ref, qcent=qcent_ref,
                        qfeat=None if src_f is None else substride(src_f)) if mid else None)
        return nn_m, make_nn(tq, sq, k_ref, cand=cand_ref, qcent=qcent_ref, qfeat=src_f)

    # freeze the refine candidates at the coarse-aligned pose: the residual
    # motion is well under a tile extent, so ranking once is enough
    cand_ref = qcent_ref = None
    if will_freeze:
        with profiling.span("icpx.freeze"):
            cand_ref, qcent_ref = _candidate_tiles(init.apply(src_xyz).reshape(tq, sq, 3),
                                                   tgt_index, k_ref)
            nn_mid, nn_ref = refine_nns()
    else:
        nn_mid, nn_ref = refine_nns()

    cfg_r = config
    if mid:
        cfg_m = dataclasses.replace(config, max_iters=config.max_iters - config.refine_full_iters,
                                    diff_threshold=config.diff_threshold / stride_r)
        with profiling.span("icpx.mid"):
            res_m = _icp_scan(
                cfg_m, substride(src_xyz, 3), substride(src_mask), substride(src_n_s, dn), init,
                nn_mid, aux_rot=aux_rot, prev_rmse0=prev_rmse0,
                src_w=None if src_w is None else substride(src_w),
            )
        init = res_m.transform
        prev_rmse0 = res_m.final_rmse
        cfg_r = dataclasses.replace(config, max_iters=config.refine_full_iters)

    with profiling.span("icpx.refine"):
        res = _icp_scan(cfg_r, src_xyz, src_mask, src_n_s, init, nn_ref, aux_rot=aux_rot,
                        prev_rmse0=prev_rmse0, src_w=src_w)
    if mid:
        # the mid phase's histories first, then the tail's, NaN past the
        # work done; a mid phase that met its stop counts as converged
        res = res.replace(
            iters=res.iters + res_m.iters,
            converged=res.converged | res_m.converged,
            diff_history=_merge_history(res_m.diff_history, res.diff_history, res_m.iters,
                                        res.iters, config.max_iters),
            rmse_history=_merge_history(res_m.rmse_history, res.rmse_history, res_m.iters,
                                        res.iters, config.max_iters),
        )
    if coarse:
        res = res.replace(iters=res.iters + res_c.iters)
    return res


def _merge_history(mid_h: torch.Tensor, tail_h: torch.Tensor, mid_iters: int, tail_iters: int,
                   total: int) -> torch.Tensor:
    """A (total,) history: the mid phase's first `mid_iters` entries, the
    tail's first `tail_iters` after them, NaN past the work done."""
    out = torch.full((total,), float("nan"), dtype=mid_h.dtype, device=mid_h.device)
    out[:mid_iters] = mid_h[:mid_iters]
    out[mid_iters:mid_iters + tail_iters] = tail_h[:tail_iters]
    return out


def _icp_scan(
    config: ICPConfig,
    src_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    src_n: torch.Tensor,
    init: SE3,
    nn_fn,
    reduce=identity_reduce,
    aux_rot=None,
    prev_rmse0: Optional[torch.Tensor] = None,
    src_w: Optional[torch.Tensor] = None,
) -> ICPResult:
    """The ICP iteration core shared by every execution mode.

    `nn_fn(p) -> (q, n_q, dist)` gives matched target rows for the
    transformed source; `src_n` / `n_q` are the objective's auxiliary
    channel (normals (N, 3), or flattened covariances (N, 9) for GICP), and
    `aux_rot(T, aux)` moves the source's into the current frame (default:
    vector rotation). Loop bookkeeping follows the reference exactly:
    histories are NaN-filled to max_iters; a rejected step records
    diff = inf and keeps the previous rmse; the loop stops on rejection,
    on diff < diff_threshold, and on the optional rmse_change_tol and
    transform_tol tests; converged = stop and no step was rejected.
    `prev_rmse0` seeds the previous RMSE (the coarse phase's final one), so
    an already converged refine phase can stop after one iteration.
    `reduce` sums the step's statistics across a points partition
    (`identity_reduce` on one device, which changes nothing; `comm.psum`
    over the points group when sharded). Sharded, the stop flag is reduced
    too (any rank stopping stops all), so every rank leaves the loop on
    the same iteration, as the reference's reduced `while_loop` predicate.
    """
    dev = src_xyz.device
    f32 = dict(dtype=torch.float32, device=dev)
    inf = torch.tensor(float("inf"), **f32)
    diffs = torch.full((config.max_iters,), float("nan"), **f32)
    rmses = torch.full((config.max_iters,), float("nan"), **f32)
    counts = torch.zeros((config.max_iters,), **f32)
    transform = init
    prev_rmse = inf if prev_rmse0 is None else prev_rmse0
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    stop_t = torch.zeros((), dtype=torch.bool, device=dev)
    it, stop = 0, False
    if aux_rot is None:
        aux_rot = lambda T, aux: T.rotate(aux)  # noqa: E731

    with profiling.span("icpx.loop"):
        while it < config.max_iters and not stop:
            with profiling.span("icpx.iter"):
                p = transform.apply(src_xyz)
                n_p = aux_rot(transform, src_n)
                with profiling.span("icpx.nn"):
                    q, n_q, dist = nn_fn(p)

                with profiling.span("icpx.weights"):
                    w = correspondence_weights(config, p, n_p, q, n_q, dist, src_mask, reduce)
                    if src_w is not None:
                        w = w * src_w
                with profiling.span("icpx.solve"):
                    incre = estimate_increment(config, p, q, n_p, n_q, w, reduce)
                    new_transform = incre @ transform

                with profiling.span("icpx.stats"):
                    # post-update diagnostics against the same correspondences
                    stats = step_stats(config, new_transform.apply(src_xyz), q, dist, src_mask,
                                       reduce)
                    # a non-finite or correspondence-starved update is rejected: the
                    # previous transform is kept, and the loop stops and reports failure
                    new_transform, ok = degenerate_solve_guard(new_transform, stats, transform)
                    diff = torch.where(ok, stats.diff, inf)
                    rmse = torch.where(ok, stats.rmse, prev_rmse)

                    now_stop = (~ok) | (diff < config.diff_threshold)
                    if config.rmse_change_tol > 0:
                        now_stop = now_stop | ((prev_rmse - rmse).abs() < config.rmse_change_tol)
                    if config.transform_tol > 0:
                        tr = torch.diagonal(incre.R).sum()
                        cos_a = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
                        inc_mag = torch.arccos(cos_a) + torch.linalg.vector_norm(incre.t)
                        now_stop = now_stop | (inc_mag < config.transform_tol)

                    diffs[it] = diff
                    rmses[it] = rmse
                    counts[it] = stats.inlier_count
                    failed = failed | ~ok
                    if reduce is not identity_reduce:
                        now_stop = reduce(now_stop.to(torch.float32)) > 0
                transform, prev_rmse, stop_t = new_transform, rmse, now_stop
                it += 1
                stop = profiling.fetch(stop_t)  # the stop flag, read once an iteration

    last = counts[max(it - 1, 0)] if config.max_iters else torch.zeros((), **f32)
    return ICPResult(
        transform=transform,
        iters=it,
        converged=stop_t & ~failed,
        diff_history=diffs,
        rmse_history=rmses,
        final_rmse=prev_rmse,
        inlier_count=last.to(torch.int32),
    )


def _centre_pair(sx, sm, tx, tm, init: SE3):
    """A pair shifted by its target's masked centroid (valid rows only),
    the initial guess in that frame, and the shift back: (sx, tx, init_c,
    shift, unshift), as the reference's batched entry points do it."""
    denom = torch.clamp(tm.sum(), min=1).to(torch.float32)
    center = torch.where(tm[:, None], tx, 0.0).sum(0) / denom
    sx = torch.where(sm[:, None], sx - center[None, :], sx)
    tx = torch.where(tm[:, None], tx - center[None, :], tx)
    eye = torch.eye(3, dtype=torch.float32, device=tx.device)
    shift, unshift = SE3(R=eye, t=-center), SE3(R=eye, t=center)
    return sx, tx, shift @ init @ unshift, shift, unshift


def _stack_results(results) -> ICPResult:
    """B single-pair results as one batched ICPResult: (B,) tensors for
    iters, converged, final_rmse and inlier_count, (B, max_iters)
    histories and a (B,) SE3."""
    dev = results[0].final_rmse.device
    stack = lambda f: torch.stack([getattr(r, f) for r in results])  # noqa: E731
    return ICPResult(
        transform=SE3(R=torch.stack([r.transform.R for r in results]),
                      t=torch.stack([r.transform.t for r in results])),
        iters=torch.tensor([r.iters for r in results], dtype=torch.int32, device=dev),
        converged=stack("converged"),
        diff_history=stack("diff_history"),
        rmse_history=stack("rmse_history"),
        final_rmse=stack("final_rmse"),
        inlier_count=stack("inlier_count"),
    )


def register_batch(
    src_xyz: torch.Tensor,  # (B, N, 3)
    src_mask: torch.Tensor,  # (B, N)
    src_normals: torch.Tensor,  # (B, N, 3)
    tgt_xyz: torch.Tensor,
    tgt_mask: torch.Tensor,
    tgt_normals: torch.Tensor,
    config: ICPConfig = ICPConfig(),
    init: Optional[SE3] = None,  # batched (B,) initial guesses
) -> ICPResult:
    """Register B independent pairs on the brute-force path; normals must
    be given. Each pair is solved in its target-centroid frame (valid rows
    shifted) through `nearest_neighbor` (the `nn` kernel on the card), with
    the shift composed back, as the reference's vmapped version does. The
    pairs run one after another and their results are stacked into one
    batched ICPResult; each equals the pair's result run alone."""
    b = src_xyz.shape[0]
    if init is None:
        init = SE3.identity((b,), device=tgt_xyz.device)
    results = []
    with profiling.span("icpx.register_batch"):
        for i in range(b):
            with profiling.span("icpx.pair"):
                tm, tn = tgt_mask[i], tgt_normals[i]
                sx, tx, init_c, shift, unshift = _centre_pair(
                    src_xyz[i], src_mask[i], tgt_xyz[i], tm, SE3(R=init.R[i], t=init.t[i]))

                def nn_fn(p, tx=tx, tm=tm, tn=tn):
                    d2, idx = nearest_neighbor(p, tx, ref_mask=tm, tile_q=config.tile_q,
                                               tile_r=config.tile_r)
                    return tx.index_select(0, idx), tn.index_select(0, idx), torch.sqrt(d2)

                res = _icp_scan(config, sx, src_mask[i], src_normals[i], init_c, nn_fn)
                results.append(res.replace(transform=unshift @ res.transform @ shift))
        return _stack_results(results)


def register_batch_block(
    src_xyz: torch.Tensor,  # (B, N, 3)
    src_mask: torch.Tensor,  # (B, N)
    tgt_xyz: torch.Tensor,  # (B, N, 3)
    tgt_mask: torch.Tensor,  # (B, N)
    config: ICPConfig = ICPConfig(),
    init: Optional[SE3] = None,  # batched (B,) initial guesses
) -> ICPResult:
    """Register B independent pairs through the full block-NN pipeline
    (per-pair KD indexes, normals estimated off them, coarse and refine
    phases). Each pair is solved in its target-centroid frame, as in
    `register_batch`; the pairs run one after another through
    `_register_block` with both clouds' normals estimated, and their
    results are stacked."""
    b = src_xyz.shape[0]
    if config.resolve_nn(tgt_xyz.shape[1]) != "block":
        raise ValueError(
            "register_batch_block needs the block NN path (clouds above "
            "block_auto_threshold or nn_method='block'); use "
            "register_batch for brute-NN scan-scale pairs"
        )
    if config.objective == "gicp":
        raise ValueError("gicp needs covariances (estimate_covariances first)")
    if init is None:
        init = SE3.identity((b,), device=tgt_xyz.device)
    results = []
    for i in range(b):
        sx, tx, init_c, shift, unshift = _centre_pair(
            src_xyz[i], src_mask[i], tgt_xyz[i], tgt_mask[i], SE3(R=init.R[i], t=init.t[i]))
        res = _register_block(PointCloud(xyz=sx, mask=src_mask[i]),
                              PointCloud(xyz=tx, mask=tgt_mask[i]), init_c, config,
                              normals_for=("src", "tgt"))
        results.append(res.replace(transform=unshift @ res.transform @ shift))
    return _stack_results(results)


def register_xyz(src_xyz, tgt_xyz, config: ICPConfig = ICPConfig(),
                 init: Optional[SE3] = None, *, device=None) -> ICPResult:
    """Register raw (N, 3) arrays (padding handled here); they land on
    `device` as `PointCloud.create` puts them."""
    return register(PointCloud.create(src_xyz, device=device),
                    PointCloud.create(tgt_xyz, device=device), config, init)


def format_trace(result: ICPResult) -> str:
    """Reference-style per-iteration trace (`myicp.cpp:125-126`)."""
    lines = []
    for i, d in enumerate(result.diff_history.cpu().numpy()):
        if np.isnan(d):
            break
        lines.append(f"iters#{i + 1} / diff: {d:.6g}")
    lines.append(
        f"converged={bool(result.converged)} iters={int(result.iters)} "
        f"rmse={float(result.final_rmse):.6g}"
    )
    return "\n".join(lines)

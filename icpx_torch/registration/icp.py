"""Iterate-to-convergence ICP on the brute-force NN path.

Mirrors `icpx/registration/icp.py`: `ICPConfig` (every field, default and
validation, so a JAX config converts field for field), `ICPResult`,
`register`, the iteration core `_icp_scan`, and the brute branch of
`_register_jit`. The JAX `lax.while_loop` becomes a Python `while` loop
that syncs the stop flag to the host once per iteration; everything else
stays on the clouds' device. A configuration that resolves to block NN
(ROADMAP queue 1 step 5) or GICP (step 6) raises `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from icpx_torch.cloud import PointCloud
from icpx_torch.distributed.fault import degenerate_solve_guard
from icpx_torch.geometry.se3 import SE3
from icpx_torch.kernels.knn import nearest_neighbor
from icpx_torch.kernels.normals import estimate_normals
from icpx_torch.registration.step import (
    correspondence_weights,
    estimate_increment,
    step_stats,
)

OBJECTIVES = ("symmetric", "p2plane", "p2p", "gicp")


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Static hyperparameters; the same fields, defaults and validation as
    `icpx.registration.icp.ICPConfig` (see its comments for each knob).
    The block-NN fields are accepted and only matter once block NN is
    ported."""

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


@dataclasses.dataclass(frozen=True)
class ICPResult:
    transform: SE3  # accumulated src -> tgt
    iters: int  # number of iterations applied
    converged: torch.Tensor  # 0-d bool
    diff_history: torch.Tensor  # (max_iters,) evalDiff sums, NaN past `iters`
    rmse_history: torch.Tensor  # (max_iters,) inlier RMSE, NaN past `iters`
    final_rmse: torch.Tensor
    inlier_count: torch.Tensor  # 0-d int32

    def replace(self, **changes) -> "ICPResult":
        return dataclasses.replace(self, **changes)


def _check_supported(config: ICPConfig, tgt_capacity: int) -> None:
    if config.objective == "gicp":
        raise NotImplementedError("GICP is not ported yet (ROADMAP queue 1 step 6)")
    if config.resolve_nn(tgt_capacity) == "block":
        raise NotImplementedError(
            f"block NN (target capacity {tgt_capacity} >= block_auto_threshold "
            f"{config.block_auto_threshold}, or nn_method='block') is not ported "
            "yet (ROADMAP queue 1 step 5); pass nn_method='brute'"
        )


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
    for either cloud that lacks them when the objective needs them. Both
    clouds are first shifted by the target centroid and the shift is
    composed back into the returned transform; normals are estimated in
    that centred frame, so their orientation viewpoint is the target
    centroid, as in the JAX package.
    """
    _check_supported(config, tgt.capacity)
    if config.feat_nn and config.feat_nn_weight > 0:
        raise ValueError(
            "feature-augmented matching (feat_nn) needs the block NN "
            "path; set nn_method='block'"
        )
    dev = tgt.device
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
    if needs_normals and config.objective == "symmetric" and src.normals is None:
        src = estimate_normals(src, k=config.k_normals)
    if needs_normals and tgt.normals is None:
        tgt = estimate_normals(tgt, k=config.k_normals)

    res = _register_brute(src, tgt, init_c, config, src_w=src_weight)
    return res.replace(transform=unshift @ res.transform @ shift)


def _register_brute(
    src: PointCloud,
    tgt: PointCloud,
    init: SE3,
    config: ICPConfig,
    src_w: Optional[torch.Tensor] = None,
) -> ICPResult:
    """The brute-force branch of the reference's `_register_jit`."""
    src_n = src.normals if src.normals is not None else torch.zeros_like(src.xyz)
    tgt_n = tgt.normals if tgt.normals is not None else torch.zeros_like(tgt.xyz)

    def nn_fn(p):
        d2, idx = nearest_neighbor(
            p, tgt.xyz, ref_mask=tgt.mask, tile_q=config.tile_q, tile_r=config.tile_r
        )
        return (
            tgt.xyz.index_select(0, idx),
            tgt_n.index_select(0, idx),
            torch.sqrt(d2),
        )

    return _icp_scan(config, src.xyz, src.mask, src_n, init, nn_fn, src_w=src_w)


def _icp_scan(
    config: ICPConfig,
    src_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    src_n: torch.Tensor,
    init: SE3,
    nn_fn,
    src_w: Optional[torch.Tensor] = None,
) -> ICPResult:
    """The ICP iteration core.

    `nn_fn(p) -> (q, n_q, dist)` gives matched target rows for the
    transformed source. Loop bookkeeping follows the reference exactly:
    histories are NaN-filled to max_iters; a rejected step records
    diff = inf and keeps the previous rmse; the loop stops on rejection,
    on diff < diff_threshold, and on the optional rmse_change_tol and
    transform_tol tests; converged = stop and no step was rejected.
    """
    dev = src_xyz.device
    f32 = dict(dtype=torch.float32, device=dev)
    inf = torch.tensor(float("inf"), **f32)
    diffs = torch.full((config.max_iters,), float("nan"), **f32)
    rmses = torch.full((config.max_iters,), float("nan"), **f32)
    counts = torch.zeros((config.max_iters,), **f32)
    transform = init
    prev_rmse = inf
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    stop_t = torch.zeros((), dtype=torch.bool, device=dev)
    it, stop = 0, False

    while it < config.max_iters and not stop:
        p = transform.apply(src_xyz)
        n_p = transform.rotate(src_n)
        q, n_q, dist = nn_fn(p)

        w = correspondence_weights(config, p, n_p, q, n_q, dist, src_mask)
        if src_w is not None:
            w = w * src_w
        incre = estimate_increment(config, p, q, n_p, n_q, w)
        new_transform = incre @ transform

        # post-update diagnostics against the same correspondences
        stats = step_stats(config, new_transform.apply(src_xyz), q, dist, src_mask)
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
        transform, prev_rmse, stop_t = new_transform, rmse, now_stop
        it += 1
        stop = bool(stop_t)  # the loop's one host sync per iteration

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

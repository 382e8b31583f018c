"""Scan-to-keyframe (and scan-to-map) odometry frontend.

Mirrors `icpx/odometry/frontend.py`. Sequential scans register against the
current keyframe (or a voxel map) from a constant-velocity initial guess;
a motion gate dead-reckons implausible solutions; new keyframes spawn past
motion thresholds, their measured transforms becoming pose-graph edges; an
optional sliding-window back end refines keyframe poses as the run goes;
a run resumes bit-exactly from an `OdometryCheckpoint`. Each frame's
scalar fetches run under the stall watchdog (`guarded_call`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from icpx_torch.cloud import PointCloud
from icpx_torch.distributed.fault import default_stall_timeout, guarded_call
from icpx_torch.geometry.se3 import SE3
from icpx_torch.kernels.knn import nearest_neighbor
from icpx_torch.kernels.normals import estimate_normals
from icpx_torch.registration.icp import ICPConfig, ICPResult, register
from icpx_torch.registration.pyramid import PyramidConfig, register_pyramid
from icpx_torch.registration.step import _masked_quantile


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """The reference's fields and defaults (see its comments for each)."""

    icp: ICPConfig = ICPConfig(
        objective="symmetric",
        max_iters=12,
        diff_threshold=0.0,
        rmse_change_tol=1e-6,
        robust="huber",
    )
    pyramid_levels: int = 1  # 1 = single resolution
    pyramid_subsample: int = 4
    keyframe_trans: float = 0.5  # spawn a keyframe beyond this motion
    keyframe_rot: float = 0.15  # radians
    constant_velocity_init: bool = True
    # velocity model: a fixed twist-space EMA factor when < 1, else adaptive
    # (the blend grows with the innovation up to 1 at innovation_scale)
    velocity_damping: float = 1.0
    adaptive_velocity: bool = True
    innovation_scale: float = 0.5
    velocity_damping_min: float = 0.25
    mode: str = "scan_to_keyframe"  # or "scan_to_map" (a voxel map)
    map_capacity: int = 65536
    map_cell: float = 0.1
    # motion gate: a correction beyond these is rejected (<= 0 disables)
    max_correction_trans: float = 1.0
    max_correction_rot: float = 0.5
    # dynamic-object rejection before a frame becomes reference geometry
    # (residual > dynamic_sigma x median is masked; 0 disables)
    dynamic_sigma: float = 0.0
    dynamic_min_keep: float = 0.5
    backend: str = "none"  # or "sliding_window"
    window: int = 10
    # stall watchdog on each frame's fetches, seconds; 0 disables, -1 =
    # `default_stall_timeout` for the scans' device (off on the CPU)
    stall_timeout_s: float = -1.0


@dataclasses.dataclass
class MotionState:
    """Frontend motion-model state (checkpointed for exact resume)."""

    prev_rel: SE3  # kf_T_frame of the latest frame
    velocity: SE3  # smoothed inter-frame twist
    model_warm: bool
    consecutive_rejects: int


@dataclasses.dataclass
class OdometryResult:
    poses: List[SE3]  # world_T_frame per input frame
    is_keyframe: List[bool]
    rmse: List[float]
    edges: List[Tuple[int, int, SE3]]  # (frame_i, frame_j, i_T_j) between keyframes
    keyframe_indices: List[int]
    motion: Optional[MotionState] = None  # state after the last frame
    keyframe_masks: Optional[List] = None  # post-scrub masks (dynamic_sigma > 0)
    window: Optional[object] = None  # the live SlidingWindowBackend


def blend_velocity(
    velocity: SE3,
    vel_raw: SE3,
    *,
    damping: float = 1.0,
    adaptive: bool = True,
    innovation_scale: float = 0.5,
    damping_min: float = 0.25,
    rot_weight: float = 1.0,
) -> SE3:
    """Twist-space EMA of the constant-velocity model (shared by the host
    frontend and the whole-sequence path): b = damping when < 1; otherwise,
    when adaptive, b = clip(innovation / innovation_scale, damping_min, 1)
    with innovation = rot_weight ||delta_omega|| + ||delta_v|| of
    log(velocity^-1 vel_raw). No host sync."""
    if damping >= 1.0 and not adaptive:
        return vel_raw
    v_log = velocity.log()
    r_log = vel_raw.log()
    if damping < 1.0:
        b = torch.tensor(damping, dtype=torch.float32, device=v_log.device)
    else:
        delta = (velocity.inverse() @ vel_raw).log()
        innov = rot_weight * torch.linalg.vector_norm(delta[..., :3], dim=-1) \
            + torch.linalg.vector_norm(delta[..., 3:], dim=-1)
        b = torch.clamp(innov / innovation_scale, damping_min, 1.0)
    return SE3.exp((1.0 - b) * v_log + b * r_log)


def _mask_dynamic(frame: PointCloud, ref: PointCloud, rel: SE3, sigma: float,
                  min_keep: float) -> PointCloud:
    """Mask out points whose residual to the reference after registration
    is an outlier (residual > sigma x median); keep everything when that
    would drop more than (1 - min_keep) of the frame."""
    p = rel.apply(frame.xyz)
    d2, _ = nearest_neighbor(p, ref.xyz, ref_mask=ref.mask)
    dist = torch.sqrt(d2)
    valid = frame.mask
    med = _masked_quantile(dist, valid.to(torch.float32), 0.5)
    keep = dist <= sigma * torch.clamp(med, min=1e-6)
    frac = (keep & valid).sum() / torch.clamp(valid.sum(), min=1)
    keep = keep | (frac < min_keep)
    return frame.replace(mask=valid & keep)


def _register_pair(src: PointCloud, tgt: PointCloud, cfg: OdometryConfig, init: SE3) -> ICPResult:
    if cfg.pyramid_levels > 1:
        res, _ = register_pyramid(
            src, tgt,
            PyramidConfig(levels=cfg.pyramid_levels, subsample=cfg.pyramid_subsample,
                          base=cfg.icp),
            init=init,
        )
        return res
    return register(src, tgt, cfg.icp, init=init)


def run_odometry(
    frames: Sequence[PointCloud],
    config: OdometryConfig = OdometryConfig(),
    resume: Optional[object] = None,
) -> OdometryResult:
    """Sequential odometry over sensor-frame scans, on their device; poses
    with pose[0] = identity (world = the first frame).

    `resume` continues an earlier run exactly: pass the
    `OdometryCheckpoint` it saved together with the full frame sequence;
    frames up to the checkpoint's `frame_index` are skipped and the
    restored keyframe, motion and window state make the continuation equal
    the uninterrupted run."""
    if len(frames) == 0:
        return OdometryResult([], [], [], [], [])
    dev = frames[0].device

    frames = [f if f.normals is not None else estimate_normals(f, k=config.icp.k_normals)
              for f in frames]

    eye = SE3.identity(device=dev)
    poses: List[SE3] = [eye]
    is_kf = [True]
    rmses = [0.0]
    edges: List[Tuple[int, int, SE3]] = []
    kf_indices = [0]

    use_map = config.mode == "scan_to_map"
    if use_map:
        from icpx_torch.odometry.mapping import VoxelMap, insert_scan

        vmap = VoxelMap.create(config.map_capacity, config.map_cell,
                               feat_names=frames[0].feat_names, device=dev)
        vmap = insert_scan(vmap, frames[0], eye)

    win = None
    if config.backend == "sliding_window":
        from icpx_torch.odometry.posegraph import SlidingWindowBackend

        win = SlidingWindowBackend(window=config.window)
        win.add_keyframe(eye)
    elif config.backend != "none":
        raise ValueError(f"unknown backend {config.backend!r}")

    kf_cloud = frames[0]
    kf_pose = eye
    kf_index = 0
    prev_rel = eye  # kf_T_frame of the previous frame
    velocity = eye
    model_warm = False  # the motion model is untrusted until one accept
    consecutive_rejects = 0
    # the keyframe each frame's pose chained from (the window back end
    # re-anchors non-keyframe poses when it refines keyframes)
    anchors: List[int] = [0]
    kf_masks: Optional[List] = [frames[0].mask.cpu().numpy()] if config.dynamic_sigma > 0 else None
    start = 1

    if resume is not None:
        from icpx_torch.interop import se3_from_numpy  # interop imports this package

        ck = resume
        if ck.frame_index >= len(frames):
            raise ValueError(f"checkpoint frame_index {ck.frame_index} beyond the "
                             f"{len(frames)} provided frames")
        if ck.is_keyframe is None:
            raise ValueError("checkpoint lacks resumable state (is_keyframe); it was saved "
                             "by an older version or built by hand, so it cannot resume")
        poses = ck.poses(device=dev)
        is_kf = [bool(v) for v in ck.is_keyframe]
        rmses = [float(v) for v in (ck.rmse if ck.rmse is not None else [])]
        edges = [(int(i), int(j), se3_from_numpy(R, t, device=dev)) for (i, j, R, t) in ck.edges]
        # the saved run closed its final segment; drop that edge (it is
        # closed again at the new end)
        if edges and edges[-1][1] == ck.frame_index and ck.frame_index != ck.keyframe_index:
            edges.pop()
        kf_index = ck.keyframe_index
        kf_indices = [i for i, v in enumerate(is_kf) if v] or [0]
        anchors = [0]
        last_kf = 0
        for i in range(1, len(poses)):
            anchors.append(last_kf)
            if i < len(is_kf) and is_kf[i]:
                last_kf = i
        if config.dynamic_sigma > 0:
            if getattr(ck, "kf_masks", None) is None:
                raise ValueError("resume with dynamic_sigma > 0 needs the checkpoint's "
                                 "keyframe masks (saved by runs with scrubbing on); this "
                                 "checkpoint has none")
            kf_masks = []
            for i, fi in enumerate(kf_indices):
                m = torch.as_tensor(np.asarray(ck.kf_masks[i], bool), device=dev)
                frames[fi] = frames[fi].replace(mask=m)
                kf_masks.append(m.cpu().numpy())
        kf_cloud = frames[kf_index]
        kf_pose = poses[kf_index]
        if ck.motion_R is not None:
            prev_rel = se3_from_numpy(ck.motion_R[0], ck.motion_t[0], device=dev)
            velocity = se3_from_numpy(ck.motion_R[1], ck.motion_t[1], device=dev)
            model_warm = bool(ck.model_warm)
            consecutive_rejects = int(ck.consecutive_rejects)
        else:
            prev_rel = kf_pose.inverse() @ poses[ck.frame_index]
        if use_map:
            vmap = VoxelMap.create(config.map_capacity, config.map_cell,
                                   feat_names=frames[0].feat_names, device=dev)
            for i in kf_indices:
                vmap = insert_scan(vmap, frames[i], poses[i])
        if win is not None:
            win.poses = [poses[fi] for fi in kf_indices]
            if getattr(ck, "win_active0", None) is not None:
                # the window's exact state: surviving edges, active0 and the
                # marginal prior, restored as saved
                win.active0 = int(ck.win_active0)
                win.edges = [(i, j, se3_from_numpy(R, t, device=dev), w)
                             for (i, j, R, t, w) in (ck.win_edges or [])]
                if ck.win_prior_nodes is not None:
                    from icpx_torch.odometry.posegraph import MarginalPrior

                    win.prior = MarginalPrior(
                        nodes=torch.as_tensor(np.asarray(ck.win_prior_nodes), dtype=torch.int32,
                                              device=dev),
                        H=torch.as_tensor(np.asarray(ck.win_prior_H, np.float32), device=dev),
                        b=torch.as_tensor(np.asarray(ck.win_prior_b, np.float32), device=dev),
                        lin=se3_from_numpy(ck.win_prior_lin_R, ck.win_prior_lin_t, device=dev),
                    )
            else:
                # an older checkpoint without window state: rebuild from the
                # keyframes and edges and marginalize again (close, not exact)
                remap = {fr: i for i, fr in enumerate(kf_indices)}
                for (i, j, T) in edges:
                    if i in remap and j in remap:
                        win.add_edge(remap[i], remap[j], T)
                win.marginalize_to_window()
        start = ck.frame_index + 1

    stall_t = (default_stall_timeout(dev) if config.stall_timeout_s < 0
               else config.stall_timeout_s)

    for k in range(start, len(frames)):
        init = prev_rel @ velocity if config.constant_velocity_init else prev_rel
        if use_map:
            # the target is the world-frame map; the transform is world_T_frame
            res = _register_pair(frames[k], vmap.as_cloud(), config, kf_pose @ init)
            pose = res.transform
            rel = kf_pose.inverse() @ pose
        else:
            res = _register_pair(frames[k], kf_cloud, config, init)
            rel = res.transform  # kf_T_frame
            pose = kf_pose @ rel

        # the motion gate: dead-reckon instead of accepting a jump, once the
        # model is warm, and accept after 2 rejections in a row. These
        # fetches are the frame's device fences, under the watchdog.
        correction = init.inverse() @ rel
        corr_t = guarded_call(lambda c=correction: float(torch.linalg.vector_norm(c.t)), stall_t)
        corr_r, rel_t_np, res_rmse = guarded_call(
            lambda: (float(correction.rotation_angle()), rel.t.cpu().numpy(), float(res.final_rmse)),
            stall_t,
        )
        finite = np.isfinite(corr_t) and np.isfinite(rel_t_np).all()
        gate_on = config.max_correction_trans > 0 and model_warm and consecutive_rejects < 2
        rejected = (not finite) or (gate_on and (corr_t > config.max_correction_trans
                                                 or corr_r > config.max_correction_rot))
        if rejected:
            rel = init
            pose = kf_pose @ rel
            rmses.append(float("inf"))
            consecutive_rejects += 1
        else:
            rmses.append(res_rmse)
            consecutive_rejects = 0
            model_warm = True
        poses.append(pose)
        anchors.append(kf_index)
        velocity = blend_velocity(velocity, prev_rel.inverse() @ rel,
                                  damping=config.velocity_damping,
                                  adaptive=config.adaptive_velocity,
                                  innovation_scale=config.innovation_scale,
                                  damping_min=config.velocity_damping_min)

        trans = float(torch.linalg.vector_norm(rel.t))
        rot = float(rel.rotation_angle())
        # dead-reckoned frames never become keyframes or map insertions
        if (not rejected) and (trans > config.keyframe_trans or rot > config.keyframe_rot):
            if config.dynamic_sigma > 0:
                frames[k] = _mask_dynamic(frames[k], kf_cloud, rel, config.dynamic_sigma,
                                          config.dynamic_min_keep)
            edges.append((kf_index, k, rel))
            kf_cloud = frames[k]
            kf_pose = pose
            kf_index = k
            kf_indices.append(k)
            is_kf.append(True)
            prev_rel = eye
            if kf_masks is not None:
                kf_masks.append(frames[k].mask.cpu().numpy())
            if win is not None:
                node = win.add_keyframe(pose)
                win.add_edge(node - 1, node, rel)
                win.step()  # optimize the window, marginalize past it
                # adopt the refined keyframe poses and move every
                # non-keyframe pose with its keyframe's correction
                deltas = {}
                for off, fi in enumerate(kf_indices):
                    new_p = win.poses[off]
                    deltas[fi] = new_p @ poses[fi].inverse()
                    poses[fi] = new_p
                for fr in range(1, len(poses)):
                    a = anchors[fr]
                    if not is_kf[fr] and a in deltas:
                        poses[fr] = deltas[a] @ poses[fr]
                kf_pose = win.poses[-1]
                pose = kf_pose
            if use_map:
                vmap = insert_scan(vmap, frames[k], pose)
        else:
            is_kf.append(False)
            prev_rel = rel

    # close the final segment so the pose graph spans the whole run
    if kf_index != len(frames) - 1:
        edges.append((kf_index, len(frames) - 1, prev_rel))

    return OdometryResult(
        poses=poses,
        is_keyframe=is_kf,
        rmse=rmses,
        edges=edges,
        keyframe_indices=kf_indices,
        motion=MotionState(prev_rel=prev_rel, velocity=velocity, model_warm=model_warm,
                           consecutive_rejects=consecutive_rejects),
        keyframe_masks=kf_masks,
        window=win,
    )

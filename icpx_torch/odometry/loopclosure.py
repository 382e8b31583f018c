"""Loop-closure detection and verification for the pose graph.

Mirrors `icpx/odometry/loopclosure.py`. Candidates come from two channels:
believed-position distance (cheap, works while drift is small) and
appearance (ring descriptors, `placerec`), which finds revisits whatever
the drift, with a sector-profile yaw as the initial guess. Verification
runs every candidate through `register_batch` (the port runs the pairs one
after another, each as it would run alone); accepted closures become
weighted pose-graph edges.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Sequence, Tuple

import numpy as np
import torch

from icpx_torch.cloud import PointCloud
from icpx_torch.geometry.se3 import SE3
from icpx_torch.registration.icp import ICPConfig, register, register_batch


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    """The reference's fields and defaults (see its comments for each)."""

    min_separation: int = 5  # keyframes apart (time)
    max_candidate_dist: float = 3.0  # meters between believed positions
    max_descriptor_dist: float = 0.12  # appearance channel (<= 0 disables)
    n_rings: int = 12
    n_sectors: int = 48
    max_candidates: int = 10  # verified a pass (<= 0 lifts the cap)
    icp: ICPConfig = ICPConfig(
        objective="symmetric",
        max_iters=15,
        diff_threshold=0.0,
        rmse_change_tol=1e-6,
        robust="huber",
    )
    verify_batched: bool = True
    pyramid_levels: int = 2  # the sequential path's coarse-to-fine levels
    # accept below max(accept_rmse, accept_spacing_factor x NN spacing)
    accept_rmse: float = 0.1
    accept_spacing_factor: float = 1.5
    min_inlier_frac: float = 0.5
    edge_weight: float = 1.0


def _descriptors(keyframe_clouds, config):
    """Ring descriptors (M, R, 4) and sector profiles of every keyframe:
    one batched `place_descriptor` when the capacities agree."""
    from icpx_torch.odometry.placerec import cloud_descriptor, place_descriptor

    caps = {c.capacity for c in keyframe_clouds}
    if len(caps) == 1:
        descs, profiles = place_descriptor(
            torch.stack([c.xyz for c in keyframe_clouds]),
            torch.stack([c.mask for c in keyframe_clouds]),
            n_rings=config.n_rings, n_sectors=config.n_sectors)
        return descs, list(profiles)
    descs, profiles = [], []
    for c in keyframe_clouds:
        d, p = cloud_descriptor(c, n_rings=config.n_rings, n_sectors=config.n_sectors)
        descs.append(d)
        profiles.append(p)
    return torch.stack(descs), profiles


def _candidates(keyframe_poses, keyframe_clouds,
                config) -> Tuple[List[Tuple[float, int, int, bool]], list]:
    """Candidate pairs ranked over both channels: ([(score, i, j,
    from_position)], sector profiles)."""
    m = len(keyframe_poses)
    pos = np.stack([p.t.detach().cpu().numpy() for p in keyframe_poses])
    descs, profiles = _descriptors(keyframe_clouds, config)
    # pairwise scale-normalized descriptor distance in one device op
    Dj = descs.reshape(m, -1)
    f = Dj.shape[1]
    sq = torch.sum(Dj * Dj, dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * Dj @ Dj.T, min=0.0)
    diff = torch.sqrt(d2 / f)
    nrm2 = sq / f
    scale = torch.clamp(torch.sqrt(nrm2[:, None] + nrm2[None, :]), min=1e-6)
    desc_d = (diff / scale).cpu().numpy()

    pd = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=2)
    ii, jj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    sep_ok = jj >= ii + config.min_separation
    by_pos_m = pd < config.max_candidate_dist
    by_desc_m = (desc_d < config.max_descriptor_dist if config.max_descriptor_dist > 0
                 else np.zeros_like(by_pos_m))
    admit = sep_ok & (by_pos_m | by_desc_m)
    score_m = np.minimum(pd / max(config.max_candidate_dist, 1e-9),
                         desc_d / max(config.max_descriptor_dist, 1e-9))
    sel = np.argwhere(admit)
    scores = score_m[admit]
    order = np.lexsort((sel[:, 1], sel[:, 0], scores))  # score, then i, then j
    cands = [(float(scores[k]), int(sel[k, 0]), int(sel[k, 1]),
              bool(by_pos_m[sel[k, 0], sel[k, 1]])) for k in order]
    if config.max_candidates > 0 and len(cands) > config.max_candidates:
        logging.getLogger("icpx_torch.loopclosure").warning(
            "loop closure: %d candidates exceed max_candidates=%d; verifying the %d "
            "best-scored, dropping %d (raise max_candidates or <=0 to lift the cap)",
            len(cands), config.max_candidates, config.max_candidates,
            len(cands) - config.max_candidates)
        cands = cands[: config.max_candidates]
    return cands, profiles


def _initial_guess(i, j, by_pos, keyframe_poses, profiles, config) -> SE3:
    """The seed for verifying register(cloud_j -> cloud_i)."""
    believed = keyframe_poses[i].inverse() @ keyframe_poses[j]
    if by_pos:
        return believed
    # appearance-only: the believed pose carries the drift; seed from the
    # sector-profile yaw (cloud_i ~ Rz(-yaw_ij) cloud_j)
    from icpx_torch.odometry.placerec import relative_yaw

    yaw = float(relative_yaw(profiles[i], profiles[j]))
    dev = profiles[i].device
    return SE3.from_axis_angle(torch.tensor([0.0, 0.0, 1.0], device=dev), -yaw,
                               torch.zeros((3,), dtype=torch.float32, device=dev))


def detect_loop_closures(
    keyframe_poses: Sequence[SE3],
    keyframe_clouds: Sequence[PointCloud],
    config: LoopClosureConfig = LoopClosureConfig(),
) -> List[Tuple[int, int, SE3, float]]:
    """Verified loop closures among keyframes: [(i, j, i_T_j, rmse)] in
    keyframe indices, for `PoseGraph.from_edge_list` after remapping."""
    m = len(keyframe_poses)
    if m < 2:
        return []

    from icpx_torch.kernels.normals import estimate_normals
    from icpx_torch.kernels.voxel import auto_cell_size

    keyframe_clouds = [c if c.normals is not None else estimate_normals(c, k=10)
                       for c in keyframe_clouds]
    spacing = float(auto_cell_size(keyframe_clouds[0].xyz, keyframe_clouds[0].mask, scale=1.0))
    accept = max(config.accept_rmse, config.accept_spacing_factor * spacing)

    cands, profiles = _candidates(keyframe_poses, keyframe_clouds, config)
    if not cands:
        return []
    inits = [_initial_guess(i, j, by_pos, keyframe_poses, profiles, config)
             for (_, i, j, by_pos) in cands]

    if config.verify_batched:
        def stack(which, field):
            return torch.stack([getattr(keyframe_clouds[c[which]], field) for c in cands])

        init_b = SE3(R=torch.stack([t.R for t in inits]), t=torch.stack([t.t for t in inits]))
        res = register_batch(stack(2, "xyz"), stack(2, "mask"), stack(2, "normals"),
                             stack(1, "xyz"), stack(1, "mask"), stack(1, "normals"),
                             config.icp, init_b)
        rmse_all = res.final_rmse.cpu().tolist()
        inl_all = res.inlier_count.cpu().tolist()
        edges = []
        for k, (_, i, j, _) in enumerate(cands):
            n_valid = float(keyframe_clouds[j].num_valid())
            inlier = float(inl_all[k]) / max(n_valid, 1.0)
            if rmse_all[k] < accept and inlier > config.min_inlier_frac:
                edges.append((i, j, SE3(R=res.transform.R[k], t=res.transform.t[k]),
                              float(rmse_all[k])))
        return edges

    # sequential: coarse-to-fine a candidate
    edges = []
    for k, (_, i, j, _) in enumerate(cands):
        if config.pyramid_levels > 1:
            from icpx_torch.registration.pyramid import PyramidConfig, register_pyramid

            res, _ = register_pyramid(keyframe_clouds[j], keyframe_clouds[i],
                                      PyramidConfig(levels=config.pyramid_levels,
                                                    base=config.icp), init=inits[k])
        else:
            res = register(keyframe_clouds[j], keyframe_clouds[i], config.icp, init=inits[k])
        rmse = float(res.final_rmse)
        n_valid = float(keyframe_clouds[j].num_valid())
        if rmse < accept and float(res.inlier_count) / max(n_valid, 1.0) > config.min_inlier_frac:
            edges.append((i, j, res.transform, rmse))
    return edges

"""Whole-sequence odometry, one scan at a time or over stacked scans.

Mirrors `icpx/odometry/compiled.py`, where the sequence runs as one
`lax.scan` inside one compiled program. Here the scan is a Python loop over
frames on the scans' device, and its body is `OdometryStream.push`:

  * a scan arrives with its normals (or, for GICP, flattened (N, 9)
    covariances) and registers against the current keyframe with the
    constant-velocity initial guess; the motion gate, the pose, the
    velocity model and the keyframe decision are tensor selects;
  * the keyframe decision is fetched to the host once a frame
    (`profiling.fetch`, on top of `_icp_scan`'s one fetch an iteration):
    on a spawn the keyframe state is replaced and, on the block path, the
    keyframe's tile index, payload table and centroid are rebuilt, as the
    reference's `lax.cond` does;
  * the stream counts spawns and gate rejections on the device;
  * each registered frame (every push but the first) is an `icpx.frame`
    span in a profiler's trace, each keyframe build an `icpx.keyframe`
    span, each KD build an `icpx.index` span.

`run_odometry_compiled` pushes stacked (F, N, 3) scans in turn.

NN against the keyframe follows `ICPConfig.nn_method` ("auto"): below
`block_auto_threshold` points the brute search (`nearest_neighbor`: the
`nn` kernel on the card), above it KD tile indexes, the source's built
every frame and the keyframe's on each spawn (the `sort` kernel on the
card), with the plain `block_nn` fold and a row gather of the payload
table, as the reference computes it. The q-tile, frozen-candidate and
refine-stride ladders are the reference's, unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from icpx_torch.geometry.se3 import SE3
from icpx_torch.kernels.blocknn import (
    _SUPER_G,
    _candidate_tiles,
    block_nn,
    fused_payload_table,
    trim_index,
)
from icpx_torch.kernels.knn import nearest_neighbor
from icpx_torch.odometry.frontend import blend_velocity
from icpx_torch.registration.icp import ICPConfig, _icp_scan, gicp_cov_rot
from icpx_torch.utils import profiling


def resolve_odo_freeze(n_pts: int, freeze: Optional[bool] = None) -> bool:
    """Per-frame frozen candidates: on from 16,384-point scans (the
    reference's ladder)."""
    return n_pts >= 16384 if freeze is None else freeze


def resolve_odo_refine_stride(config: ICPConfig, n_pts: int, stride: int = 0) -> int:
    """Within-tile refine stride of each frame's registration: an explicit
    `stride` wins, then an explicit `config.refine_stride`, then the
    reference's ladder (4 from 131,072-point scans, 2 from 65,536, else 1)."""
    if stride:
        return stride
    if config.refine_stride:
        return config.refine_stride
    return 4 if n_pts >= 131072 else 2 if n_pts >= 65536 else 1


def resolve_odo_q_tile(config: ICPConfig, n_pts: int, q_tile: int = 0) -> int:
    """Source query-tile size: an explicit `q_tile` wins, then a tuned
    `config.block_q_tile` (anything but the class default), then the
    reference's ladder (256 from 65,536-point scans, 128 from 8,192, else
    the config's resolution)."""
    if q_tile:
        return q_tile
    if config.block_q_tile != ICPConfig.block_q_tile:
        return config.resolve_q_tile(n_pts)
    return 256 if n_pts >= 65536 else 128 if n_pts >= 8192 else config.resolve_q_tile(n_pts)


@dataclass(frozen=True)
class CompiledOdometry:
    """Whole-sequence odometry output (tensors on the scans' device)."""

    poses: SE3  # (F,) world_T_frame
    is_keyframe: torch.Tensor  # (F,) bool
    rmse: torch.Tensor  # (F,)
    edge_src: torch.Tensor  # (F,) int32 keyframe each step measured from
    edge_rel: SE3  # (F,) measured kf_T_frame (identity at index 0)
    final_kf: torch.Tensor  # 0-d int32: keyframe index after the last frame
    final_rel: SE3  # prev_rel after the last frame
    # ICP iterations each frame ran (0 at frame 0); the reference's
    # compiled program does not report them, nor the three below
    iters: Optional[torch.Tensor] = None
    rejected: Optional[torch.Tensor] = None  # (F,) bool: the motion gate kept the guess
    spawns: Optional[torch.Tensor] = None  # 0-d int32 keyframes spawned after frame 0
    rejections: Optional[torch.Tensor] = None  # 0-d int32 frames the gate rejected

    def edge_list(self) -> List[Tuple[int, int, SE3]]:
        """Measured pose-graph edges, the same structure as
        `frontend.run_odometry().edges`: one edge a keyframe spawn (source
        keyframe -> new keyframe, measured transform) and the closing edge
        of the final open segment."""
        is_kf = self.is_keyframe.cpu().tolist()
        src = self.edge_src.cpu().tolist()
        f = len(is_kf)
        edges: List[Tuple[int, int, SE3]] = []
        for k in range(1, f):
            if is_kf[k]:
                edges.append((int(src[k]), k, SE3(R=self.edge_rel.R[k], t=self.edge_rel.t[k])))
        fk = int(self.final_kf)
        if fk != f - 1:
            edges.append((fk, f - 1, self.final_rel))
        return edges


def _select(cond: torch.Tensor, a: SE3, b: SE3) -> SE3:
    return SE3(R=torch.where(cond, a.R, b.R), t=torch.where(cond, a.t, b.t))


def _masked_center(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    denom = torch.clamp(mask.sum(), min=1).to(torch.float32)
    return torch.where(mask[:, None], xyz, 0.0).sum(0) / denom


_DEFAULT_CONFIG = ICPConfig(
    objective="symmetric",
    max_iters=12,
    diff_threshold=0.0,
    rmse_change_tol=1e-6,
    robust="huber",
    max_corr_dist=2.0,
)


@dataclass(frozen=True)
class OdometryFrame:
    """One pushed scan's result (tensors on the stream's device)."""

    pose: SE3  # world_T_frame
    rel: SE3  # measured kf_T_frame (identity for the first scan)
    rmse: torch.Tensor  # 0-d; inf when the motion gate rejected the frame
    iters: torch.Tensor  # 0-d int32 ICP iterations (0 for the first scan)
    is_keyframe: torch.Tensor  # 0-d bool: the scan became the keyframe
    edge_src: torch.Tensor  # 0-d int32 keyframe the frame was measured from
    rejected: torch.Tensor  # 0-d bool: the motion gate kept the initial guess
    spawns: torch.Tensor  # 0-d int32 keyframes spawned so far (the first scan's not counted)
    rejections: torch.Tensor  # 0-d int32 frames the gate rejected so far


class OdometryStream:
    """Compiled odometry one scan at a time: `push` registers a scan
    against the current keyframe and returns its `OdometryFrame`; `result`
    gives the `CompiledOdometry` of every scan pushed so far.

    The state between pushes is the frame loop's: the keyframe's scan,
    pose and index, the previous frame's measurement (`prev_rel`), the
    velocity model, whether it is warm, the run of gate rejections, and on
    the block path the keyframe's tile index, payload table and centroid
    (rebuilt on each spawn). `capacity` is the scans' row count N (every
    scan the same), `device` theirs; the rest is `run_odometry_compiled`'s.
    A push makes one host read, the spawn flag, besides the ICP loop's."""

    def __init__(
        self,
        capacity: int,
        device,
        config: ICPConfig = _DEFAULT_CONFIG,
        *,
        keyframe_trans: float = 1.0,
        keyframe_rot: float = 0.2,
        max_correction_trans: float = 1.0,
        max_correction_rot: float = 0.5,
        velocity_damping: float = 1.0,
        adaptive_velocity: bool = True,
        innovation_scale: float = 0.5,
        velocity_damping_min: float = 0.25,
        freeze_candidates: Optional[bool] = None,
        q_tile: int = 0,
        refine_stride: int = 0,
    ):
        dev = torch.device(device)
        self.n_pts, self.device, self.config = capacity, dev, config
        self.keyframe_trans, self.keyframe_rot = keyframe_trans, keyframe_rot
        self.max_correction_trans, self.max_correction_rot = max_correction_trans, max_correction_rot
        self.velocity_kw = dict(damping=velocity_damping, adaptive=adaptive_velocity,
                                innovation_scale=innovation_scale,
                                damping_min=velocity_damping_min)
        self.freeze = resolve_odo_freeze(capacity, freeze_candidates)
        self.q_tile = resolve_odo_q_tile(config, capacity, q_tile)
        self.stride_r = resolve_odo_refine_stride(config, capacity, refine_stride)
        self.aux_rot = gicp_cov_rot if config.objective == "gicp" else None
        self.use_block = config.resolve_nn(capacity) == "block"
        self.builder = config.tile_builder()
        self.score_prec = config.resolve_score_prec()
        self.eye3 = torch.eye(3, dtype=torch.float32, device=dev)
        self.frames: List[OdometryFrame] = []

    def _build_target(self, fx, fm, fn):
        """The keyframe's state, built once a spawn: its centroid, the
        trimmed tile index over the centred cloud and the fused (N, 3+D)
        payload table in sorted order."""
        with profiling.span("icpx.keyframe"):
            center = _masked_center(fx, fm)
            fx_c = torch.where(fm[:, None], fx - center[None, :], fx)
            with profiling.span("icpx.index"):
                t_idx = trim_index(self.builder(fx_c, fm, tile_size=self.config.block_tile),
                                   self.n_pts, multiple=_SUPER_G)
            return t_idx, fused_payload_table(t_idx, fn), center

    def _brute_register(self, fx_c, fm, fn, kf_c, kf_mask, kf_n, init_c):
        config = self.config

        def nn_fn(p):
            d2, idx = nearest_neighbor(p, kf_c, ref_mask=kf_mask, tile_q=config.tile_q,
                                       tile_r=config.tile_r)
            return kf_c.index_select(0, idx), kf_n.index_select(0, idx), torch.sqrt(d2)

        return _icp_scan(config, fx_c, fm, fn, init_c, nn_fn, aux_rot=self.aux_rot)

    def _block_register(self, fx_c, fm, fn, t_idx, tgt_pl, init_c):
        """One frame-to-keyframe registration through the tile indexes,
        both clouds in keyframe-centroid coordinates: the single-pair block
        path without its coarse phase."""
        config, aux_rot, stride_r = self.config, self.aux_rot, self.stride_r
        with profiling.span("icpx.index"):
            s_idx = trim_index(self.builder(fx_c, fm, tile_size=self.q_tile), self.n_pts)
        order = s_idx.order.long()
        valid = order >= 0
        safe = torch.clamp(order, min=0)
        s_xyz = s_idx.tiles.reshape(-1, 3)
        s_n = torch.where(valid[:, None], fn[safe], 0.0)
        sq = self.q_tile
        tq = s_xyz.shape[0] // sq

        cand = None
        if self.freeze:
            # ranked once a frame, at the warm initial pose
            cand = _candidate_tiles(init_c.apply(s_xyz).reshape(tq, sq, 3), t_idx,
                                    config.block_k)[0]

        def make_nn(sq_n):
            def nn_fn(p):
                d2, pos = block_nn(p.reshape(tq, sq_n, 3), t_idx, k_tiles=config.block_k,
                                   return_pos=True, cand_tiles=cand, score_prec=self.score_prec)
                pl = tgt_pl[pos.long()]
                return pl[:, :3], pl[:, 3:], torch.sqrt(d2)

            return nn_fn

        # the mid phase: every stride_r-th row of each query tile (tile
        # boxes and frozen candidates stay valid) for all but the last
        # refine_full_iters iterations
        mid = (stride_r > 1 and sq % stride_r == 0 and sq // stride_r >= 8
               and config.max_iters > config.refine_full_iters)
        prev_rmse0, init_m, cfg_f, mid_iters = None, init_c, config, 0
        if mid:
            dn = s_n.shape[1]

            def substride(x, d=None):
                rows = x.reshape((tq, sq) + ((d,) if d else ()))[:, ::stride_r]
                return rows.reshape((-1, d) if d else (-1,))

            cfg_m = dataclasses.replace(config, max_iters=config.max_iters - config.refine_full_iters,
                                        diff_threshold=config.diff_threshold / stride_r)
            res_m = _icp_scan(cfg_m, substride(s_xyz, 3), substride(valid), substride(s_n, dn),
                              init_c, make_nn(sq // stride_r), aux_rot=aux_rot)
            init_m, prev_rmse0, mid_iters = res_m.transform, res_m.final_rmse, res_m.iters
            cfg_f = dataclasses.replace(config, max_iters=config.refine_full_iters)
        res = _icp_scan(cfg_f, s_xyz, valid, s_n, init_m, make_nn(sq), aux_rot=aux_rot,
                        prev_rmse0=prev_rmse0)
        return res.replace(iters=res.iters + mid_iters)

    def _int(self, value: int) -> torch.Tensor:
        # a fill on the device, not a copy from the host
        return torch.full((), value, dtype=torch.int32, device=self.device)

    def push(self, xyz: torch.Tensor, mask: torch.Tensor, normals: torch.Tensor) -> OdometryFrame:
        """Register one (N, 3) sensor-frame scan with its (N,) mask and its
        (N, 3) normals (GICP: (N, 9) covariances); the first scan becomes
        keyframe 0 at the identity."""
        if xyz.shape[0] != self.n_pts:
            raise ValueError(f"a scan of {xyz.shape[0]} rows; this stream takes {self.n_pts}")
        if not self.frames:
            out = self._first(xyz, mask, normals)
        else:
            with profiling.span("icpx.frame"):
                out = self._register(xyz, mask, normals)
        self.frames.append(out)
        return out

    def _first(self, fx, fm, fn) -> OdometryFrame:
        dev = self.device
        eye = SE3.identity(device=dev)
        self.kf_xyz, self.kf_mask, self.kf_n = fx, fm, fn
        self.kf_pose, self.kf_idx = eye, 0
        self.prev_rel, self.velocity = eye, eye
        self.model_warm = torch.zeros((), dtype=torch.bool, device=dev)
        self.rejects = torch.zeros((), dtype=torch.int32, device=dev)
        self.spawns = torch.zeros((), dtype=torch.int32, device=dev)
        self.rejections = torch.zeros((), dtype=torch.int32, device=dev)
        self.kf_cache = self._build_target(fx, fm, fn) if self.use_block else None
        return OdometryFrame(pose=eye, rel=eye, rmse=torch.zeros((), dtype=torch.float32, device=dev),
                             iters=self._int(0), is_keyframe=torch.ones((), dtype=torch.bool, device=dev),
                             edge_src=self._int(0), rejected=torch.zeros((), dtype=torch.bool, device=dev),
                             spawns=self.spawns, rejections=self.rejections)

    def _register(self, fx, fm, fn) -> OdometryFrame:
        k = len(self.frames)
        eye3, prev_rel = self.eye3, self.prev_rel
        init = prev_rel @ self.velocity
        # solve in keyframe-centroid coordinates (the conjugation register()
        # applies); on the block path the centroid comes with the spawn cache
        center = self.kf_cache[2] if self.use_block else _masked_center(self.kf_xyz, self.kf_mask)
        shift, unshift = SE3(R=eye3, t=-center), SE3(R=eye3, t=center)
        fx_c = torch.where(fm[:, None], fx - center[None, :], fx)
        init_c = shift @ init @ unshift
        if self.use_block:
            res = self._block_register(fx_c, fm, fn, self.kf_cache[0], self.kf_cache[1], init_c)
        else:
            kf_c = torch.where(self.kf_mask[:, None], self.kf_xyz - center[None, :], self.kf_xyz)
            res = self._brute_register(fx_c, fm, fn, kf_c, self.kf_mask, self.kf_n, init_c)
        rel = unshift @ res.transform @ shift

        # the motion gate: warm model, at most 2 rejections in a row
        corr = init.inverse() @ rel
        corr_t = torch.linalg.vector_norm(corr.t)
        corr_r = corr.rotation_angle()
        finite = torch.isfinite(corr_t) & torch.isfinite(rel.t).all()
        gate_on = self.model_warm & (self.rejects < 2) & (self.max_correction_trans > 0)
        rejected = (~finite) | (gate_on & ((corr_t > self.max_correction_trans)
                                           | (corr_r > self.max_correction_rot)))
        rel = _select(rejected, init, rel)
        pose = self.kf_pose @ rel
        rmse = torch.where(rejected, torch.full_like(res.final_rmse, float("inf")),
                           res.final_rmse)
        self.velocity = blend_velocity(self.velocity, prev_rel.inverse() @ rel, **self.velocity_kw)
        self.model_warm = self.model_warm | ~rejected
        self.rejects = torch.where(rejected, self.rejects + 1, torch.zeros_like(self.rejects))
        spawn_t = (~rejected) & ((torch.linalg.vector_norm(rel.t) > self.keyframe_trans)
                                 | (rel.rotation_angle() > self.keyframe_rot))
        spawn = profiling.fetch(spawn_t)  # the frame's one fetch besides the loop's
        self.spawns = self.spawns + spawn_t
        self.rejections = self.rejections + rejected

        out = OdometryFrame(pose=pose, rel=rel, rmse=rmse, iters=self._int(res.iters),
                            is_keyframe=spawn_t, edge_src=self._int(self.kf_idx), rejected=rejected,
                            spawns=self.spawns, rejections=self.rejections)
        if spawn:
            self.kf_xyz, self.kf_mask, self.kf_n = fx, fm, fn
            self.kf_pose, self.kf_idx, self.prev_rel = pose, k, SE3.identity(device=self.device)
            if self.use_block:
                self.kf_cache = self._build_target(fx, fm, fn)
        else:
            self.prev_rel = rel
        return out

    def result(self) -> CompiledOdometry:
        """The `CompiledOdometry` of every scan pushed so far."""
        if not self.frames:
            raise ValueError("no scan pushed yet")
        fr = self.frames

        def stack(name):
            return torch.stack([getattr(f, name) for f in fr])

        return CompiledOdometry(
            poses=SE3(R=torch.stack([f.pose.R for f in fr]), t=torch.stack([f.pose.t for f in fr])),
            is_keyframe=stack("is_keyframe"),
            rmse=stack("rmse"),
            edge_src=stack("edge_src"),
            edge_rel=SE3(R=torch.stack([f.rel.R for f in fr]), t=torch.stack([f.rel.t for f in fr])),
            final_kf=self._int(self.kf_idx),
            final_rel=self.prev_rel,
            iters=stack("iters"),
            rejected=stack("rejected"),
            spawns=self.spawns,
            rejections=self.rejections,
        )


def run_odometry_compiled(
    frames_xyz: torch.Tensor,  # (F, N, 3) sensor-frame scans
    frames_mask: torch.Tensor,  # (F, N)
    frames_normals: torch.Tensor,  # (F, N, 3), or (F, N, 9) covariances for GICP
    config: ICPConfig = _DEFAULT_CONFIG,
    **kwargs,
) -> CompiledOdometry:
    """A `CompiledOdometry` with poses[0] = identity (world = the first
    sensor frame), on the scans' device: each scan pushed in turn through
    an `OdometryStream`, whose keyword arguments these are.

    `freeze_candidates` (block path) ranks each frame's candidate tiles once
    at the warm-started initial pose; `q_tile` sets the source query-tile
    size; `refine_stride` runs each frame's bulk iterations on every
    stride-th row of each query tile and the last `refine_full_iters` at
    full resolution. 0 / None take the reference's ladders
    (`resolve_odo_freeze`, `resolve_odo_q_tile`,
    `resolve_odo_refine_stride`). The motion gate (`max_correction_trans`,
    `max_correction_rot`), the keyframe thresholds (`keyframe_trans`,
    `keyframe_rot`) and the velocity model (`velocity_damping`,
    `adaptive_velocity`, `innovation_scale`, `velocity_damping_min`) are
    `OdometryStream`'s."""
    stream = OdometryStream(frames_xyz.shape[1], frames_xyz.device, config, **kwargs)
    for k in range(frames_xyz.shape[0]):
        stream.push(frames_xyz[k], frames_mask[k], frames_normals[k])
    return stream.result()

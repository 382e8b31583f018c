"""Entry "odometry_stream": online odometry over a LiDAR sequence (config
kind "lidar"). A request takes the configuration's scans in scan order, as
a sensor delivers them: each scan's normals, then
`odometry.compiled.OdometryStream.push` with the configuration's
`odometry` settings (the traffic's on top); it ends in one synchronise.
Work = the frames registered; gate = the unaligned ATE of the request's
poses against the simulator's.

The check (`reference_online.py`) holds each sampled frame k to the
reference's registration of scan k against the program's own keyframe
(`edge_src[k]`) from the initial guess the frame loop makes of the
program's measurements of the frames before k: rotation gap, the RMS of
the translation gaps, the RMSE gap, and whether the gate and keyframe
decisions (and the keyframe each frame is measured from) are the
reference's given the same measurements."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

import generators as gen
import kdwork
import reference as ref
import reference_online as ro
from entries import Entry, _mod, _se3_np, _settings

NORMALS_TILE = 128  # the tiles of the KD build behind each scan's radius normals


class OdometryOnline(Entry):
    """Closed loop of requests, each one sequence pushed scan by scan."""

    def setup(self) -> None:
        c = self.config
        _mod("icpx_torch.odometry.compiled").OdometryStream  # a program without it fails here
        PointCloud = _mod("icpx_torch.cloud").PointCloud
        w, tr, sc = c["world"], c["trajectory"], c["scans"]
        world = gen.make_world(**w)
        self.Rw, self.tw = gen.make_trajectory(tr["frames"], speed=tr["speed"], turn=tr["turn"])
        scans = gen.simulate_scans(world, self.Rw, self.tw, max_range=sc["max_range"],
                                   points_per_scan=sc["points"], noise=sc["noise"],
                                   seed=gen.sub_seed(self.seed, 1))
        cap = ((sc["points"] + 127) // 128) * 128
        self.xyz = [np.concatenate([s, np.zeros((cap - len(s), 3), np.float32)]) for s in scans]
        self.valid = [np.arange(cap) < len(s) for s in scans]
        self.clouds = [PointCloud.create(s, capacity=cap, device=self.device) for s in scans]
        self.cap, self.frames = cap, len(scans)
        self.odo = {**c.get("odometry", {}), **self.traffic.get("odometry", {})}
        self.ref_icp = {**c["icp"], **self.traffic.get("icp", {})}
        self.loop = ro.Loop.of(self.odo)
        self._ref_normals: Dict[int, torch.Tensor] = {}
        self._states: Dict[int, list] = {}
        self.configure()

    def request(self, j: int) -> dict:
        est = _mod("icpx_torch.kernels.normals").estimate_normals
        stream = _mod("icpx_torch.odometry.compiled").OdometryStream(self.cap, self.device,
                                                                     self.cfg, **self.odo)
        k = int(self.config["normals_k"])
        for cloud in self.clouds:
            scan = est(cloud, k=k)
            stream.push(scan.xyz, scan.mask, scan.normals)
        res = stream.result()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return dict(R=res.edge_rel.R, t=res.edge_rel.t, pose_R=res.poses.R, pose_t=res.poses.t,
                    rmse=res.rmse, iters=res.iters[1:], is_kf=res.is_keyframe, src=res.edge_src,
                    rejected=res.rejected, spawns=res.spawns, rejections=res.rejections,
                    work=self.frames - 1)

    def gt(self, k: int) -> np.ndarray:
        """frame0_T_frame_k from the simulator's poses."""
        pose = lambda i: ref.se3(self.Rw[i].astype(np.float64), self.tw[i].astype(np.float64))  # noqa: E731
        return ref.inv(pose(0)) @ pose(k)

    def ate(self, rec: dict) -> float:
        err = [np.linalg.norm(_se3_np(rec["pose_R"][k], rec["pose_t"][k])[:3, 3] - self.gt(k)[:3, 3])
               for k in range(self.frames)]
        return float(np.sqrt(np.mean(np.square(err))))

    def judge(self, rec: dict) -> bool:
        ate = self.ate(rec)
        return bool(math.isfinite(ate) and ate < self.config["gate"]["ate"])

    def frame_iters(self, rec: dict) -> List[int]:
        return [int(i) for i in rec["iters"].tolist()]

    def summary(self, records: List[dict]) -> Dict[str, float]:
        ates, rpe_t, rpe_r = [], [], []
        for r in records:
            ates.append(self.ate(r))
            poses = [_se3_np(r["pose_R"][k], r["pose_t"][k]) for k in range(self.frames)]
            for k in range(1, self.frames):
                err = ref.inv(ref.inv(self.gt(k - 1)) @ self.gt(k)) @ ref.inv(poses[k - 1]) @ poses[k]
                rpe_t.append(float(np.linalg.norm(err[:3, 3])))
                rpe_r.append(ref.rotation_angle(err[:3, :3]))
        return {"ate_max_m": max(ates), "ate_mean_m": float(np.mean(ates)),
                "rpe_t_rmse_m": float(np.sqrt(np.mean(np.square(rpe_t)))),
                "rpe_rot_rmse_rad": float(np.sqrt(np.mean(np.square(rpe_r)))),
                "spawns": sum(int(r["spawns"]) for r in records),
                "rejections": sum(int(r["rejections"]) for r in records)}

    def release(self) -> None:
        self.clouds = None

    def kernel_work(self, rec: dict) -> dict:
        """The sort kernel's level sorts: each scan's normals (radius
        neighbourhoods from `reference.RADIUS_FROM` rows), and on the block
        path each frame's source index and each keyframe's index."""
        block, q_tile, _, _ = ro.ladders(self.cap, self.ref_icp, self.odo)
        tile = {**ro.ICP_DEFAULTS, **self.ref_icp}["block_tile"]
        sorts = []
        if self.cap >= ref.RADIUS_FROM:
            sorts += self.frames * kdwork.level_sorts(self.cap, NORMALS_TILE)
        if block:
            sorts += (self.frames - 1) * kdwork.level_sorts(self.cap, q_tile)
            sorts += (1 + int(rec["spawns"])) * kdwork.level_sorts(self.cap, tile)
        return {"sort": sorts}

    def sample(self, records: List[dict]) -> List[tuple]:
        """`check_answers` of the frames 1..F-1, drawn from the seed, in
        every request of the window."""
        chosen = self._draw(list(range(1, self.frames)))
        return [(rec, k) for rec in records for k in chosen]

    def _replay(self, rec: dict) -> list:
        """The frame loop's `State` of each frame 1..F-1, fed the record's
        measurements and decisions (once a record)."""
        if id(rec) not in self._states:
            rels = [_se3_np(rec["R"][k], rec["t"][k]) for k in range(self.frames)]
            self._states[id(rec)] = (rec, ro.replay(rels, rec["is_kf"].tolist(),
                                                    rec["rejected"].tolist(), self.loop))
        return self._states[id(rec)][1]

    def check(self, sample: List[tuple], control: Optional[str] = None) -> Dict[str, float]:
        """Against the reference, frame by frame: the worst rotation gap,
        the worst translation gap and the root mean square of them
        (`t_gap_rms_m`), the worst RMSE gap (none where both reject the
        frame), and `decision_gaps`, the frames whose gate decision,
        keyframe decision or keyframe differs from the reference's."""
        numbers = {"rot_gap_rad": 0.0, "t_gap_m": 0.0, "rmse_gap_m": 0.0, "decision_gaps": 0.0}
        t_gaps = []
        for rec, k in sample:
            st = self._replay(rec)[k - 1]
            key = (k, st.kf, st.init.tobytes(), st.warm, st.rejects)
            want = self.answer(key)
            T, rmse = _se3_np(rec["R"][k], rec["t"][k]), float(rec["rmse"][k])
            rejected, is_kf, src = bool(rec["rejected"][k]), bool(rec["is_kf"][k]), int(rec["src"][k])
            if control is not None:
                got = self.answer(key, control)
                T, rmse, rejected = got.T, got.rmse, got.rejected
                is_kf = ro.spawns(T, rejected, self.loop)
            rot, t = ref.gap(T, want.T)
            gap = 0.0 if math.isinf(rmse) and math.isinf(want.rmse) else abs(rmse - want.rmse)
            for name, v in (("rot_gap_rad", rot), ("t_gap_m", t), ("rmse_gap_m", gap)):
                numbers[name] = max(numbers[name], v if math.isfinite(v) else float("inf"))
            t_gaps.append(t if math.isfinite(t) else float("inf"))
            if (rejected != want.rejected or is_kf != ro.spawns(T, rejected, self.loop)
                    or (control is None and src != st.kf)):
                numbers["decision_gaps"] += 1.0
        if t_gaps:
            numbers["t_gap_rms_m"] = math.sqrt(sum(t * t for t in t_gaps) / len(t_gaps))
        numbers["reference_frames"] = float(len(self._answers))
        return numbers

    def ref_normals(self, i: int) -> torch.Tensor:
        k = int(self.config["normals_k"])
        if ref.REAL != torch.float64:  # a control's: its own precision, not kept
            return ref.normals(self.xyz[i], self.valid[i], k, self.device)
        if i not in self._ref_normals:
            self._ref_normals[i] = ref.normals(self.xyz[i], self.valid[i], k, self.device)
        return self._ref_normals[i]

    def reference(self, key: tuple, control: Optional[str]) -> ro.FrameAnswer:
        """The reference's answer for frame k measured from keyframe kf in
        the given state; "guarantee" runs each frame's bulk phase for a
        third of its iterations."""
        k, kf, init, warm, rejects = key
        st = ro.State(kf=kf, init=np.frombuffer(init).reshape(4, 4).copy(), warm=warm,
                      rejects=rejects)
        return ro.register_frame(self.xyz[k], self.valid[k], self.ref_normals(k), self.xyz[kf],
                                 self.valid[kf], self.ref_normals(kf), _settings(self.ref_icp),
                                 self.ref_icp, self.odo, st, self.device,
                                 guarantee=control == "guarantee")


ENTRY = OdometryOnline

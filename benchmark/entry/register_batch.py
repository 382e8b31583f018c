"""Entry "register_batch": requests over a LiDAR sequence (config kind
"lidar"): normals for `scans_per_request` consecutive scans, then
`registration.icp.register_batch` on their consecutive pairs from the
identity, once for each of the traffic's `phases` (every `stride`-th source
row, the phase's ICP settings, from the previous phase's transforms); work
= the pairs (frames registered); gate = the unaligned ATE of the pairs'
chain."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

import generators as gen
import reference as ref
from entries import Entry, _mod, _se3_np, _settings


class PairBatches(Entry):
    """Closed loop of requests: normals for consecutive scans, then
    `register_batch` on their consecutive pairs from the identity, one
    call a phase."""

    def setup(self) -> None:
        c = self.config
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
        self.n_valid = [len(s) for s in scans]
        self.cap = cap
        self._ref_normals: Dict[int, torch.Tensor] = {}
        self.phases = [dict(p) for p in self.traffic.get("phases", [{"stride": 1}])]
        self.configure()
        starts = list(self.traffic["starts"])
        rng = np.random.default_rng(gen.sub_seed(self.seed, 3))
        self.starts = [starts[int(a)] for a in rng.permutation(len(starts))]
        self.span = int(self.traffic["scans_per_request"])

    def configure(self, **over) -> None:
        super().configure(**over)
        self.cfgs = [dataclasses.replace(self.cfg, **{k: v for k, v in p.items() if k != "stride"})
                     for p in self.phases]

    def gt(self, a: int, b: int) -> np.ndarray:
        """a_T_b from the simulator's poses."""
        pose = lambda k: ref.se3(self.Rw[k].astype(np.float64), self.tw[k].astype(np.float64))  # noqa: E731
        return ref.inv(pose(a)) @ pose(b)

    def normals(self, idx: List[int]):
        """The program's normals of scans `idx`, stacked (xyz, mask, normals)."""
        est = _mod("icpx_torch.kernels.normals").estimate_normals
        k = int(self.config["normals_k"])
        with_n = [est(self.clouds[i], k=k) for i in idx]
        return tuple(torch.stack([getattr(f, a) for f in with_n]) for a in ("xyz", "mask", "normals"))

    def request(self, j: int) -> dict:
        s = self.starts[j % len(self.starts)]
        xyz, mask, nrm = self.normals(list(range(s, s + self.span)))
        register_batch = _mod("icpx_torch.registration.icp").register_batch
        res, phase_iters = None, []
        for p, cfg in zip(self.phases, self.cfgs):
            k = int(p["stride"])
            res = register_batch(xyz[1:, ::k], mask[1:, ::k], nrm[1:, ::k], xyz[:-1], mask[:-1],
                                 nrm[:-1], cfg, init=None if res is None else res.transform)
            phase_iters.append(res.iters)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return dict(start=s, R=res.transform.R, t=res.transform.t, rmse=res.final_rmse,
                    iters=sum(phase_iters), phase_iters=phase_iters, work=self.span - 1)

    def chain(self, rec: dict) -> List[np.ndarray]:
        poses = [np.eye(4)]
        for b in range(self.span - 1):
            poses.append(poses[-1] @ _se3_np(rec["R"][b], rec["t"][b]))
        return poses

    def ate(self, first: int, poses: List[np.ndarray]) -> float:
        err = [np.linalg.norm(P[:3, 3] - self.gt(first, first + k)[:3, 3])
               for k, P in enumerate(poses)]
        return float(np.sqrt(np.mean(np.square(err))))

    def frame_iters(self, rec: dict) -> List[int]:
        return [int(i) for i in rec["iters"].tolist()]

    def judge(self, rec: dict) -> bool:
        ate = self.ate(rec["start"], self.chain(rec))
        return bool(math.isfinite(ate) and ate < self.config["gate"]["ate"])

    def summary(self, records: List[dict]) -> Dict[str, float]:
        ates, rpe_t, rpe_r = [], [], []
        for r in records:
            first, poses = r["start"], self.chain(r)
            ates.append(self.ate(first, poses))
            for k in range(1, len(poses)):
                err = ref.inv(self.gt(first + k - 1, first + k)) @ ref.inv(poses[k - 1]) @ poses[k]
                rpe_t.append(float(np.linalg.norm(err[:3, 3])))
                rpe_r.append(ref.rotation_angle(err[:3, :3]))
        return {"ate_max_m": max(ates), "ate_mean_m": float(np.mean(ates)),
                "rpe_t_rmse_m": float(np.sqrt(np.mean(np.square(rpe_t)))),
                "rpe_rot_rmse_rad": float(np.sqrt(np.mean(np.square(rpe_r))))}

    def release(self) -> None:
        self.clouds = None

    def kernel_work(self, rec: dict) -> dict:
        s, work = rec["start"], []
        for p, its in zip(self.phases, rec["phase_iters"]):
            nq = len(range(0, self.cap, int(p["stride"])))
            its = its.tolist()
            work += [(nq, self.cap, self.n_valid[s + b], int(its[b])) for b in range(self.span - 1)]
        return {"nn": work}

    def sample(self, records: List[dict]) -> List[tuple]:
        """`check_answers` of the distinct pairs answered in the window,
        drawn from the seed, and every answer (record, b) the window gave
        for them (the reference works each pair out once)."""
        keys = sorted({rec["start"] + b for rec in records for b in range(self.span - 1)})
        chosen = set(self._draw(keys))
        return [(rec, b) for rec in records for b in range(self.span - 1)
                if rec["start"] + b in chosen]

    def answers(self, sample: List[tuple]) -> list:
        return [(rec["start"] + b, _se3_np(rec["R"][b], rec["t"][b]), float(rec["rmse"][b]))
                for rec, b in sample]

    def ref_normals(self, i: int) -> torch.Tensor:
        k = int(self.config["normals_k"])
        if ref.REAL != torch.float64:  # a control's: its own precision, not kept
            return ref.normals(self.xyz[i], self.valid[i], k, self.device)
        if i not in self._ref_normals:
            self._ref_normals[i] = ref.normals(self.xyz[i], self.valid[i], k, self.device)
        return self._ref_normals[i]

    def reference(self, k: int, control: Optional[str]) -> ref.Answer:
        """The reference's answer for the pair (source k + 1, target k),
        phase by phase; "guarantee" stops each phase at a third of its
        iterations, as a cheaper registration would."""
        src, sv, sn = self.xyz[k + 1], self.valid[k + 1], self.ref_normals(k + 1)
        tgt, tv, tn = self.xyz[k], self.valid[k], self.ref_normals(k)
        icp = {**self.config["icp"], **self.traffic.get("icp", {})}
        T, a = None, None
        for p in self.phases:
            st = int(p["stride"])
            s = _settings({**icp, **p})
            if control == "guarantee":
                s = dataclasses.replace(s, max_iters=max(s.max_iters // 3, 1))
            a = ref.register(src[::st], sv[::st], sn[::st], tgt, tv, tn, s, self.device, init=T)
            T = a.T
        return a


ENTRY = PairBatches

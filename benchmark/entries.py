"""The general traffic generator: every traffic mix is a data file that
names one of these entries and gives its parameters.

An entry makes a cell's inputs from its configuration and the seed, warms
the shapes its requests use, issues request j of the closed loop (each
request ends in a synchronise, so the harness's host clock times it whole),
judges each finished request against the simulator's truth, and checks a
sample of the window's answers against the plain reference
(`reference.py`).

Entries:

* "register": back-to-back `registration.icp.register` calls over a pool
  of ground-truth pairs (config kind "gt_pairs"), each pool pair with its
  own ground truth; work = the source's points; gate = rotation and
  translation within the configured bounds of the ground truth.
* "register_batch": requests over a LiDAR sequence (config kind
  "lidar"): normals for `scans_per_request` consecutive scans, then
  `registration.icp.register_batch` on their consecutive pairs from the
  identity, once for each of the traffic's `phases` (every `stride`-th
  source row, the phase's ICP settings, from the previous phase's
  transforms); work = the pairs (frames registered); gate = the unaligned
  ATE of the pairs' chain.

The program is reached only through module attributes looked up at call
time, so the harness's spans (and a test's faults) wrap what a request
really calls.

Controls (`control.py`) put the reference in the program's place:
"float32" and "tf32" run it in that working precision
(`reference.working_precision`); "guarantee" breaks one guarantee the
configuration states, as a cheaper program would (the GICP covariances
left out; a third of each phase's iterations).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

import generators as gen
import reference as ref

PRECISIONS = ("float32", "tf32")


def _mod(name: str):
    import importlib

    return importlib.import_module(name)


def _icp_config(d: dict):
    return _mod("icpx_torch.registration.icp").ICPConfig(**d)


def _se3_np(R: torch.Tensor, t: torch.Tensor) -> np.ndarray:
    return ref.se3(R.detach().double().cpu().numpy(), t.detach().double().cpu().numpy())


def _worst(numbers: Dict[str, float], name: str, value: float) -> None:
    numbers[name] = max(numbers.get(name, 0.0), value if math.isfinite(value) else float("inf"))


def _settings(icp: dict, **over) -> ref.Settings:
    """The reference's settings from the configuration's ICP block."""
    keep = {f.name for f in dataclasses.fields(ref.Settings)}
    d = {k: v for k, v in icp.items() if k in keep}
    d.update(over)
    return ref.Settings(**d)


def _precision(control: Optional[str]) -> str:
    return control if control in PRECISIONS else "float64"


class Entry:
    """What every entry has: its configuration, traffic, seed and device,
    the program's ICP settings (`configure`), and the comparison of the
    sampled answers with the reference's."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self._answers: Dict[object, ref.Answer] = {}

    def configure(self, **over) -> None:
        """The program's ICP settings, with `over` on top (a control's)."""
        self.icp = {**self.config["icp"], **self.traffic.get("icp", {}), **over}
        self.cfg = _icp_config(self.icp)

    def warm(self) -> None:
        for j in range(int(self.traffic.get("warm_requests", 1))):
            self.request(j)

    def kernel_work(self, record: dict) -> dict:
        """Work of a finished request that per-layer metrics count."""
        return {}

    def summary(self, records: List[dict]) -> Dict[str, float]:
        """Accuracy against the simulator's truth, for the run's file."""
        return {}

    def release(self) -> None:
        """Drop the program's inputs on the device before the reference runs."""

    def answer(self, key, control: Optional[str] = None) -> ref.Answer:
        """The reference's answer for `key` (cached), or a control's."""
        if control is not None:
            with ref.working_precision(_precision(control)):
                return self.reference(key, control)
        if key not in self._answers:
            self._answers[key] = self.reference(key, None)
        return self._answers[key]

    def check(self, sample: List[dict], control: Optional[str] = None) -> Dict[str, float]:
        """The worst gaps between the sampled answers (or the control's
        answers in their place) and the reference's, and the root mean
        square of the translation gaps over them (`t_gap_rms_m`): a single
        answer that stops a few iterations off the reference's moves it by
        its gap over the square root of the sample's size, an answer
        altered where it is produced by as much."""
        numbers: Dict[str, float] = {}
        t_gaps = []
        for key, T, rmse in self.answers(sample):
            want = self.answer(key)
            if control is not None:
                got = self.answer(key, control)
                T, rmse = got.T, got.rmse
            rot, t = ref.gap(T, want.T)
            _worst(numbers, "rot_gap_rad", rot)
            _worst(numbers, "t_gap_m", t)
            _worst(numbers, "rmse_gap_m", abs(rmse - want.rmse))
            t_gaps.append(t if math.isfinite(t) else float("inf"))
        if t_gaps:
            numbers["t_gap_rms_m"] = math.sqrt(sum(t * t for t in t_gaps) / len(t_gaps))
        return numbers

    def _draw(self, items: list) -> list:
        """`check_answers` of `items`, drawn from the seed, in order."""
        rng = np.random.default_rng(gen.sub_seed(self.seed, 4))
        k = min(int(self.traffic.get("check_answers", 1)), len(items))
        return [items[int(a)] for a in sorted(rng.choice(len(items), size=k, replace=False))]


# ---- ground-truth pairs ------------------------------------------------------------------


def pool_gt(rule: dict, i: int) -> dict:
    """Pool pair i's ground truth, as bench.py's --batch pairs take it:
    angle + angle_step (i mod angle_cycle) about `axis`, the translation's
    y + t_y_step (i mod t_y_cycle)."""
    t = list(rule["translation"])
    t[1] += rule.get("t_y_step", 0.0) * (i % int(rule.get("t_y_cycle", 1)))
    angle = rule["angle"] + rule.get("angle_step", 0.0) * (i % int(rule.get("angle_cycle", 1)))
    return dict(axis=rule["axis"], angle=angle, translation=t)


class PairStream(Entry):
    """Closed loop of `register()` calls over a pool of ground-truth pairs."""

    def setup(self) -> None:
        c = self.config
        PointCloud = _mod("icpx_torch.cloud").PointCloud
        self.configure()
        n = int(c["points"])
        self.pool = []
        for i in range(int(self.traffic["pool"])):
            src, tgt, _, R, t = gen.gt_pair(n, gen.sub_seed(self.seed, 1, i),
                                            gen.sub_seed(self.seed, 2, i), **pool_gt(c["gt"], i))
            self.pool.append(dict(
                src_np=src, tgt_np=tgt, gt=ref.se3(R, t),
                src=PointCloud.create(src, capacity=n, device=self.device),
                tgt=PointCloud.create(tgt, capacity=n, device=self.device)))
        self.order = np.random.default_rng(gen.sub_seed(self.seed, 3)).permutation(len(self.pool))

    def request(self, j: int) -> dict:
        i = int(self.order[j % len(self.pool)])
        p = self.pool[i]
        res = _mod("icpx_torch.registration.icp").register(p["src"], p["tgt"], self.cfg)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return dict(pool=i, R=res.transform.R, t=res.transform.t, rmse=res.final_rmse,
                    iters=int(res.iters), work=int(self.config["points"]))

    def judge(self, rec: dict) -> bool:
        rot, t = ref.gap(_se3_np(rec["R"], rec["t"]), self.pool[rec["pool"]]["gt"])
        g = self.config["gate"]
        return bool(rot < g["rot"] and t < g["t"] and math.isfinite(float(rec["rmse"])))

    def summary(self, records: List[dict]) -> Dict[str, float]:
        gaps = [ref.gap(_se3_np(r["R"], r["t"]), self.pool[r["pool"]]["gt"]) for r in records]
        return {"gt_rot_err_max_rad": max(g[0] for g in gaps),
                "gt_t_err_max_m": max(g[1] for g in gaps)}

    def release(self) -> None:
        for p in self.pool:
            p.pop("src", None)
            p.pop("tgt", None)

    def reference(self, i: int, control: Optional[str]) -> ref.Answer:
        """The reference's answer for pool pair i; "guarantee" leaves the
        covariances out (identity), as a cheaper GICP would."""
        p, c = self.pool[i], self.config
        n = p["src_np"].shape[0]
        v = np.ones(n, bool)
        k = max(int(c["icp"].get("k_normals", 10)), 15)
        if control == "guarantee":
            eye = torch.eye(3, dtype=ref.REAL, device=self.device).expand(n, 3, 3).contiguous()
            cs = ct = eye
        else:
            cs = ref.gicp_covariances(p["src_np"], v, k, self.device)
            ct = ref.gicp_covariances(p["tgt_np"], v, k, self.device)
        s = _settings(c["icp"], coarse_iters=c["icp"].get("coarse_iters", 2),
                      coarse_stride=c["icp"].get("coarse_stride", 4))
        return ref.register(p["src_np"], v, cs, p["tgt_np"], v, ct, s, self.device)

    def sample(self, records: List[dict]) -> List[dict]:
        return self._draw(records)

    def answers(self, sample: List[dict]) -> list:
        return [(r["pool"], _se3_np(r["R"], r["t"]), float(r["rmse"])) for r in sample]


# ---- LiDAR sequences ---------------------------------------------------------------------


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


ENTRIES = {"register": PairStream, "register_batch": PairBatches}

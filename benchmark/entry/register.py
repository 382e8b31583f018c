"""Entry "register": back-to-back `registration.icp.register` calls over a
pool of ground-truth pairs (config kind "gt_pairs"), each pool pair with its
own ground truth; work = the source's points; gate = rotation and
translation within the configured bounds of the ground truth."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

import generators as gen
import reference as ref
from entries import Entry, _mod, _se3_np, _settings, pool_gt


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


ENTRY = PairStream

#!/usr/bin/env python3
"""NDT "p2d" error against the source covariance point_cov, on one card.

    python3 scripts/torch_ndt_point_cov.py [--n 524288 1048576] [--point-cov 1e-4 1e-6]
        [--device cuda]

For each n and point_cov: `register_ndt` of chip_smoke.py's `_gt_pair`
(a synthetic surface and its image under 0.2 rad about z and (0.12,
-0.06, 0.03), shuffled) at cells of 64 with chip_smoke.py's NDT config,
the source's covariance point_cov * I. Prints the iterations, the rotation
and translation errors against the GT and whether they pass the reference's
NDT gate (rot < 5e-3, t < 2e-2). `python tests/test_torch_pyramid_ndt.py N
POINT_COV` runs the same on the CPU in both packages.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from chip_smoke import _gt_pair  # noqa: E402
from icpx_torch.registration.icp import ICPConfig  # noqa: E402
from icpx_torch.registration.ndt import register_ndt  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[524288, 1048576])
    ap.add_argument("--point-cov", type=float, nargs="+", default=[1e-4, 1e-6])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    cfg = ICPConfig(max_iters=30, diff_threshold=0.0, rmse_change_tol=1e-6, robust="huber")
    for n in args.n:
        src, tgt, gt = _gt_pair(n, 0, dev)
        for cov in args.point_cov:
            res = register_ndt(src, tgt, cfg, cell_size=64, mode="p2d", point_cov=cov)
            rot, t = (float(x) for x in res.transform.distance_to(gt))
            gate = "pass" if rot < 5e-3 and t < 2e-2 else "miss"
            print(f"ndt p2d n={n} point_cov={cov:g}: iters={res.iters} rot={rot:.4e} t={t:.4e} "
                  f"({gate}; {dev})", flush=True)


if __name__ == "__main__":
    main()

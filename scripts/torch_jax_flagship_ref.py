#!/usr/bin/env python3
"""The JAX package's result on bench.py's flagship pair, on the CPU.

    python scripts/torch_jax_flagship_ref.py [--n 1048576] [--out tests/data/jax_flagship_1m.json]

Builds `bench.py`'s pair (lines 148-170: `synthetic_surface(n, seed=0)`, its
image under 0.2 rad about z and (0.12, -0.06, 0.03), the target's rows
permuted by `default_rng(1)`) and registers it with the JAX package's
`_register_jit` under bench.py's config, normals estimated in-jit on the
block path (`normals_for=("src", "tgt")`) and `score_precision="highest"`
(the port resolves "auto" to it). Off the TPU the JAX package takes its
XLA paths, so no Pallas kernel runs in interpret mode. Writes one JSON
object: the coarse and refine iterations, R, t, the final rmse and the
rmse history (null past the last iteration), the GT errors, the seconds
the run took and the JAX version.
`chip_smoke.py` holds the port's flagship under "auto" and "gather" to it.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from icpx.cloud import PointCloud  # noqa: E402
from icpx.geometry.se3 import SE3  # noqa: E402
from icpx.geometry.transforms import make_rigid_perturbation  # noqa: E402
from icpx.io.loaders import synthetic_surface  # noqa: E402
from icpx.registration.icp import ICPConfig, _register_jit  # noqa: E402


def flagship_config():
    """bench.py's flagship config at its defaults, "highest" scores."""
    return ICPConfig(objective="symmetric", max_iters=10, diff_threshold=0.0, rmse_change_tol=1e-6,
                     k_normals=10, score_precision="highest", nn_method="auto", tile_q=2048,
                     tile_r=8192)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1048576)
    ap.add_argument("--out", default=os.path.join("tests", "data", "jax_flagship_1m.json"))
    args = ap.parse_args()
    n = args.n
    src = PointCloud.create(synthetic_surface(n, seed=0), capacity=n if n % 128 == 0 else None)
    gt = make_rigid_perturbation(angle=0.2, translation=(0.12, -0.06, 0.03))
    tgt_np = np.asarray(gt.apply(src.xyz))[: src.capacity]
    perm = np.random.default_rng(1).permutation(src.capacity)
    tgt = PointCloud.create(tgt_np[perm], capacity=src.capacity).replace(mask=src.mask[perm])
    cfg = flagship_config()
    if cfg.resolve_nn(src.capacity) != "block":
        raise SystemExit(f"n={n} is below the block path's threshold")

    def run(sx, sm, tx, tm):
        res = _register_jit(PointCloud(xyz=sx, mask=sm), PointCloud(xyz=tx, mask=tm),
                            SE3.identity(), cfg, normals_for=("src", "tgt"))
        return res.transform.R, res.transform.t, res.iters, res.final_rmse, res.rmse_history

    t0 = time.perf_counter()
    R, t, iters, rmse, hist = jax.block_until_ready(
        jax.jit(run)(src.xyz, src.mask, tgt.xyz, tgt.mask))
    secs = time.perf_counter() - t0
    hist = np.asarray(hist)
    refine = int(np.isfinite(hist).sum())
    rot_err, t_err = (float(x) for x in SE3(R=R, t=t).distance_to(gt))
    out = {
        "n": n, "seed": 0, "angle": 0.2, "translation": [0.12, -0.06, 0.03], "permutation_seed": 1,
        "config": {"objective": cfg.objective, "max_iters": cfg.max_iters,
                   "diff_threshold": cfg.diff_threshold, "rmse_change_tol": cfg.rmse_change_tol,
                   "k_normals": cfg.k_normals, "score_precision": cfg.score_precision,
                   "tile_q": cfg.tile_q, "tile_r": cfg.tile_r, "normals_for": ["src", "tgt"]},
        "iters": int(iters), "coarse_iters": int(iters) - refine, "refine_iters": refine,
        "R": np.asarray(R, np.float64).tolist(), "t": np.asarray(t, np.float64).tolist(),
        "final_rmse": float(rmse),
        "rmse_history": [float(x) if np.isfinite(x) else None for x in hist],
        "rot_err": rot_err, "t_err": t_err, "seconds": secs, "platform": jax.devices()[0].platform,
        "jax_version": jax.__version__, "numpy_version": np.__version__,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: out[k] for k in ("n", "iters", "coarse_iters", "refine_iters",
                                          "final_rmse", "rot_err", "t_err", "seconds")}))


if __name__ == "__main__":
    main()

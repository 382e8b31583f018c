#!/usr/bin/env python3
"""The compiled odometry's ladders on the card: `run_odometry_compiled` on
bench.py's odometry sequence (`--frames` scans of `--n` points, normals
k = 10, velocity_damping 0.7) under every combination of refine stride
(1, 2, 4), frozen candidates (on, off) and source q-tile (128, 256).

    python3 scripts/torch_odo_ladder.py [--n 65536] [--frames 20] [--reps 3]
        [--out rows.json]

Each combination: one warm run, then `--reps` timed runs (host wall with a
`torch.cuda.synchronize()` fence; median), frames/s, ms a frame, ATE
(unaligned, bench.py's gate 0.5 m) and keyframes. The "auto" row is the
reference's ladder as `resolve_odo_*` gives it. Prints one line a
combination, then the card's name and power limit, and with `--out` writes
every row as JSON there. Needs a CUDA device.
"""

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", help="write every row as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import chip_smoke
    from icpx_torch.odometry.compiled import (resolve_odo_freeze, resolve_odo_q_tile,
                                              resolve_odo_refine_stride, run_odometry_compiled)
    from icpx_torch.odometry.evaluate import ate_rmse

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cfg = chip_smoke._odo_config()
    scans, gt = chip_smoke._odo_sequence(args.n, args.frames, dev)
    fx = chip_smoke._stacked(scans)
    auto = (resolve_odo_refine_stride(cfg, args.n), resolve_odo_freeze(args.n),
            resolve_odo_q_tile(cfg, args.n))
    rows = []
    for stride, freeze, q_tile in itertools.product((1, 2, 4), (True, False), (128, 256)):
        kw = dict(velocity_damping=0.7, refine_stride=stride, freeze_candidates=freeze,
                  q_tile=q_tile)
        res = run_odometry_compiled(*fx, cfg, **kw)
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            res = run_odometry_compiled(*fx, cfg, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        wall = statistics.median(times)
        ate = ate_rmse(chip_smoke._pose_list(res.poses), gt, align=False)
        row = dict(refine_stride=stride, freeze=freeze, q_tile=q_tile,
                   auto=(stride, freeze, q_tile) == auto, wall_ms=wall * 1e3,
                   walls_ms=[t * 1e3 for t in times], frames_per_s=args.frames / wall,
                   ms_a_frame=wall * 1e3 / args.frames, ate_m=ate,
                   keyframes=int(res.is_keyframe.sum()), iters=res.iters.tolist())
        rows.append(row)
        print(f"stride {stride} freeze {'on ' if freeze else 'off'} q_tile {q_tile}"
              f"{' (auto)' if row['auto'] else '       '}: {row['frames_per_s']:.2f} frames/s, "
              f"{row['ms_a_frame']:.3f} ms a frame (median of {args.reps}: "
              f"{', '.join(f'{t:.1f}' for t in row['walls_ms'])} ms), ATE {ate:.4f} m, "
              f"{row['keyframes']} keyframes, {sum(row['iters'])} ICP iterations", flush=True)
    print(smi)
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"card": smi, "n": args.n, "frames": args.frames, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()

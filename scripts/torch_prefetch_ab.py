#!/usr/bin/env python3
"""Does `prefetch_kitti` hide scan loads on the card? bench.py's odometry
sequence (`--frames` scans of `--n` points) written as a KITTI velodyne
directory, then read four ways, each `--rounds` times in ABBA order:

* load: every scan loaded onto the card, serially / through
  `prefetch_kitti` (3 loads in flight);
* load + register: the same, each scan registered onto the one before it
  as it arrives (`register()` with the odometry config, normals
  estimated inside; the block path at 65,536 points), so the prefetcher's
  threads can load while the card registers.

    python3 scripts/torch_prefetch_ab.py [--n 65536] [--frames 20] [--rounds 5]
        [--out prefetch_ab.json]

Prints each way's median wall (host clock between synchronize fences) and
every reading, then the card's name and power limit; with `--out` writes
them as JSON there. Needs a CUDA device.
"""

import argparse
import json
import shutil
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
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", help="write the readings as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")

    import chip_smoke
    from icpx_torch.cloud import PointCloud, round_up
    from icpx_torch.io import prefetch_kitti
    from icpx_torch.odometry.kitti import load_kitti_scan, write_kitti_sequence
    from icpx_torch.registration.icp import register

    dev = torch.device("cuda", 0)
    vel = ROOT / "tests" / "_artifacts" / "prefetch_ab"
    shutil.rmtree(vel, ignore_errors=True)
    scans, gt = chip_smoke._odo_sequence(args.n, args.frames, dev)
    write_kitti_sequence(vel, scans, gt)
    del scans
    paths = sorted(vel.glob("*.bin"))
    cap = round_up(max(p.stat().st_size // 16 for p in paths))
    cfg = chip_smoke._odo_config()

    def serial():
        for p in paths:
            yield PointCloud.create(load_kitti_scan(p)[:cap], capacity=cap, device=dev)

    def prefetched():
        return iter(prefetch_kitti(vel, capacity=cap, depth=3, device=dev))

    def load(source):
        return lambda: list(source())

    def load_register(source):
        def run():
            prev = None
            for cloud in source():
                if prev is not None:
                    register(cloud, prev, cfg)
                prev = cloud
        return run

    ways = {"load serial": load(serial), "load prefetch": load(prefetched),
            "load + register serial": load_register(serial),
            "load + register prefetch": load_register(prefetched)}
    for run in ways.values():  # warm: each way's first call is cold
        run()
        torch.cuda.synchronize()
    walls = {name: [] for name in ways}
    order = list(ways)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ways[name]()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    for name, w in walls.items():
        print(f"{name}: median {statistics.median(w):.2f} ms ({args.frames} scans of {cap} rows); "
              f"readings {[round(x, 2) for x in w]}")
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": smi, "rows": cap, "frames": args.frames,
                                              "walls_ms": walls}, indent=1))
    shutil.rmtree(vel, ignore_errors=True)


if __name__ == "__main__":
    main()

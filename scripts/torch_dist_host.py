#!/usr/bin/env python3
"""Where the distributed layer's host time goes, at one NCCL rank on the card.

    python3 scripts/torch_dist_host.py [--out dist_host.json]

Prints, and writes as JSON:

* each collective of `icpx_torch.distributed.comm` at the sizes an ICP
  iteration gives it (a 7-float psum, the 42-float normal equations, a
  128-bin histogram, the 1 MB a ring shift of 65,536 rows carries is not
  posted at one rank): host microseconds a call (host clock around 200
  calls, then a synchronize) and device microseconds a call (CUDA events);
* one `sharded_register_pairs` call on the first pair of bench.py
  --odometry's 65,536-point sequence, with `parallel_odometry`'s config
  (max_iters 30, huber with the histogram MAD scale), under torch.profiler
  (CPU and CUDA): its wall, device time and busy share, the nn kernel's
  time a call, and the ops with the most host time;
* the same pair through `register_batch` (no collectives, exact quantiles)
  for the host time a plain iteration takes.

Needs a CUDA device; refuses to run without one.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _host_and_device_us(fn, calls=200):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host, a.elapsed_time(b) / calls * 1e3


def main(out=None):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    import subprocess

    import torch.distributed as dist

    import chip_smoke
    from icpx_torch.distributed import comm
    from icpx_torch.distributed.mesh import make_mesh
    from icpx_torch.distributed.sharded_icp import sharded_register_pairs
    from icpx_torch.kernels import cuda_build
    from icpx_torch.kernels.normals import estimate_normals
    from icpx_torch.registration.icp import register_batch
    from icpx_torch.utils.profiling import LAUNCHES

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    cuda_build.compile_all(["nn"])
    tmp = tempfile.mkdtemp(prefix="icpx_dist_host_")
    chip_smoke._dist_open(0, 1, tmp, "nccl")
    report = {"card": card, "torch": torch.__version__}
    try:
        mesh = make_mesh((1, 1), ("pairs", "points"))
        g = mesh.get_group("points")
        coll = {}
        for label, x in (("psum 7 floats", (torch.zeros((), device=dev), torch.zeros(3, device=dev),
                                            torch.zeros(3, device=dev))),
                         ("psum 42 floats", (torch.zeros(6, 6, device=dev), torch.zeros(6, device=dev))),
                         ("psum 128 floats", torch.zeros(128, device=dev)),
                         ("psum 144 MB", torch.zeros(1000, 1000, 6, 6, device=dev))):
            calls = 20 if label.endswith("MB") else 200
            coll[label] = _host_and_device_us(lambda x=x: comm.psum(x, g), calls)
        coll["all_to_all 262,144 x 3"] = _host_and_device_us(
            lambda: comm.all_to_all(torch.zeros(1, 262144, 3, device=dev), g), 50)
        coll["bare all_reduce 4 B"] = _host_and_device_us(
            lambda: dist.all_reduce(torch.zeros(1, device=dev), group=g))
        for k, (h, d) in coll.items():
            print(f"{k}: host {h:.1f} us a call, device {d:.1f} us a call")
        report["collectives_us"] = {k: {"host": h, "device": d} for k, (h, d) in coll.items()}

        scans, _ = chip_smoke._odo_sequence(65536, 2, dev)
        s, t = (estimate_normals(f, k=10) for f in (scans[1], scans[0]))
        args = [x[None] for c in (s, t) for x in (c.xyz, c.mask, c.normals)]
        cfg = dataclasses.replace(chip_smoke._odo_config(), max_iters=30)
        runs = {"sharded_register_pairs": lambda: sharded_register_pairs(*args, cfg, mesh),
                "register_batch": lambda: register_batch(*args, cfg)}
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        report["pair"] = {}
        for label, run in runs.items():
            wall, res = chip_smoke._sync_time(run, reps=3)
            before = LAUNCHES["nn"]
            with torch.profiler.profile(activities=acts) as prof:
                run()
                torch.cuda.synchronize()
            launches = LAUNCHES["nn"] - before
            avgs = prof.key_averages()
            kern = [e for e in avgs if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                    and chip_smoke._device_us(e) > 0]
            busy = sum(chip_smoke._device_us(e) for e in kern) / 1e3
            nn_ms = sum(chip_smoke._device_us(e) for e in kern if "nn_search" in e.key) / 1e3
            cpu = sorted((e for e in avgs if e.key.startswith(("aten::", "c10d::", "nccl", "cuda"))),
                         key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
            iters = int(res.iters[0])
            row = {"wall_ms": wall * 1e3, "iters": iters, "device_ms": busy,
                   "busy_share": busy / (wall * 1e3), "nn_ms_a_call": nn_ms / max(launches, 1),
                   "host_ms_an_iteration": (wall * 1e3 - busy) / max(iters, 1),
                   "top_host_ops_ms": {e.key: e.self_cpu_time_total / 1e3 for e in cpu}}
            report["pair"][label] = row
            print(f"{label}: wall {wall * 1e3:.2f} ms, {iters} iterations, device {busy:.2f} ms "
                  f"({100 * row['busy_share']:.1f}% busy), nn {row['nn_ms_a_call']:.3f} ms a call; "
                  "most host time: " + ", ".join(f"{k} {v:.2f} ms" for k, v in
                                                 row["top_host_ops_ms"].items()))
    finally:
        dist.destroy_process_group()
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the report as JSON here")
    main(ap.parse_args().out)

#!/usr/bin/env python3
"""Repeats and walls of the pose graphs and place descriptors, two checkouts
of the port on one card.

    python3 scripts/torch_repeat_ab.py PARENT CHANGE [--pairs 4] [--out FILE]

starts one worker process per checkout (`--worker ROOT`), each importing
`icpx_torch` from its ROOT, and asks them for readings in turn, in ABBA
order (parent, change, change, parent, ...). A reading runs each item once
and gives its wall (host clock around torch.cuda.synchronize() fences) and
its output; the items are chip_smoke.py's 1,000-keyframe chain
(`_pose_chain`) through `optimize_pose_graph` and
`optimize_pose_graph_sparse` (8 iterations each) and `place_descriptor` on
a batch of bench.py --odometry's first 20 scans of 65,536 points. For each
side and item it prints the median wall and how many of its outputs equal
the side's first bit for bit, with the largest |difference| of any leaf
from the first; and one JSON line with all of it (also written to FILE).
The inputs are chip_smoke.py's, from the checkout that holds this script.
"""

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke():
    """This checkout's chip_smoke.py under its own module name."""
    spec = importlib.util.spec_from_file_location("ab_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def worker(root: str, tmp: str) -> None:
    """Answers each "reading" line on stdin with one JSON line on stdout:
    {item: [wall ms, path of its output's tensor leaves, saved under tmp]}."""
    proto, sys.stdout = sys.stdout, sys.stderr
    sys.path.insert(0, root)
    import icpx_torch

    if not icpx_torch.__file__.startswith(os.path.join(root, "icpx_torch")):
        raise SystemExit(f"imported {icpx_torch.__file__}, not the package under {root}")
    from icpx_torch.odometry.placerec import place_descriptor
    from icpx_torch.odometry.posegraph import optimize_pose_graph, optimize_pose_graph_sparse

    smoke = _load_smoke()
    dev = torch.device("cuda", 0)
    graph, _ = smoke._pose_chain(smoke.N_GRAPH, dev)
    scans, _ = smoke._odo_sequence(smoke.N_ODO, smoke.ODO_FRAMES, dev)
    xyz, mask = torch.stack([f.xyz for f in scans]), torch.stack([f.mask for f in scans])
    items = {"dense 1000": lambda: optimize_pose_graph(graph, iters=8),
             "pcg 1000": lambda: optimize_pose_graph_sparse(graph, iters=8),
             f"place_descriptor {len(scans)} x {smoke.N_ODO}": lambda: place_descriptor(xyz, mask)}
    for fn in items.values():  # warm
        fn()
    torch.cuda.synchronize()
    print(json.dumps("ready"), file=proto, flush=True)
    for count, line in enumerate(sys.stdin):
        out = {}
        for name, fn in items.items():
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            leaves = [(p, v.cpu()) for p, v in smoke._leaves(res) if torch.is_tensor(v)]
            path = os.path.join(tmp, f"{name.split()[0]}_{count}.pt")
            torch.save(leaves, path)
            out[name] = [wall, path]
        print(json.dumps(out), file=proto, flush=True)


def _ask(proc, what=None):
    if what is not None:
        proc.stdin.write(what + "\n")
        proc.stdin.flush()
    line = proc.stdout.readline()
    if not line:
        raise SystemExit(f"a worker ended (exit code {proc.wait()})")
    return json.loads(line)


def _repeats(paths):
    """(outputs equal to the first bit for bit, largest |leaf - first's|)."""
    first = torch.load(paths[0])
    same, worst = 1, 0.0
    for p in paths[1:]:
        other = torch.load(p)
        equal = all(np.array_equal(a.numpy().view(np.uint8), b.numpy().view(np.uint8))
                    for (_, a), (_, b) in zip(first, other))
        same += equal
        for (_, a), (_, b) in zip(first, other):
            if a.is_floating_point():
                worst = max(worst, float((a.double() - b.double()).abs().nan_to_num(0.0).max()))
    return same, worst


def main(parent: str, change: str, pairs: int, out_path) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    roots = {"parent": os.path.abspath(parent), "change": os.path.abspath(change)}
    tmp = tempfile.mkdtemp(prefix="repeat_ab_")
    for side in roots:
        os.makedirs(os.path.join(tmp, side))
    procs = {side: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", root,
                                     "--tmp", os.path.join(tmp, side)],
                                    stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
             for side, root in roots.items()}
    readings = {side: [] for side in roots}
    try:
        for proc in procs.values():
            _ask(proc)  # ready: imported, inputs on the card, every item warm
        for i in range(pairs):
            for side in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
                readings[side].append(_ask(procs[side], "reading"))
    finally:
        for proc in procs.values():
            proc.stdin.close()
        for proc in procs.values():
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    result = {"card": card, "roots": roots, "pairs": pairs, "items": {}}
    print(card)
    try:
        for side in roots:
            for name in readings[side][0]:
                walls = [r[name][0] for r in readings[side]]
                same, worst = _repeats([r[name][1] for r in readings[side]])
                result["items"].setdefault(name, {})[side] = {
                    "wall_ms": walls, "median_ms": statistics.median(walls),
                    "bit_equal_to_first": same, "max_abs_diff": worst}
                print(f"{side} {name}: median {statistics.median(walls):.3f} ms (min "
                      f"{min(walls):.3f}, max {max(walls):.3f}); {same} of {len(walls)} outputs "
                      f"bit-equal to the first, largest |difference| {worst:.3e}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = json.dumps(result)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*", help="PARENT CHANGE")
    ap.add_argument("--worker", metavar="ROOT")
    ap.add_argument("--tmp", help="a worker's directory for its outputs")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.worker:
        worker(os.path.abspath(args.worker), args.tmp)
    elif len(args.roots) == 2:
        main(*args.roots, args.pairs, args.out)
    else:
        ap.error("give PARENT and CHANGE, or --worker ROOT")

"""Every host sync of one request of a benchmark cell, by where it happens.

    python3 scripts/torch_sync_scan.py [--workloads W ...] [--seed N] [--out FILE]

from the repo root, on a machine with an NVIDIA GPU. For each cell of
`BENCHMARK.json` it makes the cell's inputs (the benchmark's own entry,
`benchmark/entry/<name>.py` through `entries.load`), warms it as the
harness does, and runs one more request under `torch.cuda.set_sync_debug_mode("warn")` and a CPU
`torch.profiler`. Each sync warning (other warnings are left out) is put
down to the innermost frame of `icpx_torch` that made it, and counted as
one of:

  * "fetch": inside `profiling.fetch` / `profiling.fetch_int`, so the trace
    holds it as an `icpx.fetch` span;
  * "harness": a read the entry itself makes, outside `icpx_torch`;
  * "other": anywhere else (a host-to-device copy from pageable memory, a
    read torch makes inside an op), listed by site.

The request's `icpx.fetch` and `icpx.iter` spans are counted beside its
summed ICP iterations. Prints one JSON line a cell; `--out` writes them all.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import warnings
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmark"))

import entries  # noqa: E402
import harness  # noqa: E402

FETCHERS = ("fetch", "fetch_int")
SYNC = "synchronizing CUDA operation"  # in the text of torch's sync debug warning


def _harness(filename: str) -> bool:
    """A file of the benchmark's entries: `entries.py` or `entry/<name>.py`."""
    path = Path(filename)
    return path.name == "entries.py" or (path.parent.name == "entry"
                                         and path.parent.parent.name == "benchmark")


def _site(stack) -> tuple:
    """(kind, the innermost icpx_torch frame, its icpx_torch callers); the
    innermost frames of any file where no icpx_torch frame is on the stack."""
    ours = [f for f in stack if "icpx_torch" in f.filename]
    if any(f.name in FETCHERS and f.filename.endswith("profiling.py") for f in ours):
        kind = "fetch"
    elif not ours and any(_harness(f.filename) for f in stack):
        kind = "harness"
    else:
        kind = "other"
    where = [f"{Path(f.filename).name}:{f.lineno} {f.name}" for f in reversed(ours or stack)]
    return kind, where[0] if where else "no Python frame", " < ".join(where[1:4])


def scan(workload: str, seed: int, dev) -> dict:
    cell = harness.Cell(ROOT, workload)
    entry = entries.load(cell.traffic["entry"])(cell.config, cell.traffic, seed, dev)
    entry.setup()
    entry.warm()
    torch.cuda.synchronize(dev)
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC in str(message):  # not the profiler's or the switch's own notices
            seen.append(_site(traceback.extract_stack()[:-1]))

    warnings.simplefilter("always")
    old = warnings.showwarning
    warnings.showwarning = show
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rec = entry.request(int(cell.traffic.get("warm_requests", 1)))
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = old
    wall = time.perf_counter() - t0
    spans = Counter()
    for e in prof.key_averages():
        if e.key.startswith("icpx."):
            spans[e.key] = e.count
    kinds = Counter(k for k, _, _ in seen)
    other = Counter((w, c) for k, w, c in seen if k == "other")
    fetch_sites = Counter(w for k, w, _ in seen if k == "fetch")
    return {"workload": workload, "seed": seed, "card": torch.cuda.get_device_name(dev),
            "request_s": wall, "iters": int(torch.as_tensor(rec["iters"]).sum()),
            "work": rec["work"], "syncs": dict(kinds), "spans": dict(spans),
            "fetch_sites": dict(fetch_sites),
            "other_sites": [{"site": w, "callers": c, "count": n}
                            for (w, c), n in other.most_common()]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", nargs="*", default=None)
    ap.add_argument("--seed", type=int, default=2147483659)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = args.workloads or [w["name"] for w in spec["workloads"]]
    dev = torch.device("cuda", 0)
    lines = []
    for name in names:
        out = scan(name, args.seed, dev)
        print(json.dumps(out), flush=True)
        lines.append(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())

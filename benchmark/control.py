"""Readings that set a cell's limits: the program's compared numbers over
many seeds, and the controls'.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--controls program-tf32,reference-tf32,...]

For each seed it makes the cell's inputs, runs the timed path's requests
(one request for each distinct input the window cycles over, after the
warm ones) and compares the same sample of answers a run compares with the
plain reference. For each control seed it does the same for every control
named in `--controls` (default: all of `CONTROLS`), each against the same
reference answers:

* "program-tf32": the program with torch's TF32 matrix products switched
  on (the port switches them off when it is imported);
* "program-<key>=<value>": the program with that ICP setting, e.g.
  "program-score_precision=bf16", "program-payload_mode=vmem7" (the
  bf16-scored fold);
* "reference-float32", "reference-tf32": the reference in the program's
  place, in that working precision;
* "reference-guarantee": the reference with one stated guarantee broken
  (the entry's `reference`, `benchmark/entry/<entry>.py`).

One JSON line a seed and reading. Needs a CUDA card; the benchmark's runs
do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import torch  # noqa: E402

import harness  # noqa: E402

CONTROLS = ("program-tf32", "reference-float32", "reference-tf32", "reference-guarantee")


def _value(text: str):
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def _program(entry, name: str, requests: int) -> list:
    """The program's records under `name` ("program" or a program-*
    control), `requests` of them after the warm ones."""
    over, tf32 = {}, False
    if name == "program-tf32":
        tf32 = True
    elif name != "program":
        key, value = name[len("program-"):].split("=", 1)
        over[key] = _value(value)
    entry.configure(**over)
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        entry.warm()
        warm = int(entry.traffic.get("warm_requests", 1))
        records = []
        for j in range(requests):
            r = entry.request(warm + j)
            r["index"] = j
            records.append(r)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
        entry.configure()
    return records


def readings(cell, seed: int, device, names, requests: int):
    """One reading a name: the compared numbers of that program or control."""
    import entries

    entry = entries.load(cell.traffic["entry"])(cell.config, cell.traffic, seed, device)
    entry.setup()
    runs = {n: _program(entry, n, requests) for n in names if n.startswith("program")}
    judged = {n: sum(not entry.judge(r) for r in recs) for n, recs in runs.items()}
    summary = {n: entry.summary(recs) for n, recs in runs.items()}
    entry.release()
    torch.cuda.empty_cache()
    # every reading compares the same sample (the program's)
    sample = entry.sample(runs["program"])
    out = []
    for n in names:
        t0 = time.perf_counter()
        if n.startswith("program"):
            numbers = entry.check(entry.sample(runs[n]))
        else:
            numbers = entry.check(sample, control=n[len("reference-"):])
        out.append({"seed": seed, "reading": n, "numbers": numbers,
                    "gate_failures": judged.get(n), "summary": summary.get(n),
                    "seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default=",".join(CONTROLS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card; found none", file=sys.stderr)
        return 2
    cell = harness.Cell(HERE.parent, args.workload)
    device = torch.device("cuda", 0)
    t = cell.traffic
    # one request for each distinct input the window cycles over
    requests = int(t.get("pool", len(t.get("starts", [0]))))
    controls = [c for c in args.controls.split(",") if c]
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        for r in readings(cell, seed, device, ["program"], requests):
            print(json.dumps(r), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        for r in readings(cell, seed, device, ["program"] + controls, requests):
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Sets of runs of a cell, one process at a time, and the spreads that set
its bounds.

    python3 benchmark/sets.py --workload <name> [--workload ...] \
        --seeds s1,...,s6 [--sets 2] [--seconds 51] [--extra-seconds 30] \
        [--traced t1,t2,t3] --out <dir>

For each workload, set and seed it runs `benchmark/run.py` once at
`--seconds`, and in the first set also at each `--extra-seconds` length
(interleaved seed by seed, so the lengths share the host's conditions),
then each `--traced` seed once with `--trace 1` at `--seconds`. Each
run's standard output and error go to
`<out>/<workload>.<set>.<seconds>.<seed>.{out,err}`; it prints the card's
name, power limit, power draw, SM clock and temperature before and after
the window (from the run's own file). For each set and length it prints each
end-to-end metric's median and spread (the distance between the first and
third quartile, `statistics.quantiles(n=4)`, over the median), the
spread with the set's run farthest from the median left out, and over all
sets the pooled spread; last, one JSON line with all of it. The
benchmark's own runs do not run this.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values):
    """The spread with the run farthest from the median left out."""
    if len(values) < 3:
        return None
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def run_one(workload, seed, seconds, trace, out: Path, tag: str) -> dict:
    base = out / f"{workload}.{tag}.{seconds}.{seed}"
    cmd = [sys.executable, str(HERE / "run.py"), "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    with open(f"{base}.out", "w") as fo, open(f"{base}.err", "w") as fe:
        rc = subprocess.run(cmd, stdout=fo, stderr=fe, cwd=HERE.parent).returncode
    wall = time.perf_counter() - t0
    lines = Path(f"{base}.out").read_text().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    card = None
    run_file = HERE / "_runs" / f"{workload}.{seed}.{trace}.json"
    if run_file.exists():
        card = json.loads(run_file.read_text()).get("nvidia_smi")
    rec = {"workload": workload, "set": tag, "seconds": seconds, "seed": seed, "trace": trace,
           "rc": rc, "wall_s": wall, "result": result, "card": card}
    metrics = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
    print(f"RUN {workload} {tag} {seconds}s seed {seed} trace {trace} rc {rc} wall {wall:.1f} "
          f"correct {None if result is None else result['correct']} {json.dumps(metrics)} "
          f"| card {card}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=int, default=51)
    ap.add_argument("--extra-seconds", default="")
    ap.add_argument("--traced", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    extra = [int(s) for s in args.extra_seconds.split(",") if s]
    lengths = [args.seconds] + extra
    summary = {}
    for w in args.workload:
        recs = []
        for k in range(args.sets):
            tag = "AB"[k] if args.sets <= 2 else str(k)
            for seed in seeds:
                for sec in lengths if k == 0 else lengths[:1]:
                    recs.append(run_one(w, seed, sec, 0, out, tag))
        for seed in [int(s) for s in args.traced.split(",") if s]:
            recs.append(run_one(w, seed, args.seconds, 1, out, "T"))
        groups = {}
        for r in recs:
            if r["trace"] == 0 and r["result"] is not None:
                for m, v in r["result"]["metrics"].items():
                    groups.setdefault(m, {}).setdefault(f"{r['set']}.{r['seconds']}", []).append(
                        v["value"])
        table = {}
        for m, by in groups.items():
            table[m] = {g: {"median": statistics.median(v), "spread": spread(v),
                            "trimmed": trimmed(v), "n": len(v)} for g, v in by.items()}
            for sec in lengths:
                pooled = [x for g, v in by.items() if g.endswith(f".{sec}") for x in v]
                table[m][f"pooled.{sec}"] = {"spread": spread(pooled), "n": len(pooled)}
            for g, s in table[m].items():
                print(f"SPREAD {w} {m} {g} {json.dumps(s)}", flush=True)
        summary[w] = {"table": table, "correct": [r["result"]["correct"] if r["result"] else None
                                                  for r in recs]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What the program's spans and fetches cost with no profiler recording.

    python3 scripts/torch_span_cost.py [--n 200000] [--repeats 7]

Times, on the CPU, one pass of each form in a loop of `--n` (the best of
`--repeats`, less the empty loop's time): `bool(t)` of a 0-d tensor
against `profiling.fetch(t)`, `int(t)` against `profiling.fetch_int(t)`,
an empty `with profiling.span(...)` block, `record_function` entered and
left with no profiler (what an ungated span would cost), and the flag
read. Then counts the spans one ICP iteration opens, from a traced
registration of the cat pair. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import timeit
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from icpx_torch.io.loaders import load_cat_pair  # noqa: E402
from icpx_torch.registration.icp import ICPConfig, register  # noqa: E402
from icpx_torch.utils import profiling  # noqa: E402

FORMS = {
    "empty": "pass",
    "bool": "bool(t)",
    "fetch": "fetch(t)",
    "int": "int(i)",
    "fetch_int": "fetch_int(i)",
    "span": "with span('icpx.iter'): pass",
    "record_function": "with record_function('icpx.iter'): pass",
    "flag": "p._is_profiler_enabled",
}


def per_call_ns(n: int, repeats: int) -> dict:
    env = dict(t=torch.tensor(True), i=torch.tensor(7), fetch=profiling.fetch,
               fetch_int=profiling.fetch_int, span=profiling.span,
               record_function=torch.profiler.record_function,
               p=torch.autograd.profiler)
    best = {k: min(timeit.repeat(stmt, globals=env, number=n, repeat=repeats)) / n * 1e9
            for k, stmt in FORMS.items()}
    empty = best.pop("empty")
    return {k: v - empty for k, v in best.items()}


def spans_per_iteration() -> dict:
    src, tgt = load_cat_pair(device=torch.device("cpu"))
    cfg = ICPConfig(objective="symmetric", max_iters=20, diff_threshold=1.0,
                    max_corr_dist=50.0, robust="huber")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = register(src, tgt, cfg)
    counts = {e.key: e.count for e in prof.key_averages() if e.key.startswith("icpx.")}
    inner = ("icpx.iter", "icpx.nn", "icpx.weights", "icpx.solve", "icpx.stats")
    return {"iters": res.iters, "spans": counts,
            "spans_an_iteration": sum(counts.get(k, 0) for k in inner) / res.iters,
            "fetches_an_iteration": counts.get("icpx.fetch", 0) / res.iters}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200000)
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    ns = per_call_ns(args.n, args.repeats)
    out = {"torch": torch.__version__, "ns_a_call": ns,
           "fetch_over_bool_ns": ns["fetch"] - ns["bool"],
           "fetch_int_over_int_ns": ns["fetch_int"] - ns["int"], **spans_per_iteration()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

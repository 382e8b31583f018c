"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything that belongs to one cell is found by name from
`BENCHMARK.json`: the configuration's file (its `file` entry), the traffic
mix (`benchmark/traffic/<traffic>.json`, naming its entry,
`benchmark/entry/<entry>.py`, which `entries.load` finds),
the limits of the check (`benchmark/limits/<workload>.json`) and one reader
a metric (`benchmark/metrics/<metric>.py`, with `read(ctx)` returning a
number or None, and optional `WRAP`: functions of the program, as
"module:attribute", around which the traced run records CUDA-event spans).

The window is a closed loop with one client: request j starts when request
j - 1 has finished, until `--seconds` have passed; the window ends with the
last request and spans every request in it. With `--trace 1` the program's
wrapped functions are timed by CUDA events over the whole window, and
`torch.profiler` traces `trace_requests` requests after the first
`trace_from`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "icpx")
SMI_QUERY = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic, limits
    and metric readers, read from the files named after them."""

    def __init__(self, root: Path, workload: str):
        self.spec = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.config = load_json(root / configs[self.workload["config"]]["file"])
        bench = root / "benchmark"
        self.traffic = load_json(bench / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(bench / "limits" / f"{workload}.json")
        mine = lambda m: workload in m.get("workloads", [workload])  # noqa: E731
        self.end_to_end = [m for m in self.spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in self.spec["per_layer"] if mine(m)]
        self.readers = {}
        for m in self.end_to_end + self.per_layer:
            path = bench / "metrics" / f"{m['name']}.py"
            spec = importlib.util.spec_from_file_location(f"bench_metric_{len(self.readers)}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self.readers[m["name"]] = mod


class Recorder:
    """CUDA-event spans and calls of wrapped program functions, each
    tagged with the request it ran in."""

    def __init__(self, device):
        self.device = device
        self.request = -1
        self.spans: Dict[str, list] = {}
        self.calls: Dict[str, list] = {}
        self._undo = []

    def wrap(self, target: str) -> None:
        if target in self.spans:
            return
        mod_name, attr = target.split(":")
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        spans, calls = self.spans.setdefault(target, []), self.calls.setdefault(target, [])
        cuda = self.device.type == "cuda"

        def wrapped(*a, **kw):
            calls.append((self.request, tuple(tuple(x.shape) for x in a if torch.is_tensor(x))))
            if not cuda:
                return fn(*a, **kw)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            spans.append((self.request, s, e))
            return out

        setattr(mod, attr, wrapped)
        self._undo.append((mod, attr, fn))

    def unwrap(self) -> None:
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()

    def span_ms(self, target: str) -> List[float]:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return [s.elapsed_time(e) for _, s, e in self.spans.get(target, [])]


def smi() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(args, *, root: Path, device=None, t_start: float) -> int:
    """The whole run; returns the exit code. `device` None: the first card,
    which must be there (a test passes the CPU)."""
    cell = Cell(root, args.workload)
    chips = int(cell.workload["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import icpx_torch

    if root.absolute() not in Path(icpx_torch.__file__).absolute().parents:
        print(f"icpx_torch comes from {icpx_torch.__file__}, not from this checkout",
              file=sys.stderr)
        return 2
    import entries

    entry = entries.load(cell.traffic["entry"])(cell.config, cell.traffic, args.seed, device)
    entry.setup()
    entry.warm()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s", file=sys.stderr)

    rec = Recorder(device)
    trace_from = int(cell.traffic.get("trace_from", 1))
    trace_n = int(cell.traffic.get("trace_requests", 1))
    traced = set(range(trace_from, trace_from + trace_n))
    if args.trace:
        for m in cell.per_layer:
            for target in getattr(cell.readers[m["name"]], "WRAP", ()):
                rec.wrap(target)
    smi_before = smi() if cuda else None
    warm = int(cell.traffic.get("warm_requests", 1))
    records: List[dict] = []
    prof = None
    t0 = time.perf_counter()
    j = 0
    while True:
        rec.request = j
        if args.trace and j == trace_from:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        a = time.perf_counter()
        if prof is not None and j in traced:
            with torch.profiler.record_function("bench.request"):
                r = entry.request(warm + j)
        else:
            r = entry.request(warm + j)
        b = time.perf_counter()
        r.update(index=j, t0=a - t0, t1=b - t0)
        records.append(r)
        j += 1
        if prof is not None and j == trace_from + trace_n:
            prof.__exit__(None, None, None)
        if b - t0 >= args.seconds and (not args.trace or j >= trace_from + trace_n):
            break
    window_s = records[-1]["t1"]
    rec.unwrap()
    smi_after = smi() if cuda else None
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    for r in records:
        r["passed"] = entry.judge(r)
    failed = sum(not r["passed"] for r in records)
    trace = None
    if prof is not None:
        from devtrace import Trace

        trace = Trace.from_profiler(prof)
        del prof
    # what a metric reader sees
    ctx = SimpleNamespace(records=records, window_s=window_s, setup_s=setup_s, entry=entry,
                          recorder=rec, trace=trace, traced=traced)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        v = cell.readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    summary = entry.summary(records)
    print(f"window {window_s:.3f} s, {len(records)} requests, {failed} failed the gate; "
          f"peak device memory {memory_peak} bytes; metrics {json.dumps(metrics)}",
          file=sys.stderr, flush=True)
    entry.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = entry.check(entry.sample(records))
    numbers["gate_failures"] = float(failed)
    check_s = time.perf_counter() - t_check
    limits = dict(cell.limits, gate_failures=0.0)
    checks = {k: {"value": numbers.get(k, float("inf")), "limit": float(limits[k])}
              for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if args.trace and trace is not None:
        dev_info["busy_s"] = trace.busy_s
        dev_info["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(10), "idle_gaps": trace.idle_gaps(10)}
    result["checks"] = checks

    run_file = {"workload": args.workload, "seed": args.seed, "seconds": args.seconds,
                "trace": args.trace, "setup_s": setup_s, "window_s": window_s,
                "requests": len(records), "failed": failed, "memory_peak_bytes": memory_peak,
                "nvidia_smi": {"before": smi_before, "after": smi_after,
                               "fields": SMI_QUERY},
                "reference_s": check_s, "summary": summary,
                "latencies_s": [r["t1"] - r["t0"] for r in records],
                "iters": [np.asarray(torch.as_tensor(r["iters"]).cpu()).tolist() for r in records],
                "checks": checks, "metrics": metrics}
    runs = HERE / "_runs"
    runs.mkdir(exist_ok=True)
    (runs / f"{args.workload}.{args.seed}.{args.trace}.json").write_text(json.dumps(run_file))
    print(f"card: {smi_before} | after the window: {smi_after} ({SMI_QUERY})", file=sys.stderr)
    print(f"the reference took {check_s:.3f} s", file=sys.stderr)
    for k, v in summary.items():
        print(f"{k}: {v}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"modules that must not load: {', '.join(found)}", file=sys.stderr)
        return 3
    read = {k: v for k, v in numbers.items() if k not in checks}
    if read:
        print(f"read, not compared: {json.dumps(read)}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


def main(argv=None, *, t_start: float) -> int:
    args = parse(argv)
    try:
        return run(args, root=HERE.parent, t_start=t_start)
    except Exception:  # the run's boundary: report and fail without a result
        traceback.print_exc()
        return 1

"""The harness on the CPU, at small sizes: each cell's code path through
the harness's internals (the look for a card skipped), with no JAX module
loaded; a new cell, traffic mix and metric added as data; the timed path
broken underneath and `correct` coming out false; and, on the card, the
control failing a full-size cell's limits."""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import tinycells  # noqa: E402

SEED = 2147483659  # past 32 signed bits
TINY = sorted(tinycells.SHRINKS)

_RUN = """
import json, sys, time
from pathlib import Path
root = Path({root!r})
sys.path.insert(0, str(root / "benchmark"))
import harness
{patch}
args = harness.parse({argv!r})
rc = harness.run(args, root=root, device="cpu", t_start=time.perf_counter())
print("MODULES " + json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
sys.exit(rc)
"""


def run_cell(root, workload, *, trace=0, patch="", seconds=1.0):
    """One run of `workload` on the CPU in a fresh process: (result line,
    top-level names of every module it loaded)."""
    argv = ["--workload", workload, "--seed", str(SEED), "--seconds", str(seconds),
            "--trace", str(trace)]
    code = _RUN.format(root=str(root), patch=patch, argv=argv)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900,
                       cwd=root)
    assert p.returncode == 0, p.stderr[-4000:]
    lines = p.stdout.splitlines()
    result = json.loads([x for x in lines if x.startswith('{"correct"')][-1])
    modules = json.loads([x for x in lines if x.startswith("MODULES ")][-1][len("MODULES "):])
    return result, modules


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinycells.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", TINY)
def test_cell_runs_correct_and_loads_no_jax(root, workload):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    result, modules = run_cell(root, workload)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    want = {m["name"] for m in spec["end_to_end"] if workload in m.get("workloads", [workload])}
    assert set(result["metrics"]) == want
    assert list(result)[-1] == "checks"
    assert {"jax", "jaxlib", "flax", "icpx"}.isdisjoint(modules)
    assert "icpx_torch" in modules


def test_traced_run_reports_counters(root):
    result, _ = run_cell(root, "tiny-lidar.offline", trace=1)
    assert result["correct"] is True
    assert result["metrics"]["iters_per_frame"]["value"] > 0
    # no device on the CPU: the device's readers find nothing to read
    assert "idle_pct.frames" not in result["metrics"]
    assert "nn.roofline_pct" not in result["metrics"]


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts
            and "_runs" not in p.parts}


def test_new_cell_is_taken_as_data(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and limits added
    as new files, and entries added to BENCHMARK.json, run without an edit
    to any file the benchmark has."""
    root = tinycells.make_root(tmp_path)
    bench = root / "benchmark"
    before = _digests(bench)
    cfg = json.loads((bench / "configs" / "tiny-pair.json").read_text())
    cfg.update(name="tiny-pair-b", points=1024)
    (bench / "configs" / "tiny-pair-b.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "pairs-b.json").write_text(json.dumps(
        {"entry": "register", "pool": 2, "warm_requests": 1, "trace_from": 1,
         "trace_requests": 1, "check_answers": 1000}))
    (bench / "metrics" / "pool_pairs_answered.py").write_text(
        '"""Distinct pool pairs answered in the window."""\n\n\n'
        'def read(ctx):\n    return len({r["pool"] for r in ctx.records})\n')
    (bench / "limits" / "tiny-pair-b.pairs.json").write_text(
        json.dumps(tinycells.LIMITS["tiny-pair.stream"]))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="tiny-pair-b",
                                file="benchmark/configs/tiny-pair-b.json"))
    spec["workloads"].append({"name": "tiny-pair-b.pairs", "config": "tiny-pair-b",
                              "traffic": "pairs-b", "chips": 1, "why": "added as data"})
    spec["per_layer"].append({"name": "pool_pairs_answered", "unit": "pairs", "better": "higher",
                              "source": "program_counter", "layer": "ICP loop",
                              "moves": "points_per_s", "workloads": ["tiny-pair-b.pairs"]})
    for m in spec["end_to_end"]:
        if "tiny-pair.stream" in m.get("workloads", []):
            m["workloads"].append("tiny-pair-b.pairs")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    result, _ = run_cell(root, "tiny-pair-b.pairs", trace=1)
    assert result["correct"] is True
    assert result["metrics"]["pool_pairs_answered"]["value"] == 2
    result, _ = run_cell(root, "tiny-pair-b.pairs")
    assert {"points_per_s", "pair_p95_ms", "setup_s"} == set(result["metrics"])
    after = _digests(bench)
    assert {p: d for p, d in after.items() if p in before} == before


_PROGRAM = """
import dataclasses, torch
import icpx_torch.registration.icp as I
from icpx_torch.geometry.se3 import SE3
"""

FAULTS = {
    # every ICP loop returns the state it was given
    "unchanged": _PROGRAM + """
_scan = I._icp_scan
def _unchanged(config, src_xyz, src_mask, src_n, init, nn_fn, *a, **k):
    return _scan(config, src_xyz, src_mask, src_n, init, nn_fn, *a, **k).replace(transform=init)
I._icp_scan = _unchanged
""",
    # half of each batch left out, its answers taken from the rest: every
    # other pair of the stream, the second half of a request's pairs
    "half": _PROGRAM + """
_register, _batch = I.register, I.register_batch
_last = {}
def register(src, tgt, cfg, *a, **k):
    _last["n"] = _last.get("n", 0) + 1
    if _last["n"] % 2 == 0 and "res" in _last:
        return _last["res"]
    _last["res"] = _register(src, tgt, cfg, *a, **k)
    return _last["res"]
def _take(res, idx):
    return I.ICPResult(transform=SE3(R=res.transform.R[idx], t=res.transform.t[idx]),
                       iters=res.iters[idx], converged=res.converged[idx],
                       diff_history=res.diff_history[idx], rmse_history=res.rmse_history[idx],
                       final_rmse=res.final_rmse[idx], inlier_count=res.inlier_count[idx])
def register_batch(sx, sm, sn, tx, tm, tn, cfg, init=None):
    h = max(sx.shape[0] // 2, 1)
    sub = None if init is None else SE3(R=init.R[:h], t=init.t[:h])
    res = _batch(sx[:h], sm[:h], sn[:h], tx[:h], tm[:h], tn[:h], cfg, init=sub)
    return _take(res, torch.arange(sx.shape[0]) % h)
I.register, I.register_batch = register, register_batch
""",
    # every answer moved by 5 cm where it is produced
    "altered": _PROGRAM + """
_register, _batch = I.register, I.register_batch
def _moved(T):
    return SE3(R=T.R, t=T.t + 0.05)
def register(*a, **k):
    res = _register(*a, **k)
    return res.replace(transform=_moved(res.transform))
def register_batch(*a, **k):
    res = _batch(*a, **k)
    return res.replace(transform=_moved(res.transform))
I.register, I.register_batch = register, register_batch
""",
}


# every pool pair of the stream has its own ground truth, so another pair's
# answer is a wrong one
BROKEN = [(w, f) for w in TINY for f in sorted(FAULTS)]


@pytest.mark.parametrize("workload,fault", BROKEN)
def test_broken_timed_path_is_not_correct(root, workload, fault):
    # the window has to hold two of the stream's requests (~3 s each here)
    # for "half" to leave one of them out
    seconds = 6.0 if workload == "tiny-pair.stream" else 2.0
    result, _ = run_cell(root, workload, patch=FAULTS[fault], seconds=seconds)
    assert result["correct"] is False


# each full-size cell's control: the one whose smallest reading set the
# upper end of its limits (PERF.md)
CONTROL = {"pair1m-gicp.stream": "program-tf32", "lidar65k.offline": "program-tf32"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CONTROL))
def test_control_fails_the_full_size_limits(workload):
    """On the card, at the cell's own size, one seed: the program's
    answers within the cell's limits, the control's beyond one of them."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    p = subprocess.run([sys.executable, str(HERE / "control.py"), "--workload", workload,
                        "--seeds", str(SEED), "--control-seeds", str(SEED + 1),
                        "--controls", CONTROL[workload]],
                       capture_output=True, text=True, timeout=1800, cwd=HERE.parent)
    assert p.returncode == 0, p.stderr[-4000:]
    readings = [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]
    program = [r for r in readings if r["reading"] == "program"]
    control = [r for r in readings if r["reading"] == CONTROL[workload]]
    assert len(program) == 2 and len(control) == 1
    assert all(r["numbers"][k] <= v for r in program for k, v in limits.items())
    assert any(control[0]["numbers"][k] > v for k, v in limits.items())

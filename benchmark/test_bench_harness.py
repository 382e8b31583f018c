"""The harness on the CPU, at small sizes: each small cell's code path
through the harness's internals (the look for a card skipped), with no JAX
module loaded; a new cell, traffic mix and metric added as data, and a new
entry with its small cell and fault; the timed path broken underneath by
each fault its small cell lists and `correct` coming out false; and, on the
card, the control failing a full-size cell's limits. The small cells,
their faults, windows and controls come from `benchmark/tiny/*.json` and
`benchmark/faults/*.py`."""

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
TINY = tinycells.cells()

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


def run_cell(root, workload, *, trace=0, fault=None, seconds=1.0):
    """One run of `workload` on the CPU in a fresh process, its timed path
    broken by `benchmark/faults/<fault>.py` if given: (result line,
    top-level names of every module it loaded)."""
    argv = ["--workload", workload, "--seed", str(SEED), "--seconds", str(seconds),
            "--trace", str(trace)]
    patch = "" if fault is None else (root / "benchmark" / "faults" / f"{fault}.py").read_text()
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


@pytest.mark.parametrize("workload", sorted(TINY))
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
    cfg = json.loads((bench / "configs" / "tiny-pair.stream.json").read_text())
    cfg.update(name="tiny-pair-b", points=1024)
    (bench / "configs" / "tiny-pair-b.json").write_text(json.dumps(cfg))
    stream = json.loads((bench / "traffic" / "stream.json").read_text())
    (bench / "traffic" / "pairs-b.json").write_text(json.dumps(
        dict(stream, pool=2, warm_requests=1, trace_from=1, trace_requests=1, check_answers=1000)))
    (bench / "metrics" / "pool_pairs_answered.py").write_text(
        '"""Distinct pool pairs answered in the window."""\n\n\n'
        'def read(ctx):\n    return len({r["pool"] for r in ctx.records})\n')
    (bench / "limits" / "tiny-pair-b.pairs.json").write_text(
        json.dumps(TINY["tiny-pair.stream"]["limits"]))
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


_BLOCK_ENTRY = '''"""Entry "register_batch_block": a request registers the traffic's `pairs`
ground-truth pairs (config kind "gt_pairs") in one `register_batch_block`
call; work = the pairs; gate = every pair within the configured bounds of
its ground truth."""

import numpy as np
import torch

import generators as gen
import reference as ref
from entries import Entry, _mod, _se3_np, _settings, pool_gt


class BlockPairs(Entry):
    def setup(self):
        c = self.config
        self.configure()
        pairs = [gen.gt_pair(int(c["points"]), gen.sub_seed(self.seed, 1, i),
                             gen.sub_seed(self.seed, 2, i), **pool_gt(c["gt"], i))
                 for i in range(int(self.traffic["pairs"]))]
        self.src_np, self.tgt_np = [p[0] for p in pairs], [p[1] for p in pairs]
        self.gts = [ref.se3(p[3], p[4]) for p in pairs]
        self.src = torch.as_tensor(np.stack(self.src_np), device=self.device)
        self.tgt = torch.as_tensor(np.stack(self.tgt_np), device=self.device)
        self.mask = torch.ones(self.src.shape[:2], dtype=torch.bool, device=self.device)

    def request(self, j):
        res = _mod("icpx_torch.registration.icp").register_batch_block(
            self.src, self.mask, self.tgt, self.mask, self.cfg)
        return dict(R=res.transform.R, t=res.transform.t, rmse=res.final_rmse,
                    iters=res.iters, work=len(self.gts))

    def judge(self, rec):
        g = self.config["gate"]
        gaps = [ref.gap(_se3_np(rec["R"][b], rec["t"][b]), gt) for b, gt in enumerate(self.gts)]
        return all(rot < g["rot"] and t < g["t"] for rot, t in gaps)

    def sample(self, records):
        return [(rec, b) for rec in records for b in range(len(self.gts))]

    def answers(self, sample):
        return [(b, _se3_np(rec["R"][b], rec["t"][b]), float(rec["rmse"][b])) for rec, b in sample]

    def reference(self, b, control):
        src, tgt = self.src_np[b], self.tgt_np[b]
        v = np.ones(len(src), bool)
        k, view = int(self.icp["k_normals"]), tgt.mean(0)  # normals face the target's centroid
        return ref.register(src, v, ref.normals(src, v, k, self.device, view),
                            tgt, v, ref.normals(tgt, v, k, self.device, view),
                            _settings(self.icp), self.device)


ENTRY = BlockPairs
'''

_BLOCK_FAULT = """# every answer of register_batch_block moved by 5 cm where it is produced
import icpx_torch.registration.icp as I
from icpx_torch.geometry.se3 import SE3

_block = I.register_batch_block
def register_batch_block(*a, **k):
    res = _block(*a, **k)
    return res.replace(transform=SE3(R=res.transform.R, t=res.transform.t + 0.05))
I.register_batch_block = register_batch_block
"""


def test_new_entry_is_taken_as_data(tmp_path):
    """A new entry that calls a program function no other entry calls,
    with its configuration, traffic mix, limits, end-to-end metric, small
    cell and fault, all added as new files (and entries added to
    BENCHMARK.json): the small cell runs correct, the fault makes it not
    correct, and no file the benchmark has changes."""
    root = tinycells.make_root(tmp_path)
    bench = root / "benchmark"
    before = _digests(bench)
    pair = json.loads((bench / "configs" / "pair1m-gicp.json").read_text())
    cfg = {"name": "blocks65k", "kind": "gt_pairs", "points": 65536, "gt": pair["gt"],
           "gate": pair["gate"],
           "icp": {"objective": "symmetric", "max_iters": 10, "diff_threshold": 0.0,
                   "rmse_change_tol": 1e-6, "k_normals": 10, "nn_method": "block",
                   "coarse_iters": 2, "coarse_stride": 4}}
    limits = {"rot_gap_rad": 1e-6, "t_gap_m": 1e-6}
    files = {
        "entry/register_batch_block.py": _BLOCK_ENTRY,
        "configs/blocks65k.json": json.dumps(cfg),
        "traffic/batch.json": json.dumps({"entry": "register_batch_block", "pairs": 2,
                                          "warm_requests": 1, "trace_from": 1,
                                          "trace_requests": 1}),
        "limits/blocks65k.batch.json": json.dumps(limits),
        "metrics/block_pairs_per_s.py": '"""Pairs that pass the gate, over the window."""\n\n\n'
                                        'def read(ctx):\n'
                                        '    return sum(r["work"] for r in ctx.records'
                                        ' if r["passed"]) / ctx.window_s\n',
        # limits ~10x the gaps of SEED on the CPU (rot 7.6e-8 rad, t 1.4e-8 m)
        "tiny/tiny-blocks.batch.json": json.dumps(
            {"shrinks": "blocks65k.batch", "config": {"points": 1024}, "traffic": {},
             "limits": limits, "faults": ["moved-blocks"], "fault_seconds": 1.0,
             "control": "program-tf32"}),
        "faults/moved-blocks.py": _BLOCK_FAULT,
    }
    for name, text in files.items():
        assert not (bench / name).exists()
        (bench / name).write_text(text)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="blocks65k",
                                file="benchmark/configs/blocks65k.json"))
    spec["workloads"].append({"name": "blocks65k.batch", "config": "blocks65k",
                              "traffic": "batch", "chips": 1, "why": "added as data"})
    spec["end_to_end"].append({"name": "block_pairs_per_s", "unit": "pairs/s", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["blocks65k.batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    tinycells.shrink(root)
    tiny = tinycells.cells(bench)["tiny-blocks.batch"]
    result, modules = run_cell(root, "tiny-blocks.batch")
    assert result["correct"] is True and result["failed"] == 0
    assert {"block_pairs_per_s", "setup_s"} == set(result["metrics"])
    assert {"jax", "jaxlib", "flax", "icpx"}.isdisjoint(modules)
    for fault in tiny["faults"]:
        result, _ = run_cell(root, "tiny-blocks.batch", fault=fault,
                             seconds=tiny["fault_seconds"])
        assert result["correct"] is False
    after = _digests(bench)
    assert {p: d for p, d in after.items() if p in before} == before


def test_unknown_entry_names_the_file_it_looked_for():
    import entries

    with pytest.raises(FileNotFoundError) as e:
        entries.load("no-such-entry")
    assert str(HERE / "entry" / "no-such-entry.py") in str(e.value)


# every small cell with each fault its file lists
BROKEN = [(w, f) for w, t in TINY.items() for f in t["faults"]]


@pytest.mark.parametrize("workload,fault", BROKEN)
def test_broken_timed_path_is_not_correct(root, workload, fault):
    result, _ = run_cell(root, workload, fault=fault, seconds=TINY[workload]["fault_seconds"])
    assert result["correct"] is False


# each full-size cell's control: the one whose smallest reading set the
# upper end of its limits (PERF.md)
CONTROL = {t["shrinks"]: t["control"] for t in TINY.values()}


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

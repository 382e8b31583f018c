"""The readers of the program's spans (`progspans.py`): a traced run of a
small cell on the CPU, where the host spans are there and the card is not,
and their arithmetic on a synthetic trace, to the microsecond."""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import devtrace  # noqa: E402
import progspans  # noqa: E402
import tinycells  # noqa: E402

SEED = 2147483659  # past 32 signed bits

_RUN = """
import sys, time
from pathlib import Path
root = Path({root!r})
sys.path.insert(0, str(root / "benchmark"))
import harness
args = harness.parse({argv!r})
sys.exit(harness.run(args, root=root, device="cpu", t_start=time.perf_counter()))
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinycells.make_root(tmp_path_factory.mktemp("bench"))


def test_traced_run_reads_the_program_spans(root):
    argv = ["--workload", "tiny-lidar.offline", "--seed", str(SEED), "--seconds", "1",
            "--trace", "1"]
    p = subprocess.run([sys.executable, "-c", _RUN.format(root=str(root), argv=argv)],
                       capture_output=True, text=True, timeout=900, cwd=root)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads([x for x in p.stdout.splitlines() if x.startswith('{"correct"')][-1])
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"] is True
    assert m["issue_ms_per_iter.frames"] > 0.0
    assert m["fetches_per_frame.frames"] >= m["iters_per_frame"] > 0.0
    # no device on the CPU: nothing for the idle reader to read
    assert "idle_pct.loop.frames" not in m


def _event(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _ctx(events):
    return SimpleNamespace(trace=devtrace.Trace(events), records=[{"index": 1, "work": 2}],
                           traced={1})


def test_readers_arithmetic_on_a_synthetic_trace():
    """A 1,000 us traced stretch; the card busy over [100, 300] and
    [600, 700]; two iterations, [200, 800] with a fetch over [650, 750],
    and [850, 950]."""
    ctx = _ctx([
        _event("bench.request", 0.0, 1000.0),
        _event("kernel_a", 100.0, 200.0, cat="kernel"),
        _event("kernel_b", 600.0, 100.0, cat="kernel"),
        _event("icpx.iter", 200.0, 600.0),
        _event("icpx.fetch", 650.0, 100.0),
        _event("icpx.iter", 850.0, 100.0),
    ])
    # issue: (600 - 100 + 100) / 2 us
    assert progspans.issue_ms_per_iter(ctx) == pytest.approx(0.3, abs=1e-9)
    # idle inside the iterations: 600 - 200 busy + 100, of 1,000 us
    assert progspans.idle_pct_in_loop(ctx) == pytest.approx(50.0, abs=1e-7)
    assert progspans.fetches(ctx, per="work") == pytest.approx(0.5)
    assert progspans.fetches(ctx, per="request") == pytest.approx(1.0)


def test_readers_find_nothing_without_the_spans():
    """A program older than its spans: every reader returns None."""
    ctx = _ctx([_event("bench.request", 0.0, 1000.0),
                _event("kernel_a", 100.0, 200.0, cat="kernel"),
                _event("aten::item", 400.0, 50.0, cat="cpu_op")])
    assert progspans.issue_ms_per_iter(ctx) is None
    assert progspans.idle_pct_in_loop(ctx) is None
    assert progspans.fetches(ctx, per="work") is None
    assert progspans.fetches(SimpleNamespace(trace=None), per="request") is None

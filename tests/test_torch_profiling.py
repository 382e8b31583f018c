"""`icpx_torch.utils.profiling`'s spans, fetches and launch counter on the
CPU: off (no `record_function` entered) without a profiler; in the chrome
trace, nested by time, with one; counted where the program says (one
`icpx.iter` a result's iteration, one `icpx.fetch` a host read, one
`icpx.frame` a registered frame); and one launch dict for every kernel."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch's thread count per worker)
from icpx_torch.cloud import PointCloud
from icpx_torch.geometry.se3 import SE3
from icpx_torch.io.loaders import load_cat_pair, reference_data_dir, synthetic_surface
from icpx_torch.kernels import blocknn_cuda, nn_cuda, sort_cuda
from icpx_torch.kernels.normals import estimate_normals
from icpx_torch.odometry.compiled import run_odometry_compiled
from icpx_torch.odometry.kitti import make_trajectory, make_world, simulate_scans
from icpx_torch.registration.icp import ICPConfig, register, register_batch
from icpx_torch.utils import profiling

CPU = torch.device("cpu")
CAT = dict(objective="symmetric", max_iters=20, diff_threshold=1.0, max_corr_dist=50.0)
KERNELS = {"nn", "moments6", "fold6", "fold7", "select", "fused4", "moments_fused", "sort"}


def traced(tmp_path, fn):
    """fn() under a CPU torch.profiler: (its result, the `icpx.*`
    "user_annotation" events of the exported chrome trace as (start, end,
    name), by start)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("icpx."))
    return out, spans


def names(spans, name):
    return [(a, b) for a, b, n in spans if n == name]


def inside(child, parents):
    return any(a <= child[0] and child[1] <= b for a, b in parents)


@pytest.fixture(scope="module")
def cat():
    return load_cat_pair(device=CPU)


def test_off_enters_no_record_function(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    with profiling.span("icpx.a"):
        pass
    assert profiling.span("icpx.a") is profiling.span("icpx.b")  # one shared no-op
    assert profiling.fetch(torch.tensor(True)) is True
    assert profiling.fetch(torch.tensor(0.0)) is False
    got = profiling.fetch_int(torch.tensor(7))
    assert got == 7 and type(got) is int
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("icpx.a"):
            assert profiling.fetch(torch.tensor(1)) is True
    assert entered == ["icpx.a", "icpx.fetch"]


def test_trace_nests_loop_iter_fetch(tmp_path, cat):
    src, tgt = cat
    res, spans = traced(tmp_path, lambda: register(src, tgt, ICPConfig(**CAT)))
    loops, iters, fetches = (names(spans, n) for n in ("icpx.loop", "icpx.iter", "icpx.fetch"))
    assert names(spans, "icpx.register") and loops and iters and fetches
    assert all(inside(x, names(spans, "icpx.register")) for x in loops)
    assert all(inside(x, loops) for x in iters)
    assert all(inside(x, iters) for x in fetches)
    for part in ("icpx.nn", "icpx.weights", "icpx.solve", "icpx.stats"):
        assert len(names(spans, part)) == res.iters
        assert all(inside(x, iters) for x in names(spans, part))


@pytest.mark.parametrize("robust,reads_an_iteration", [("none", 1), ("huber", 2)])
def test_iter_and_fetch_spans_count_the_cat_pair(tmp_path, cat, robust, reads_an_iteration):
    """One `icpx.iter` an iteration; one `icpx.fetch` an iteration (the
    stop flag) and, with the MAD scale, one more (the median's index)."""
    src, tgt = cat
    res, spans = traced(tmp_path, lambda: register(src, tgt, ICPConfig(**CAT, robust=robust)))
    assert res.iters > 1
    assert len(names(spans, "icpx.iter")) == res.iters
    assert len(names(spans, "icpx.fetch")) == reads_an_iteration * res.iters


def test_register_batch_spans_count_its_pairs(tmp_path, cat):
    """Two pairs (the cat pair from two initial guesses): one
    `icpx.pair` and one loop each, their iterations summed."""
    src, tgt = (estimate_normals(c, k=10) for c in cat)
    two = lambda c: [torch.stack([x, x]) for x in (c.xyz, c.mask, c.normals)]  # noqa: E731
    c, s = np.cos(0.3), np.sin(0.3)
    rz = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float32)
    init = SE3(R=torch.stack([torch.eye(3), rz]),
               t=torch.tensor([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0]]))
    res, spans = traced(tmp_path, lambda: register_batch(*two(src), *two(tgt), ICPConfig(**CAT),
                                                         init=init))
    total = int(res.iters.sum())
    assert len(names(spans, "icpx.register_batch")) == 1
    assert len(names(spans, "icpx.pair")) == 2
    assert len(names(spans, "icpx.loop")) == 2
    assert len(names(spans, "icpx.iter")) == total
    assert len(names(spans, "icpx.fetch")) == total


def _surface_pair(n):
    xyz = synthetic_surface(n, seed=3)
    c, s = np.cos(0.1), np.sin(0.1)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    moved = xyz @ R.T + np.array([0.02, -0.01, 0.0], np.float32)
    return PointCloud.create(xyz, device=CPU), PointCloud.create(moved, device=CPU)


def test_block_register_names_its_stages(tmp_path):
    """The block path: both KD builds, both in-registration normals, the
    coarse, freeze and refine stages; one `icpx.fetch` an iteration plus
    the two middle ranks of each normals' spacing median (PERF.md)."""
    src, tgt = _surface_pair(8192)
    cfg = ICPConfig(objective="symmetric", max_iters=8, diff_threshold=0.0, rmse_change_tol=1e-6,
                    nn_method="block", block_tile=64, block_q_tile=32)
    res, spans = traced(tmp_path, lambda: register(src, tgt, cfg))
    assert len(names(spans, "icpx.index")) == 2
    assert len(names(spans, "icpx.normals")) == 2
    for stage in ("icpx.coarse", "icpx.freeze", "icpx.refine"):
        assert len(names(spans, stage)) == 1, stage
    assert names(spans, "icpx.mid") == []
    assert len(names(spans, "icpx.loop")) == 2  # coarse and refine
    assert len(names(spans, "icpx.iter")) == res.iters
    assert len(names(spans, "icpx.fetch")) == res.iters + 2 * 2


def test_compiled_odometry_spans_a_frame(tmp_path):
    """frames - 1 `icpx.frame` spans; the fetches are each frame's keyframe
    decision and its iterations' stop flags and MAD medians."""
    frames = 4
    world = make_world(n_points=40000, extent=30.0, seed=0)
    scans = simulate_scans(world, make_trajectory(frames, speed=0.6, turn=0.04, device=CPU),
                           max_range=18.0, points_per_scan=2048, noise=0.01, seed=1, device=CPU)
    scans = [estimate_normals(s, k=10) for s in scans]
    fx, fm, fn = (torch.stack([getattr(s, a) for s in scans]) for a in ("xyz", "mask", "normals"))
    cfg = ICPConfig(objective="symmetric", max_iters=12, diff_threshold=0.0, rmse_change_tol=1e-6,
                    robust="huber", max_corr_dist=2.0)
    res, spans = traced(tmp_path, lambda: run_odometry_compiled(fx, fm, fn, cfg))
    iters = int(res.iters.sum())
    assert len(names(spans, "icpx.frame")) == frames - 1
    assert len(names(spans, "icpx.iter")) == iters
    assert len(names(spans, "icpx.fetch")) == 2 * iters + frames - 1
    assert all(inside(x, names(spans, "icpx.frame")) for x in names(spans, "icpx.loop"))


def test_launches_is_one_dict_unchanged_on_the_cpu():
    assert set(profiling.LAUNCHES) == KERNELS
    assert not any(hasattr(m, "LAUNCHES") for m in (nn_cuda, blocknn_cuda, sort_cuda))
    before = dict(profiling.LAUNCHES)
    src, tgt = _surface_pair(4096)
    for method in ("brute", "block"):
        register(src, tgt, ICPConfig(max_iters=3, diff_threshold=0.0, nn_method=method,
                                     block_tile=64, block_q_tile=32))
    assert profiling.LAUNCHES == before  # CPU tensors: the plain versions ran


@pytest.mark.skipif(reference_data_dir() is None, reason="needs the cat fixtures")
def test_cli_profile_writes_the_spans(tmp_path, capsys):
    import icpx_torch.cli as cli

    d = reference_data_dir()
    out = tmp_path / "prof"
    assert cli.main(["--device", "cpu", "register", str(d / "cat.pcd"), str(d / "cat_out.pcd"),
                     "--max-corr-dist", "50", "--profile", str(out)]) == 0
    text = "".join(p.read_text() for p in Path(out).iterdir() if p.suffix == ".json")
    for name in ("icpx.register", "icpx.loop", "icpx.iter", "icpx.fetch"):
        assert f'"{name}"' in text

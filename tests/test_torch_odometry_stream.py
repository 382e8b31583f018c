"""Online odometry (`OdometryStream`): scans pushed one at a time give the
bits of the stacked `run_odometry_compiled` on the brute and block paths,
count spawns and gate rejections, record their spans under a profiler, and
match the benchmark's float64 frame loop (`benchmark/reference_online.py`)
frame by frame."""

import json
import sys
from pathlib import Path

import pytest
import torch

from icpx_torch.kernels.normals import estimate_normals
from icpx_torch.odometry import OdometryStream, run_odometry_compiled
from icpx_torch.odometry.kitti import make_trajectory, make_world, simulate_scans
from icpx_torch.registration.icp import ICPConfig
from icpx_torch.utils import profiling

BENCH = Path(__file__).resolve().parent.parent / "benchmark"

BASE = dict(objective="symmetric", max_iters=12, diff_threshold=0.0, rmse_change_tol=1e-6,
            robust="huber", max_corr_dist=2.0)
BLOCK = dict(nn_method="block", block_tile=64, block_q_tile=32, block_k=6, coarse_iters=0,
             refine_stride=2)
# (config, keywords): a 1 cm gate rejects some frames, 0.6 m frames spawn
CASES = {
    "brute": (dict(BASE), dict(max_correction_trans=0.01)),
    "block": (dict(BASE, **BLOCK), dict(max_correction_trans=0.01, freeze_candidates=True,
                                        velocity_damping=0.7)),
}


def _scans(n_frames, n_pts, seed):
    world = make_world(n_points=60000, extent=30.0, seed=0)
    poses = make_trajectory(n_frames, speed=0.6, turn=0.04, device="cpu")
    clouds = simulate_scans(world, poses, max_range=18.0, points_per_scan=n_pts, noise=0.01,
                            seed=seed, device="cpu")
    return [estimate_normals(c, k=10) for c in clouds]


@pytest.mark.parametrize("case", list(CASES))
def test_stream_equals_the_stacked_run(case):
    cfg, kw = CASES[case]
    scans = _scans(6, 2048, 1)
    stacked = [torch.stack([getattr(s, a) for s in scans]) for a in ("xyz", "mask", "normals")]
    want = run_odometry_compiled(*stacked, ICPConfig(**cfg), **kw)
    stream = OdometryStream(2048, "cpu", ICPConfig(**cfg), **kw)
    frames = [stream.push(s.xyz.clone(), s.mask.clone(), s.normals.clone()) for s in scans]
    got = stream.result()
    for name in ("poses", "edge_rel", "final_rel"):
        assert torch.equal(getattr(got, name).R, getattr(want, name).R), name
        assert torch.equal(getattr(got, name).t, getattr(want, name).t), name
    for name in ("is_keyframe", "rmse", "edge_src", "final_kf", "iters", "rejected", "spawns",
                 "rejections"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    # each push's result is that frame's row
    for k, f in enumerate(frames):
        assert torch.equal(f.pose.t, got.poses.t[k]) and torch.equal(f.rel.R, got.edge_rel.R[k])
        for name in ("rmse", "iters", "is_keyframe", "edge_src", "rejected"):
            assert torch.equal(getattr(f, name), getattr(got, name)[k]), (k, name)
    # the sequence spawns and rejects, and the counters count it
    spawns, rejects = int(got.is_keyframe[1:].sum()), int(got.rejected.sum())
    assert spawns >= 1 and rejects >= 1
    assert int(got.spawns) == spawns and int(got.rejections) == rejects
    assert int(frames[-1].spawns) == spawns and got.spawns.dtype == torch.int32
    assert torch.isinf(got.rmse[got.rejected]).all()


def test_stream_refuses_another_row_count():
    stream = OdometryStream(2048, "cpu")
    with pytest.raises(ValueError, match="2048"):
        stream.push(torch.zeros(1024, 3), torch.ones(1024, dtype=torch.bool), torch.zeros(1024, 3))
    with pytest.raises(ValueError):
        stream.result()


def test_stream_spans_under_a_profiler():
    """A push that registers a frame (all but the first) is one
    `icpx.frame`, a keyframe build one `icpx.keyframe` with its KD build's
    `icpx.index` inside, each frame's source build an `icpx.index`; without
    a profiler `span` is the shared no-op."""
    cfg, kw = CASES["block"]
    scans = _scans(4, 2048, 1)
    assert profiling.span("icpx.frame") is profiling.span("icpx.keyframe")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        stream = OdometryStream(2048, "cpu", ICPConfig(**cfg), **kw)
        for s in scans:
            stream.push(s.xyz, s.mask, s.normals)
        res = stream.result()
    counts = {e.key: e.count for e in prof.key_averages() if e.key.startswith("icpx.")}
    builds = 1 + int(res.spawns)
    assert counts["icpx.frame"] == 3
    assert counts["icpx.keyframe"] == builds
    assert counts["icpx.index"] == builds + 3
    assert counts["icpx.fetch"] >= 3  # the spawn flags, besides the loop's


@pytest.fixture(scope="module")
def online_bench():
    sys.path.insert(0, str(BENCH))
    try:
        import entries
        import tinycells

        yield entries, tinycells
    finally:
        sys.path.remove(str(BENCH))


def test_program_matches_the_online_reference(online_bench):
    """8 scans of 8,192 rows on the block path with the full-size cell's
    schedule (frozen candidates, a stride-2 mid phase): every frame within
    the small online cell's limits of the float64 reference, the decisions
    its own, the chain within the ATE gate."""
    entries, tinycells = online_bench
    tiny = tinycells.cells()["tiny-lidar.online"]
    config = json.loads((BENCH / "configs" / "lidar65k-online.json").read_text())
    config = tinycells._merge(config, {"scans": {"points": 8192}, "trajectory": {"frames": 8}})
    traffic = json.loads((BENCH / "traffic" / "online.json").read_text())
    traffic = tinycells._merge(traffic, tiny["traffic"])
    entry = entries.load(traffic["entry"])(config, traffic, 2147483659, torch.device("cpu"))
    entry.setup()
    rec = entry.request(0)
    assert entry.judge(rec)
    numbers = entry.check(entry.sample([rec]))
    assert numbers["reference_frames"] == 7
    for name, limit in tiny["limits"].items():
        assert numbers[name] <= limit, (name, numbers[name], limit)

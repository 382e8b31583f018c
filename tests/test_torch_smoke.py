"""`chip_smoke.py` off the card: its refusals, and its control flow rehearsed
on the CPU with the kernel's plain version standing in for the kernel."""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import chip_smoke
import torch_parity  # noqa: F401  (pins torch's thread count per worker)
from icpx_torch.kernels import blocknn, blocknn_cuda, cuda_build, nn_cuda, normals, sort_cuda
from icpx_torch.odometry import compiled
from icpx_torch.registration import icp

ROOT = Path(__file__).resolve().parent.parent


def test_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        chip_smoke.main()
    assert '"ok"' not in capsys.readouterr().out


def test_profile_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        chip_smoke.profile_flagship(n=1024)
    assert capsys.readouterr().out == ""


def test_script_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py the script exits non-zero
    and prints no result (no package to import, or no card)."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


class _Event:
    """Host-clock stand-in for torch.cuda.Event."""

    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_rehearsal_on_cpu(monkeypatch, capsys):
    """Every phase at a small size on the CPU: the plain versions stand in
    for the kernels and count launches as the kernels would, and "auto"
    resolves to the kernels as it does on a CUDA device. The flagship is
    8,192 points, the block path's threshold (BLOCK_THRESHOLD is lowered to
    it, so GICP's covariances take the block method as at 1M), and every
    timed call runs once."""
    def fake_kernel(q, r, m=None):
        nn_cuda.LAUNCHES += 1
        return nn_cuda.nearest_neighbor_reference(q, r, ref_mask=m)

    def dispatch(query, ref, *, ref_mask=None, tile_q=2048, tile_r=4096):
        return fake_kernel(query.contiguous(), ref.contiguous(), ref_mask)

    def fake_moments6(query, tiles, cand, q_cent, r2):
        blocknn_cuda.LAUNCHES["moments6"] += 1
        return blocknn_cuda.moments6_reference(query, tiles, cand, q_cent, r2.reshape(()))

    def fake_fold6(query, ops):
        blocknn_cuda.LAUNCHES["fold6"] += 1
        return blocknn_cuda.fold6_reference(query, ops)

    def fake_fold7(query, ops):
        blocknn_cuda.LAUNCHES["fold7"] += 1
        return blocknn_cuda.fold7_reference(query, ops)

    def fake_select(pos, cand, table, s):
        blocknn_cuda.LAUNCHES["select"] += 1
        return blocknn_cuda.select_reference(pos, cand, table, s)

    def fake_fused4(query, tiles, unions, group):
        blocknn_cuda.LAUNCHES["fused4"] += 1
        return blocknn_cuda.fused4_reference(query, tiles, unions, group)

    def fake_moments_fused(query, tiles, unions, q_cent, r2, group):
        blocknn_cuda.LAUNCHES["moments_fused"] += 1
        return blocknn_cuda.moments_fused_reference(query, tiles, unions, q_cent, r2.reshape(()), group)

    def fake_sort(key, payloads):
        sort_cuda.LAUNCHES["sort"] += 1
        return sort_cuda.sort_segments_reference(key, payloads)

    real_fused4 = blocknn_cuda.block_nn_fused4

    def fused4_wrapper(*a, **kw):  # the CPU wrapper runs the plain version: count it
        blocknn_cuda.LAUNCHES["fused4"] += 1
        return real_fused4(*a, **kw)

    def select_wrapper(pos, cand, pl_tiles):
        t, s, d = pl_tiles.shape
        return fake_select(pos, cand, pl_tiles.reshape(t * s, d), s)

    def as_if_cuda(resolve):
        return lambda self, n, device: resolve(self, n, torch.device("cuda"))

    real_run = subprocess.run

    def fake_run(cmd, **kw):
        if cmd[0] == "nvidia-smi":
            return subprocess.CompletedProcess(cmd, 0, stdout="Fake GPU, 700.00 W\n")
        return real_run(cmd, **kw)

    monkeypatch.setattr(nn_cuda, "nn_cuda", fake_kernel)
    monkeypatch.setattr(nn_cuda, "build", lambda: None)
    shape = nn_cuda.KernelShape(threads=256, queries_per_thread=4, group=8, tile_r=256)
    monkeypatch.setattr(nn_cuda, "launch_plan", lambda nq, nr, device: dict(
        zip(("q_blocks", "splits", "tiles_per_split"), nn_cuda.plan(nq, nr, 132, 4, shape)),
        sms=132, blocks_per_sm=4, **shape._asdict()))
    monkeypatch.setattr(blocknn_cuda, "build", lambda: None)
    monkeypatch.setattr(sort_cuda, "build", lambda: None)
    # the shapes the built libraries report (pinned in test_torch_sort.py, test_torch_blocknn.py)
    monkeypatch.setattr(sort_cuda, "kernel_shape", lambda: sort_cuda.KernelShape(4, 8192, 512))
    monkeypatch.setattr(blocknn_cuda, "fused4_shape", lambda: blocknn_cuda.Fused4Shape(256, 4, 4, 512))
    monkeypatch.setattr(sort_cuda, "sort_cuda", fake_sort)
    monkeypatch.setattr(blocknn, "sort_segments", fake_sort)  # the KD builds' level sorts
    monkeypatch.setattr(blocknn_cuda, "moments_fused_cuda", fake_moments_fused)
    monkeypatch.setattr(blocknn_cuda, "moments_fused", fake_moments_fused)
    monkeypatch.setattr(cuda_build, "compile_all", lambda *a: None)
    monkeypatch.setattr(blocknn_cuda, "moments6_cuda", fake_moments6)
    monkeypatch.setattr(blocknn_cuda, "fold6_cuda", fake_fold6)
    monkeypatch.setattr(blocknn_cuda, "moments6",
                        lambda q, t, c, qc, r2: fake_moments6(q, t, c.to(torch.int32), qc, r2))
    monkeypatch.setattr(icp, "block_fold_fused_pre", fake_fold6)
    monkeypatch.setattr(blocknn_cuda, "fold7_cuda", fake_fold7)
    monkeypatch.setattr(blocknn_cuda, "select_cuda", fake_select)
    monkeypatch.setattr(blocknn_cuda, "fused4_cuda", fake_fused4)
    monkeypatch.setattr(icp, "block_fold7_pre", fake_fold7)
    monkeypatch.setattr(icp, "payload_select_fused", select_wrapper)
    monkeypatch.setattr(icp, "block_nn_fused4", fused4_wrapper)
    monkeypatch.setattr(icp, "nearest_neighbor", dispatch)
    monkeypatch.setattr(compiled, "nearest_neighbor", dispatch)
    # no device to profile: the run itself, no device time
    monkeypatch.setattr(chip_smoke, "_device_profile", lambda run: (run(), 1.0, 0.0, [], 0.0))
    for name in ("resolve_payload", "resolve_moments"):
        monkeypatch.setattr(icp.ICPConfig, name, as_if_cuda(getattr(icp.ICPConfig, name)))
    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    monkeypatch.setattr(chip_smoke, "WATCHDOG_PAIRS", 1)  # one run with the watchdog, one without
    # every timed call once: the plain versions stand in for the kernels here,
    # so the card's repetitions would only repeat them
    def once(fn, *a, **kw):
        out = fn()
        return 1e-3, out

    monkeypatch.setattr(chip_smoke, "_sync_time", once)
    monkeypatch.setattr(chip_smoke, "_event_ms", lambda fn, *a, **kw: once(fn)[0])
    monkeypatch.setattr(chip_smoke, "_graph_ms", lambda fn, *a, **kw: once(fn)[0])
    # GICP covariances take the block method (radius moments off KD indexes)
    # at this size, as at the card's 1M
    monkeypatch.setattr(normals, "BLOCK_THRESHOLD", 8192)
    for name, value in (
        ("get_device_name", lambda i=0: "Fake GPU"),
        ("device_count", lambda: 1),
        ("synchronize", lambda *a: None),
        ("reset_peak_memory_stats", lambda *a: None),
        ("max_memory_allocated", lambda *a: 0),
        ("Event", _Event),
    ):
        monkeypatch.setattr(torch.cuda, name, value)

    chip_smoke.main(dev=torch.device("cpu"), n_pair=2048, n_flag=8192, n_small=8192, n_batch=1000,
                    n_scan=8192, n_plane=8192, b_batch=3, b_block=2, n_odo=8192, n_odo_brute=2048,
                    n_odo_small=8192, odo_frames=4, map_capacity=16384, n_slam=2048)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "Fake GPU", "count": 1}}
    ks = json.loads(lines[-2])["kernels"]
    assert [k["name"] for k in ks] == ["nn", "moments6", "fold6", "fold7", "select", "fused4",
                                       "moments_fused", "sort"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    device = {"device_ms", "library_device_ms"}
    # the refine-stride mid phase's shapes: every 2nd and every 4th query row
    mid = {f"{k}_sq{q}" for k in ("ms", "device_ms", "plain_ms", "bound_ms") for q in (32, 16)}
    extras = {"nn": {"ms_3456", "plain_ms_3456", "library_ms_3456", "bound_ms_3456", "splits",
                     "splits_3456", "device_ms", "device_ms_3456", "library_device_ms_3456",
                     "launches_odometry"},
              "moments6": {"cov_max_abs_err", "cov_err_over_tol", "device_ms", "bytes_ms", "band_pairs",
                           "screened_pairs", "mean_count", "ms_k8", "device_ms_k8", "plain_ms_k8",
                           "bound_ms_k8", "bytes_ms_k8", "band_pairs_k8", "screened_pairs_k8",
                           "mean_count_k8"},
              "fold6": {"device_ms", "ms_d12", "plain_ms_d12", "device_ms_d12", "bound_ms_d12",
                        "prepare_ms", "launches_mid", "launches_odometry"} | mid,
              "fold7": {"device_ms", "ms_d12", "plain_ms_d12", "device_ms_d12", "bound_ms_d12",
                        "prepare_ms", "launches_mid"} | mid,
              "select": {"ms_d12", "plain_ms_d12", "library_ms_d12", "bound_ms_d12", "device_ms_d12",
                         "library_device_ms_d12"} | device | mid | {
                             f"library{k}{q}" for k in ("_ms", "_device_ms") for q in ("_sq32", "_sq16")},
              "fused4": {"union_mean", "union_max", "device_ms"},
              "moments_fused": {"cov_err_over_tol", "union_mean", "union_max", "padded_share",
                                "rows_below_xla", "margin_used", "device_ms"},
              "sort": device | {"launches_odometry"}}
    for k in ks:
        assert set(k) == keys | extras.get(k["name"], set())
        assert k["device_ms"] > 0  # every row of the kernel table has a device time
        assert k["route"] == "cuda" and (ROOT / k["source"]).exists()
        assert k["bound_ms"] > 0 and k["bound_by"] in ("bytes", "operations")
    nn, mom, fold, fold7, select, fused4, mfused, sort = ks
    assert 0.0 <= mom["cov_err_over_tol"] <= 1.0 and fold["max_abs_err"] == 0.0
    for k in (fold7, select, fused4, sort):  # bit equality with the plain versions
        assert k["max_abs_err"] == 0.0 and k["launches"] >= 1
    assert fold7["replaces"] == "icpx/kernels/blocknn_pallas.py:694"
    assert select["replaces"] == "icpx/kernels/blocknn_pallas.py:358"
    assert fused4["replaces"] == "icpx/kernels/blocknn_pallas.py:101"
    assert select["library_ms"] > 0 and fold7["library_ms"] is None
    assert 1 <= fused4["union_mean"] <= fused4["union_max"] <= 32
    assert mfused["replaces"] == "icpx/kernels/blocknn_pallas.py:219"
    assert sort["replaces"] == "icpx/kernels/sort_pallas.py:86"
    assert sort["source"] == "icpx_torch/csrc/sort.cu" and sort["library_ms"] == sort["plain_ms"]
    # the GICP path at 8k: the source's build (tiles of 64: 5 levels), the
    # target's (128: 4) and each cloud's covariance build (128: 4)
    assert sort["launches"] == 17 and mfused["launches"] == 2
    assert 0.0 <= mfused["cov_err_over_tol"] <= 1.0 and mfused["library_ms"] is None
    assert 1 <= mfused["union_mean"] <= mfused["union_max"] <= 32 and 0 <= mfused["padded_share"] < 1
    assert 0.0 <= mfused["margin_used"] <= 1.0
    assert nn["replaces"] == "icpx/kernels/knn_pallas.py:37"
    assert mom["replaces"] == "icpx/kernels/blocknn_pallas.py:890"
    assert fold["replaces"] == "icpx/kernels/blocknn_pallas.py:497"
    assert nn["launches"] >= 2 and nn["max_abs_err"] == 0.0 and nn["library_ms"] > 0
    assert nn["splits_3456"] == 14 and nn["bound_ms_3456"] > 0 and nn["library_ms_3456"] > 0
    assert mom["launches"] >= 2 and fold["launches"] >= 1
    # the mid phase: the fold once an iteration of stride 2 and stride 4 (fold6), stride 2 (fold7)
    assert fold["launches_mid"] >= 2 and fold7["launches_mid"] >= 1
    for k in (fold, fold7, select):
        assert all(k[f"{f}_sq{q}"] > 0 for f in ("device_ms", "bound_ms") for q in (32, 16))
    assert mom["library_ms"] is None and fold["library_ms"] is None
    assert "Fake GPU, 700.00 W" in lines
    prefixes = ["cat: ", "65k pair: ", "nn kernel vs plain 3456x3456 (56 pad rows): d2 and index "
                "bit-equal", "nn kernel vs plain 300x700 (all masked)", "moments6 kernel vs plain", "fold6 kernel vs plain",
                "fold7 kernel vs plain", "select kernel vs plain", "fused4 kernel vs plain",
                "KD index (64, 128, 3): equal", "KD index (128, 64, 3): equal",
                "sort kernel vs plain: bit-equal", "moments_fused kernel vs plain",
                "clocks before the kernel phases", "clocks after the kernel phases",
                "flagship 1M (gicp fused): "]
    prefixes += [f"flagship 1M ({m}): " for m in chip_smoke._flag_configs()]
    prefixes += [f"flagship 1M (gicp) rep {r}: " for r in (1, 2, 3)]
    prefixes += [f"16k block pair ({m}): " for m in (
        "vmem", "vmem7", "select", "fused", "gicp", "gicp vmem7", "gicp select", "gicp fused",
        "mid vmem", "mid select")]
    prefixes += [f"flagship 1M ({m}): " for m in ("mid2", "mid2 vmem7", "mid4", "feat")]
    prefixes += ["plane 8192 (geometry): ",
                 "plane 8192 (feature): ", "ndt 1M (p2d): ", "ndt 1M (d2d): ", "horn_align 8192 points",
                 "voxel_nn 8192 queries", "register_batch 3 x 1000: ", "register_batch_block 2 x 8192: ",
                 "register_pyramid 8192 points"]
    for prefix in prefixes:
        assert any(line.startswith(prefix) for line in lines), prefix
    # the odometry phases: each kernel of the path launched where it must be
    # (the 8,192-point compiled run: 4 normals builds, 3 source builds at
    # q-tile 128 and the keyframe builds at 128, 4 levels each)
    assert nn["launches_odometry"] >= 3 and fold["launches_odometry"] >= 3
    assert sort["launches_odometry"] >= 4 * 4 + 3 * 4 + 4
    for prefix in ("compiled odometry 8192 x 4: ATE ", "compiled odometry 8192 x 4 profiled: ",
                   "compiled odometry 8192 x 4 KD builds through the sort kernel equal the plain",
                   "compiled odometry 2048 x 4 (brute): ATE ",
                   "compiled odometry 2048 x 4 (brute): nn kernel vs plain on frame 1's operands",
                   "compiled odometry 8192 x 3 card vs CPU: keyframes equal",
                   "host odometry 8192: fold6 kernel vs plain on frame 1's query tiles",
                   "host odometry 8192 x 4 (scan_to_keyframe): ATE ",
                   "host odometry 8192 x 4 (scan_to_map, sliding_window): ATE ",
                   "host odometry 8192 x 4 stall watchdog ", "host odometry resume: ",
                   "odometry phases: "):
        assert any(line.startswith(prefix) for line in lines), prefix
    # the command line over files: every step of the CLI phase printed its line
    for prefix in ("cli native reader: ", "cli cat pair: info and convert of cat.ply, cat.xyz, cat.pcd",
                   "cli cat register (", "cli perturb + horn: ", "cli flagship 8192 (",
                   "cli odometry --compiled (4 x 8192-point", "cli prefetch_kitti: 4 scans in order",
                   "cli odometry --synthetic (4 x 8192", "cli odometry --resume: ",
                   "cli fresh process: ", "cli phase: "):
        assert any(line.startswith(prefix) for line in lines), prefix
    # n_slam at the reference test's 2,048 points: the loop runs once, at its gate
    slam = [line for line in lines if line.startswith("slam 2048 x 30 (two laps): ")]
    assert len(slam) == 1 and slam[0].endswith("(gate 0.7 x)")
    for kernel in ("fold6", "fold7", "select"):  # the mid phase's shapes on each kernel's line
        assert any(line.startswith(f"{kernel} kernel vs plain") and "the mid phase's shapes" in line
                   for line in lines), kernel


@pytest.mark.parametrize("where", ("key", "xyz", "orig"))
def test_sort_phase_reports_the_measured_difference(where, monkeypatch):
    """The sort phase's max_abs_err is the largest |difference| it measured
    between kernel and plain version, over the key and every payload: a
    kernel off by 0.5 in one element fails the phase with that number."""
    def off_by_half(key, payloads):
        out = list(sort_cuda.sort_segments_reference(key, payloads))
        i = ("key", "xyz", "orig").index(where)
        out[i] = out[i].clone()
        out[i].view(-1)[0] += 0.5 if out[i].is_floating_point() else 1
        return tuple(out)

    monkeypatch.setattr(sort_cuda, "sort_cuda", off_by_half)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    want = "5.000e-01" if where != "orig" else "1.000e+00"
    with pytest.raises(RuntimeError, match="sort fixture: .*" + re.escape(f"max |diff| {want})")):
        chip_smoke._phase_sort(torch.device("cpu"), {128: [(4, 256)], 64: [(8, 128)]})

"""Port parity: the `odometry` subcommand of `icpx_torch.cli` against
`icpx.cli`'s, on the CPU.

The counterparts of tests/test_cli.py's odometry tests and of
tests/test_additions.py::test_cli_odometry_loop_closure, plus `--compiled`
from a velodyne directory: the same arguments through both CLIs (the
port's with ``--device cpu``), printed counts equal, ATE to 1e-3 (the
tolerance of the odometry parity files for the brute path at 1,024-point
scans), checkpoints' keyframes, edges and poses. The other subcommands are
in tests/test_torch_cli.py.
"""

import numpy as np
import pytest

import icpx.cli as j_cli
import icpx_torch.cli as t_cli
from icpx.utils.checkpoint import OdometryCheckpoint as JCheckpoint
from icpx_torch.utils.checkpoint import OdometryCheckpoint
from torch_parity import cli_ate, cli_counts_line, cli_refuses, run_both

POSE_TOL = 1e-3


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    # the JAX CLI's persistent compile cache would write under $HOME
    monkeypatch.setenv("ICPX_NO_COMPILE_CACHE", "1")


def _poses(path, load):
    ck = load(path)
    return ck.poses_R, ck.poses_t


def test_odometry_synthetic(tmp_path, capsys):
    jout, tout, jd, td = run_both(capsys, lambda d: [
        "odometry", "--synthetic", "--frames", "5", "--points-per-scan", "1024",
        "--metrics", str(d / "odo.jsonl"), "--checkpoint", str(d / "odo.npz")], tmp_path)
    assert "5 frames" in tout and cli_counts_line(tout) == cli_counts_line(jout)
    assert abs(cli_ate(tout) - cli_ate(jout)) <= POSE_TOL
    assert len((td / "odo.jsonl").read_text().splitlines()) == 5
    for a, b in zip(_poses(td / "odo.npz", OdometryCheckpoint.load),
                    _poses(jd / "odo.npz", JCheckpoint.load)):
        np.testing.assert_allclose(a, b, atol=POSE_TOL)
    # either package resumes from the other's checkpoint: the keys are the same
    assert OdometryCheckpoint.load(jd / "odo.npz").frame_index == 4


def test_bad_odometry_args():
    for main, extra in ((j_cli.main, []), (t_cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit):
            main(extra + ["odometry"])  # no source given


def test_odometry_cli_resume_matches_full(tmp_path, capsys):
    """The port's --resume continues a killed run to the same trajectory,
    as the reference's does, and that trajectory is the reference's."""
    common = ["--device", "cpu", "odometry", "--synthetic", "--points-per-scan", "1024"]
    ck_full, ck_part, ck_res = (tmp_path / n for n in ("full.npz", "part.npz", "resumed.npz"))
    assert t_cli.main(common + ["--frames", "8", "--checkpoint", str(ck_full)]) == 0
    assert t_cli.main(common + ["--frames", "5", "--checkpoint", str(ck_part)]) == 0
    assert t_cli.main(common + ["--frames", "8", "--resume", str(ck_part),
                                "--checkpoint", str(ck_res)]) == 0
    assert "resuming from" in capsys.readouterr().out
    full, res = OdometryCheckpoint.load(ck_full), OdometryCheckpoint.load(ck_res)
    np.testing.assert_allclose(res.poses_t, full.poses_t, atol=1e-6)
    np.testing.assert_allclose(res.poses_R, full.poses_R, atol=1e-6)
    assert [e[:2] for e in res.edges] == [e[:2] for e in full.edges]
    ck_j = tmp_path / "jax_full.npz"
    assert j_cli.main(common[2:] + ["--frames", "8", "--checkpoint", str(ck_j)]) == 0
    ref = JCheckpoint.load(ck_j)
    np.testing.assert_array_equal(full.is_keyframe, ref.is_keyframe)
    assert [e[:2] for e in full.edges] == [e[:2] for e in ref.edges]
    # Frames 0-4 agree to ~2e-6. Frame 5 registered onto keyframe 4 from
    # the same initial pose already differs by 2.5e-4 between the packages
    # (12 iterations each; the pairs before and after it agree to 1e-6):
    # near-tie correspondences of these sparse 1,024-point scans, scored in
    # each package's own fp32 distance form, flip. Carried on, the gap is
    # 3.7e-3 m from frame 5 on.
    np.testing.assert_allclose(full.poses_t[:5], ref.poses_t[:5], atol=POSE_TOL)
    np.testing.assert_allclose(full.poses_R[:5], ref.poses_R[:5], atol=POSE_TOL)
    np.testing.assert_allclose(full.poses_t, ref.poses_t, atol=5e-3)
    np.testing.assert_allclose(full.poses_R, ref.poses_R, atol=5e-3)


def test_compiled_rejects_host_only_flags(tmp_path):
    base = ["odometry", "--synthetic", "--frames", "4", "--points-per-scan", "512", "--compiled"]
    cli_refuses(base + ["--resume", str(tmp_path / "x.npz")], "--compiled does not support")
    cli_refuses(base + ["--dynamic-sigma", "3.0"], "dynamic-sigma")


def test_odometry_scan_to_map_cli(tmp_path, capsys):
    jout, tout, _, _ = run_both(capsys, lambda d: [
        "odometry", "--synthetic", "--frames", "5", "--points-per-scan", "1024",
        "--mode", "scan_to_map", "--map-cell", "0.2", "--map-capacity", "16384"], tmp_path)
    assert "5 frames" in tout and cli_counts_line(tout) == cli_counts_line(jout)
    assert abs(cli_ate(tout) - cli_ate(jout)) <= POSE_TOL


def test_compiled_rejects_scan_to_map():
    cli_refuses(["odometry", "--synthetic", "--frames", "4", "--points-per-scan", "512",
               "--compiled", "--mode", "scan_to_map"], "scan_to_map")


def _velodyne_dir(tmp_path):
    """tests/test_cli.py's KITTI-format sequence: 6 scans of 2,048 points
    with a reflectance channel, and the poses relative to the first."""
    import torch

    from icpx_torch.odometry.kitti import (make_trajectory, make_world, simulate_scans,
                                           write_kitti_sequence)

    world = make_world(n_points=60000, extent=25.0, seed=0, n_posts=120, ground_frac=0.5)
    gt = make_trajectory(6, speed=0.6, turn=0.02, device="cpu")
    frames = simulate_scans(world, gt, max_range=15.0, points_per_scan=2048, noise=0.01, seed=1,
                            device="cpu")
    frames = [f.replace(feats=torch.abs(f.xyz[:, 2:3]) % 1.0, feat_names=("reflectance",))
              for f in frames]
    vel, poses = tmp_path / "velodyne", tmp_path / "poses.txt"
    write_kitti_sequence(vel, frames, [gt[0].inverse() @ g for g in gt], poses_path=poses)
    return vel, poses, frames


def test_odometry_velodyne_dir_end_to_end(tmp_path, capsys):
    vel, poses, frames = _velodyne_dir(tmp_path)
    raw = np.fromfile(vel / "000000.bin", dtype=np.float32)
    assert raw.size % 4 == 0 and raw.size // 4 == int(frames[0].num_valid())
    jout, tout, _, _ = run_both(capsys, lambda d: [
        "odometry", "--velodyne-dir", str(vel), "--poses", str(poses), "--frames", "6",
        "--keyframe-trans", "0.5"], tmp_path)
    assert "6 frames" in tout and cli_counts_line(tout) == cli_counts_line(jout)
    assert cli_ate(tout) < 0.3 and abs(cli_ate(tout) - cli_ate(jout)) <= POSE_TOL


def test_odometry_compiled_matches_jax(tmp_path, capsys):
    """--compiled (the whole-sequence path, brute at 1,024 points) from a
    velodyne directory: keyframes and edges equal, ATE within 1e-3."""
    vel, poses, _ = _velodyne_dir(tmp_path)
    jout, tout, jd, td = run_both(capsys, lambda d: [
        "odometry", "--velodyne-dir", str(vel), "--poses", str(poses), "--compiled",
        "--max-iters", "10", "--keyframe-trans", "0.5", "--checkpoint", str(d / "c.npz")], tmp_path)
    assert cli_counts_line(tout) == cli_counts_line(jout)
    assert abs(cli_ate(tout) - cli_ate(jout)) <= POSE_TOL
    tck, jck = OdometryCheckpoint.load(td / "c.npz"), JCheckpoint.load(jd / "c.npz")
    np.testing.assert_array_equal(tck.is_keyframe, jck.is_keyframe)
    assert [e[:2] for e in tck.edges] == [e[:2] for e in jck.edges]
    np.testing.assert_allclose(tck.poses_t, jck.poses_t, atol=POSE_TOL)


def test_cli_odometry_loop_closure(tmp_path, capsys):
    jout, tout, _, _ = run_both(capsys, lambda d: [
        "odometry", "--synthetic", "--frames", "6", "--points-per-scan", "1024",
        "--loop-closure"], tmp_path)
    lc = [line for line in tout.splitlines() if line.startswith("loop closures:")]
    assert lc and lc == [line for line in jout.splitlines() if line.startswith("loop closures:")]
    assert abs(cli_ate(tout) - cli_ate(jout)) <= POSE_TOL

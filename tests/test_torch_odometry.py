"""Port parity: the odometry layer against `icpx`, on the reference tests'
fixtures (2,048-point scans of `make_world(60000, 30.0)` along
`make_trajectory(10, speed=0.6, turn=0.04)`).

* kitti: the simulator's worlds, trajectories and scans bit-equal (with
  and without occlusion, dropout and intensity); KITTI files written by
  either package load in the port to the same bits;
* evaluate: `ate_rmse`, `rpe`, `kitti_relative_error` to 1e-6;
* the frontend: `blend_velocity` to 1e-6; `run_odometry` in both modes,
  with a pyramid and with dynamic masking (the sliding-window back end in
  tests/test_torch_posegraph.py): keyframes and
  edges equal, poses within POSE_TOL. POSE_TOL is 1e-3 m / rad, not 1e-4:
  these sparse scans' registrations move by 5.5e-4 m when the reference's
  own initial pose moves by 1e-7 m (ROADMAP queue 3);
* mapping: `insert_scan` bit-equal on identity poses and on world-frame
  points handed over as the same bits; under a general pose the rows that
  land in another voxel are counted and bounded;
* checkpoint: bit-exact resume, and a checkpoint the JAX package saved
  resuming in the port (the keys shared both ways: test_torch_posegraph);
* the stall watchdog.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icpx.cloud import PointCloud as JCloud
from icpx.geometry.se3 import SE3 as JSE3
from icpx.io.loaders import synthetic_surface
from icpx.kernels.normals import estimate_normals as j_normals
from icpx.odometry import evaluate as j_eval
from icpx.odometry import kitti as j_kitti
from icpx.odometry.frontend import OdometryConfig as JOdoConfig
from icpx.odometry.frontend import blend_velocity as j_blend
from icpx.odometry.frontend import run_odometry as j_run_odometry
from icpx.odometry.mapping import VoxelMap as JVoxelMap
from icpx.odometry.mapping import insert_scan as j_insert
from icpx.registration.icp import ICPConfig as JConfig
from icpx.utils.checkpoint import OdometryCheckpoint as JCheckpoint
from icpx_torch import interop
from icpx_torch.distributed import fault
from icpx_torch.geometry.se3 import SE3
from icpx_torch.odometry import evaluate, kitti
from icpx_torch.odometry.frontend import blend_velocity, run_odometry
from icpx_torch.odometry.mapping import VoxelMap, insert_scan
from icpx_torch.utils.checkpoint import OdometryCheckpoint
from torch_parity import to_np, torch_cloud, torch_odometry_config, torch_se3

POSE_TOL = 1e-3
ICP = JConfig(objective="symmetric", max_iters=12, diff_threshold=0.0, rmse_change_tol=1e-6,
              robust="huber", max_corr_dist=2.0)
FRONTEND = {
    # (frames, config)
    "keyframe": (10, JOdoConfig(icp=ICP, keyframe_trans=1.0, keyframe_rot=0.2)),
    "map": (10, JOdoConfig(icp=ICP, keyframe_trans=1.0, keyframe_rot=0.2, mode="scan_to_map",
                           map_capacity=8192, map_cell=0.15)),
    "pyramid": (6, JOdoConfig(icp=ICP, keyframe_trans=1.0, keyframe_rot=0.2, pyramid_levels=2)),
    "dynamic": (6, JOdoConfig(icp=ICP, keyframe_trans=0.5, keyframe_rot=0.15,
                              dynamic_sigma=3.0)),
}


@pytest.fixture(scope="module")
def seq():
    """The sequence as JAX clouds with JAX normals, the same as port clouds,
    and the ground truth."""
    world = j_kitti.make_world(n_points=60000, extent=30.0, seed=0)
    gt = j_kitti.make_trajectory(10, speed=0.6, turn=0.04)
    frames = j_kitti.simulate_scans(world, gt, max_range=18.0, points_per_scan=2048,
                                    noise=0.01, seed=1)
    frames = [j_normals(f, k=10) for f in frames]
    return frames, [torch_cloud(f) for f in frames], gt


@pytest.fixture(scope="module")
def frontend_runs(seq):
    """Each frontend case run once by both packages."""
    jf, tf, _ = seq
    cache = {}

    def get(case):
        if case not in cache:
            n, cfg = FRONTEND[case]
            cache[case] = (j_run_odometry(jf[:n], cfg),
                           run_odometry(tf[:n], torch_odometry_config(cfg)))
        return cache[case]

    return get


def _assert_poses_close(jposes, tposes, tol=POSE_TOL):
    assert len(jposes) == len(tposes)
    for a, b in zip(jposes, tposes):
        np.testing.assert_allclose(to_np(b.t), np.asarray(a.t), atol=tol)
        np.testing.assert_allclose(to_np(b.R), np.asarray(a.R), atol=tol)


def _assert_same_run(a, b, exact=False):
    """Two port runs: equal bit for bit (exact) or keyframes and edges."""
    assert a.is_keyframe == b.is_keyframe and a.keyframe_indices == b.keyframe_indices
    assert [(i, j) for i, j, _ in a.edges] == [(i, j) for i, j, _ in b.edges]
    if exact:
        for p, q in zip(a.poses + [e[2] for e in a.edges], b.poses + [e[2] for e in b.edges]):
            assert torch.equal(p.R, q.R) and torch.equal(p.t, q.t)


# ---- kitti ------------------------------------------------------------------------------

SIM_OPTIONS = {
    "default": {},
    "occlusion, dropout": dict(occlusion=True, dropout=0.2),
    "intensity": dict(with_intensity=True),
}


@pytest.mark.parametrize("opt", list(SIM_OPTIONS))
def test_simulator_bit_equal(opt):
    world = j_kitti.make_world(n_points=20000, extent=20.0, seed=3, n_posts=40)
    assert np.array_equal(world, kitti.make_world(n_points=20000, extent=20.0, seed=3, n_posts=40))
    jt = j_kitti.make_trajectory(4, speed=0.8, turn=0.05)
    tt = kitti.make_trajectory(4, speed=0.8, turn=0.05, device="cpu")
    for a, b in zip(jt, tt):
        assert np.array_equal(np.asarray(a.R), to_np(b.R)) and np.array_equal(np.asarray(a.t), to_np(b.t))
    kw = dict(max_range=15.0, points_per_scan=1024, noise=0.01, seed=5, **SIM_OPTIONS[opt])
    for a, b in zip(j_kitti.simulate_scans(world, jt, **kw),
                    kitti.simulate_scans(world, tt, device="cpu", **kw)):
        assert np.array_equal(np.asarray(a.xyz), to_np(b.xyz))
        assert np.array_equal(np.asarray(a.mask), to_np(b.mask))
        assert a.feat_names == b.feat_names
        if a.feats is not None:
            assert np.array_equal(np.asarray(a.feats), to_np(b.feats))


def test_kitti_files_round_trip_between_packages(seq, tmp_path):
    """The JAX package's KITTI files load in the port to the reference's
    bits, and the port's own files load back to the clouds it wrote."""
    jf, tf, gt = seq
    j_kitti.write_kitti_sequence(tmp_path / "jax" / "velodyne", jf[:3], gt[:3])
    jl = j_kitti.load_kitti_sequence(tmp_path / "jax" / "velodyne")
    tl = kitti.load_kitti_sequence(tmp_path / "jax" / "velodyne", device="cpu")
    for a, b in zip(jl, tl):
        assert np.array_equal(np.asarray(a.xyz), to_np(b.xyz))
        assert np.array_equal(np.asarray(a.mask), to_np(b.mask))
    for a, b in zip(j_kitti.load_kitti_poses(tmp_path / "jax" / "poses.txt"),
                    kitti.load_kitti_poses(tmp_path / "jax" / "poses.txt", device="cpu")):
        assert np.array_equal(np.asarray(a.R), to_np(b.R)) and np.array_equal(np.asarray(a.t), to_np(b.t))
    kitti.write_kitti_sequence(tmp_path / "port" / "velodyne", tf[:3],
                               [torch_se3(g) for g in gt[:3]])
    back = kitti.load_kitti_sequence(tmp_path / "port" / "velodyne", device="cpu",
                                     with_intensity=True)
    for a, b in zip(tf[:3], back):
        assert np.array_equal(a.to_numpy(), b.to_numpy())
        assert b.feat_names == ("reflectance",) and not b.feats.any()
    assert np.array_equal(kitti.load_kitti_scan(tmp_path / "port" / "velodyne" / "000001.bin"),
                          tf[1].to_numpy())


# ---- evaluate ---------------------------------------------------------------------------


def _trajectories(n, seed):
    """A ground truth and a drifting estimate of it, (JAX, port) each."""
    rng = np.random.default_rng(seed)
    gt = j_kitti.make_trajectory(n, speed=1.5, turn=0.03)
    est = []
    for g in gt:
        axis = rng.normal(size=3)
        d = JSE3.from_axis_angle(jnp.asarray(axis / np.linalg.norm(axis), jnp.float32),
                                 float(rng.uniform(0, 0.02)),
                                 jnp.asarray(rng.normal(0, 0.05, 3), jnp.float32))
        est.append(g @ d)
    return (gt, est), ([torch_se3(g) for g in gt], [torch_se3(e) for e in est])


@pytest.mark.parametrize("metric", ["ate aligned", "ate", "rpe 1", "rpe 3", "kitti"])
def test_metrics_match_jax(metric):
    (jgt, jest), (tgt, test) = _trajectories(120, 7)
    if metric.startswith("ate"):
        align = metric == "ate aligned"
        want = (j_eval.ate_rmse(jest, jgt, align=align),)
        got = (evaluate.ate_rmse(test, tgt, align=align),)
    elif metric.startswith("rpe"):
        d = int(metric.split()[1])
        want, got = j_eval.rpe(jest, jgt, delta=d), evaluate.rpe(test, tgt, delta=d)
    else:
        kw = dict(lengths=(20.0, 50.0, 100.0), step=5)
        want = j_eval.kitti_relative_error(jest, jgt, **kw)
        got = evaluate.kitti_relative_error(test, tgt, **kw)
        assert all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # and a batched SE3 gives the same as a list
    if metric == "ate":
        stacked = SE3(R=torch.stack([p.R for p in test]), t=torch.stack([p.t for p in test]))
        assert evaluate.ate_rmse(stacked, tgt, align=False) == got[0]


# ---- the frontend -----------------------------------------------------------------------


@pytest.mark.parametrize("damping, adaptive", [(1.0, True), (0.7, True), (1.0, False)])
def test_blend_velocity_matches_jax(damping, adaptive):
    rng = np.random.default_rng(2)
    for _ in range(4):
        tw = [rng.normal(0, s, 6).astype(np.float32) for s in (0.05, 0.3)]
        ja, jb = JSE3.exp(jnp.asarray(tw[0])), JSE3.exp(jnp.asarray(tw[1]))
        want = j_blend(ja, jb, damping=damping, adaptive=adaptive)
        got = blend_velocity(torch_se3(ja), torch_se3(jb), damping=damping, adaptive=adaptive)
        np.testing.assert_allclose(to_np(got.R), np.asarray(want.R), atol=1e-6)
        np.testing.assert_allclose(to_np(got.t), np.asarray(want.t), atol=1e-6)


@pytest.mark.parametrize("case", list(FRONTEND))
def test_run_odometry_matches_jax(case, frontend_runs, seq):
    jres, tres = frontend_runs(case)
    assert tres.is_keyframe == jres.is_keyframe
    assert tres.keyframe_indices == jres.keyframe_indices
    assert [(i, j) for i, j, _ in tres.edges] == [(i, j) for i, j, _ in jres.edges]
    np.testing.assert_allclose(tres.rmse, jres.rmse, atol=1e-3)
    _assert_poses_close(jres.poses, tres.poses)
    _assert_poses_close([e[2] for e in jres.edges], [e[2] for e in tres.edges])
    assert tres.motion.model_warm == jres.motion.model_warm
    assert tres.motion.consecutive_rejects == jres.motion.consecutive_rejects
    if case == "dynamic":
        # the scrub's masks: a row whose residual sits on sigma x median
        # can go either way, so count the rows that differ
        diff = sum(int((a != b).sum()) for a, b in zip(jres.keyframe_masks, tres.keyframe_masks))
        assert diff <= 4, diff
        assert all(m.sum() < f.num_valid() for m, f in zip(tres.keyframe_masks[1:], seq[1]))


# ---- mapping ----------------------------------------------------------------------------


def _surface_scans(n_scans, n=1024, scale=1.0, feats=False):
    out = []
    for k in range(n_scans):
        xyz = synthetic_surface(n, seed=k) * scale
        f = np.linspace(0.0, 1.0, n, dtype=np.float32)[:, None] if feats else None
        c = JCloud.create(xyz, feats=f, feat_names=("intensity",) if feats else None)
        out.append(j_normals(c, k=8))
    return out


def _map_equal(jm, tm):
    d = interop.voxel_map_to_numpy(tm)
    for f in ("xyz", "normals", "mask", "age", "counter"):
        assert np.array_equal(d[f], np.asarray(getattr(jm, f))), f
    if jm.feats is not None:
        assert np.array_equal(d["feats"], np.asarray(jm.feats))


@pytest.mark.parametrize("cap, cell, feats", [(4096, 0.05, False), (512, 0.01, False),
                                              (2048, 0.5, True)])
def test_insert_scan_bit_equal_on_identity(cap, cell, feats):
    scans = _surface_scans(3, feats=feats)
    names = ("intensity",) if feats else None
    jm = JVoxelMap.create(cap, cell, feat_names=names)
    tm = VoxelMap.create(cap, cell, feat_names=names, device="cpu")
    for s in scans + scans[:1]:  # the last insert repeats the first scan
        jm = j_insert(jm, s, JSE3.identity())
        tm = insert_scan(tm, torch_cloud(s), SE3.identity(device="cpu"))
        _map_equal(jm, tm)


def test_insert_scan_bit_equal_on_world_points_and_from_jax_map():
    """World-frame points made by the JAX package, handed over as the same
    bits, insert the same; and a map the JAX package built continues in
    the port through `interop.voxel_map_from_numpy`."""
    scans = _surface_scans(3, scale=4.0)
    poses = [JSE3.from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]), 0.3 * k,
                                  jnp.asarray([0.5 * k, -0.2 * k, 0.1])) for k in range(3)]
    jm = JVoxelMap.create(4096, 0.1)
    tm = VoxelMap.create(4096, 0.1, device="cpu")
    for s, p in zip(scans, poses):
        w = s.replace(xyz=jnp.where(s.mask[:, None], p.apply(s.xyz), s.xyz),
                      normals=p.rotate(s.normals))
        jm = j_insert(jm, w, JSE3.identity())
        tm = insert_scan(tm, torch_cloud(w), SE3.identity(device="cpu"))
        _map_equal(jm, tm)
    more = _surface_scans(4, scale=4.0)[3]
    _map_equal(j_insert(jm, more, JSE3.identity()),
               insert_scan(interop.voxel_map_from_numpy(jm, device="cpu"), torch_cloud(more),
                           SE3.identity(device="cpu")))


def test_insert_scan_general_pose_voxel_wall_rows():
    """Under a general pose each package rounds `pose.apply` its own way;
    a point within an ulp of a voxel wall can land in the neighbour cell.
    Count those rows: the maps agree on all but a few."""
    scans = _surface_scans(3, scale=4.0)
    poses = [JSE3.from_axis_angle(jnp.asarray([0.3, -0.2, 0.93]) / np.linalg.norm([0.3, -0.2, 0.93]),
                                  0.7 * k + 0.1, jnp.asarray([1.3 * k, -0.7, 0.21])) for k in range(3)]
    jm = JVoxelMap.create(4096, 0.05)
    tm = VoxelMap.create(4096, 0.05, device="cpu")
    for s, p in zip(scans, poses):
        jm = j_insert(jm, s, p)
        tm = insert_scan(tm, torch_cloud(s), torch_se3(p))
    a = np.asarray(jm.xyz)[np.asarray(jm.mask)]
    b = to_np(tm.xyz)[to_np(tm.mask)]
    cells_a = {tuple(r) for r in np.floor(a / 0.05).astype(np.int64).tolist()}
    cells_b = {tuple(r) for r in np.floor(b / 0.05).astype(np.int64).tolist()}
    assert abs(len(a) - len(b)) <= 4 and len(cells_a ^ cells_b) <= 8, (len(a), len(b),
                                                                        len(cells_a ^ cells_b))
    np.testing.assert_allclose(np.sort(a, axis=0), np.sort(b, axis=0), atol=1e-5) \
        if len(a) == len(b) else None


def test_voxel_map_refuses_mismatched_channels():
    scan = torch_cloud(_surface_scans(1, feats=True)[0])
    with pytest.raises(ValueError, match="payload channels"):
        insert_scan(VoxelMap.create(1024, 0.1, device="cpu"), scan, SE3.identity(device="cpu"))


# ---- checkpoint -------------------------------------------------------------------------


@pytest.mark.parametrize("case, cut", [("keyframe", 6), ("dynamic", 3)])
def test_resume_is_bit_exact(case, cut, frontend_runs, seq, tmp_path):
    """A run resumed from its own checkpoint, saved to disk mid-run, equals
    the uninterrupted run bit for bit (the sliding window's case is in
    tests/test_torch_posegraph.py)."""
    _, full = frontend_runs(case)
    n, cfg = FRONTEND[case]
    cfg = torch_odometry_config(cfg)
    part = run_odometry(seq[1][:cut], cfg)
    OdometryCheckpoint.from_result(part).save(tmp_path / "ck.npz")
    resumed = run_odometry(seq[1][:n], cfg, resume=OdometryCheckpoint.load(tmp_path / "ck.npz"))
    _assert_same_run(full, resumed, exact=True)


def test_jax_checkpoint_resumes_in_the_port(frontend_runs, seq, tmp_path):
    """The JAX package's run of the first 6 frames, saved by it, resumes in
    the port: the same keyframes and edges as the port's uninterrupted run,
    poses within POSE_TOL."""
    jf, tf, _ = seq
    cfg = FRONTEND["keyframe"][1]
    JCheckpoint.from_result(j_run_odometry(jf[:6], cfg)).save(tmp_path / "jax.npz")
    resumed = run_odometry(tf, torch_odometry_config(cfg),
                           resume=OdometryCheckpoint.load(tmp_path / "jax.npz"))
    _, full = frontend_runs("keyframe")
    _assert_same_run(full, resumed)
    _assert_poses_close(full.poses, resumed.poses)


# ---- the watchdog -----------------------------------------------------------------------


def test_guarded_call_passes_and_raises():
    assert fault.guarded_call(lambda: 41 + 1, timeout_s=5.0) == 42
    assert fault.guarded_call(lambda: "inline", timeout_s=0.0) == "inline"
    with pytest.raises(fault.CollectiveStallError):
        fault.guarded_call(lambda: __import__("time").sleep(30.0), timeout_s=0.4)
    with pytest.raises(ValueError, match="boom"):
        fault.guarded_call(lambda: (_ for _ in ()).throw(ValueError("boom")), timeout_s=5.0)


def test_heartbeat_detects_a_stall_and_clears_on_a_beat():
    stalls = []
    with fault.HeartbeatMonitor(timeout_s=0.3, on_stall=lambda: stalls.append(1)) as mon:
        mon.beat(torch.ones(4))
        __import__("time").sleep(0.8)
        assert mon.stalled and stalls
        mon.beat()
        assert not mon.stalled


def test_default_stall_timeout_follows_the_data():
    assert fault.default_stall_timeout("cpu") == 0.0
    assert fault.default_stall_timeout("cuda:0") == 600.0
    assert fault.default_stall_timeout(torch.device("cuda", 0), warmup=True) == 1200.0
    assert fault.default_stall_timeout() == 600.0  # the port's default device

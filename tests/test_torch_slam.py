"""Port parity: place recognition and loop closure against `icpx`, on
tests/test_slam.py's worlds (`make_world(80000, 25.0)`, 2,048-point scans
at 14 m range, noise 0.02).

Held: ring descriptors and sector profiles to 1e-5 (single and batched),
`relative_yaw` equal, `descriptor_distance` to 1e-6; the verified
loop-closure edge sets equal, their transforms and RMSEs within 1e-3
(the verification registers sparse scans on the brute path, where the
reference itself moves by 5.5e-4 m under a 1e-7 m change of its initial
pose, ROADMAP queue 3); and on a drifted two-lap loop, both pose-graph
solvers given the closures lower the keyframes' ATE, as
tests/test_slam.py::test_loop_closure_pose_graph_reduces_ate requires.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icpx.geometry.se3 import SE3 as JSE3
from icpx.odometry import placerec as jpr
from icpx.odometry.kitti import make_world, simulate_scans
from icpx.odometry.loopclosure import LoopClosureConfig as JLCConfig
from icpx.odometry.loopclosure import detect_loop_closures as j_detect
from icpx.registration.icp import ICPConfig as JConfig
from icpx_torch.geometry.se3 import SE3
from icpx_torch.odometry import placerec
from icpx_torch.odometry.evaluate import ate_rmse
from icpx_torch.odometry.loopclosure import LoopClosureConfig, detect_loop_closures
from icpx_torch.odometry.posegraph import (PoseGraph, optimize_pose_graph,
                                          optimize_pose_graph_sparse)
from icpx_torch.registration.icp import ICPConfig
from torch_parity import to_np, torch_cloud, torch_config, torch_se3

TOL = 1e-3


def _port_config(jcfg):
    d = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    d["icp"] = torch_config(jcfg.icp)
    return LoopClosureConfig(**d)


@pytest.fixture(scope="module")
def clouds():
    """Four scans of one world from four poses: (JAX clouds, port clouds)."""
    world = make_world(n_points=80000, extent=25.0, seed=2)
    poses = [JSE3.from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]), 0.7 * k,
                                  jnp.asarray([2.0 * k, -k, 1.2], jnp.float32)) for k in range(4)]
    jf = simulate_scans(world, poses, max_range=14.0, points_per_scan=2048, noise=0.02, seed=3)
    return jf, [torch_cloud(f) for f in jf]


@pytest.mark.parametrize("max_range", [None, 10.0])
def test_place_descriptor_matches_jax(clouds, max_range):
    jf, tf = clouds
    kw = dict(n_rings=12, n_sectors=48, max_range=max_range)
    for a, b in zip(jf, tf):
        jd, jp = jpr.place_descriptor(a.xyz, a.mask, **kw)
        td, tp_ = placerec.place_descriptor(b.xyz, b.mask, **kw)
        np.testing.assert_allclose(to_np(td), np.asarray(jd), atol=1e-5)
        np.testing.assert_allclose(to_np(tp_), np.asarray(jp), atol=1e-5)
    # the batched form is each cloud's alone
    bd, bp = placerec.place_descriptor(torch.stack([c.xyz for c in tf]),
                                       torch.stack([c.mask for c in tf]), **kw)
    for k, c in enumerate(tf):
        d, p = placerec.cloud_descriptor(c, **kw)
        assert torch.equal(bd[k], d) and torch.equal(bp[k], p)


def test_descriptor_ignores_masked_padding(clouds):
    _, tf = clouds
    c = tf[0]
    junk = c.replace(xyz=torch.where(c.mask[:, None], c.xyz, 50.0))
    for x, y in zip(placerec.cloud_descriptor(c), placerec.cloud_descriptor(junk)):
        assert torch.equal(x, y)


def test_relative_yaw_and_distance_match_jax(clouds):
    jf, tf = clouds
    jd = [jpr.cloud_descriptor(c) for c in jf]
    td = [placerec.cloud_descriptor(c) for c in tf]
    for i in range(4):
        for j in range(4):
            assert float(placerec.relative_yaw(td[i][1], td[j][1])) == pytest.approx(
                float(jpr.relative_yaw(jd[i][1], jd[j][1])), abs=1e-6)
            np.testing.assert_allclose(
                float(placerec.descriptor_distance(td[i][0], td[j][0])),
                float(jpr.descriptor_distance(jd[i][0], jd[j][0])), rtol=1e-6, atol=1e-6)


def _assert_same_closures(je, te):
    assert [(i, j) for i, j, _, _ in te] == [(i, j) for i, j, _, _ in je]
    for (_, _, a, ra), (_, _, b, rb) in zip(je, te):
        np.testing.assert_allclose(to_np(b.t), np.asarray(a.t), atol=TOL)
        np.testing.assert_allclose(to_np(b.R), np.asarray(a.R), atol=TOL)
        assert abs(rb - ra) < TOL


def test_closure_beyond_drift_gate_matches_jax():
    """tests/test_slam.py::test_closure_found_beyond_drift_gate: a revisit
    with 8 m of believed drift is found through the appearance channel
    with a yaw seed, by both packages alike; position-only finds nothing."""
    world = make_world(n_points=80000, extent=25.0, seed=5)
    a = JSE3.identity().replace(t=jnp.asarray([0.0, 0.0, 1.2]))
    c, s = np.cos(0.9), np.sin(0.9)
    b = JSE3(R=jnp.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], jnp.float32),
             t=jnp.asarray([0.3, -0.2, 1.2]))
    mids = [JSE3.identity().replace(t=jnp.asarray([6.0 + 2.0 * k, 4.0, 1.2], jnp.float32))
            for k in range(5)]
    true = [a] + mids + [b]
    jf = simulate_scans(world, true, max_range=14.0, points_per_scan=2048, noise=0.02, seed=7)
    believed = list(true)
    believed[-1] = believed[-1].replace(t=believed[-1].t + jnp.asarray([8.0, 3.0, 0.0]))
    tf = [torch_cloud(f) for f in jf]
    tb = [torch_se3(p) for p in believed]
    for cfg in (JLCConfig(min_separation=3, max_candidate_dist=3.0, max_descriptor_dist=0.25,
                          accept_rmse=0.12),
                JLCConfig(min_separation=3, max_candidate_dist=3.0, max_descriptor_dist=0.0)):
        je = j_detect(believed, jf, cfg)
        te = detect_loop_closures(tb, tf, _port_config(cfg))
        _assert_same_closures(je, te)
        assert ((0, 6) in [(i, j) for i, j, _, _ in te]) == (cfg.max_descriptor_dist > 0)


def _loop_poses(n, radius=6.0, laps=2.0):
    out = []
    for k in range(n):
        th = laps * 2 * np.pi * k / (n - 1)
        c, s = np.cos(th), np.sin(th)
        out.append(JSE3(R=jnp.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], jnp.float32),
                        t=jnp.asarray([radius * np.sin(th), radius * (1 - np.cos(th)), 1.2],
                                      jnp.float32)))
    return out


def test_loop_closure_pose_graph_reduces_ate():
    """Keyframes on tests/test_slam.py's two-lap loop, believed poses with
    accumulated drift: both packages verify the same closures, and the
    port's dense and sparse solvers, given the odometry chain and the
    closures, bring the keyframes' ATE below 0.7 x the drifted one."""
    world = make_world(n_points=80000, extent=25.0, seed=2)
    gt = _loop_poses(16)
    jf = simulate_scans(world, gt, max_range=14.0, points_per_scan=2048, noise=0.02, seed=3)
    rng = np.random.default_rng(11)
    # believed poses: a chain of GT steps, each off by a small yaw and shift
    believed = [gt[0]]
    for k in range(1, 16):
        step = gt[k - 1].inverse() @ gt[k]
        err = JSE3.from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]), float(rng.normal(0, 0.02)),
                                   jnp.asarray(rng.normal(0, 0.08, 3) * [1, 1, 0], jnp.float32))
        believed.append(believed[-1] @ step @ err)
    cfg = JLCConfig(min_separation=4, max_candidate_dist=4.0, accept_rmse=0.12,
                    icp=JConfig(objective="symmetric", max_iters=15, diff_threshold=0.0,
                                rmse_change_tol=1e-6, robust="huber", max_corr_dist=2.0))
    je = j_detect(believed, jf, cfg)
    tf = [torch_cloud(f) for f in jf]
    tb = [torch_se3(p) for p in believed]
    te = detect_loop_closures(tb, tf, _port_config(cfg))
    _assert_same_closures(je, te)
    assert te, "no loop closures found on a closed loop"

    edges = [(k, k + 1, tb[k].inverse() @ tb[k + 1]) for k in range(15)]
    edges += [(i, j, T) for (i, j, T, _) in te]
    graph = PoseGraph.from_edge_list(SE3(R=torch.stack([p.R for p in tb]),
                                         t=torch.stack([p.t for p in tb])), edges)
    tgt = [torch_se3(g) for g in gt]
    before = ate_rmse(tb, tgt, align=False)
    for solve in (optimize_pose_graph, optimize_pose_graph_sparse):
        opt, chi2 = solve(graph, iters=10)
        after = ate_rmse([SE3(R=opt.R[i], t=opt.t[i]) for i in range(16)], tgt, align=False)
        assert after < 0.7 * before, (solve.__name__, before, after)
        assert float(chi2[-1]) < float(chi2[0])


def test_config_fields_match_jax():
    """LoopClosureConfig carries the reference's fields and defaults."""
    j, t = JLCConfig(), LoopClosureConfig()
    for f in j.__dataclass_fields__:
        want = getattr(j, f)
        got = getattr(t, f)
        assert (got == torch_config(want)) if f == "icp" else (got == want), f
    assert isinstance(t.icp, ICPConfig)


def slam_loop_run(n_points, package):
    """tests/test_slam.py::test_loop_closure_pose_graph_reduces_ate's
    construction at `n_points` a scan through one package ("jax" or
    "port", on the CPU): (keyframes, closures [(i, j, rmse)], keyframe ATE
    before, after the dense solver)."""
    import jax
    from icpx.geometry.se3 import SE3 as J
    from icpx.odometry.evaluate import ate_rmse as j_ate
    from icpx.odometry.frontend import OdometryConfig as JO
    from icpx.odometry.frontend import run_odometry as j_run
    from icpx.odometry.posegraph import PoseGraph as JPG
    from icpx.odometry.posegraph import optimize_pose_graph as j_opt
    from icpx_torch.odometry.frontend import run_odometry
    from torch_parity import torch_odometry_config

    world = make_world(n_points=80000, extent=25.0, seed=2)
    gt = _loop_poses(30)
    jf = simulate_scans(world, gt, max_range=14.0, points_per_scan=n_points, noise=0.02, seed=3)
    gt = [gt[0].inverse() @ g for g in gt]
    icp = dict(objective="symmetric", max_iters=15, diff_threshold=0.0, rmse_change_tol=1e-6,
               robust="huber")
    odo = JO(icp=JConfig(max_corr_dist=3.0, **icp), keyframe_trans=1.5, keyframe_rot=0.3,
             pyramid_levels=2)
    lc = JLCConfig(min_separation=4, max_candidate_dist=4.0, accept_rmse=0.12,
                   icp=JConfig(max_corr_dist=2.0, **icp))
    if package == "jax":
        res = j_run(jf, odo)
        kf = res.keyframe_indices
        kfp = [res.poses[i] for i in kf]
        closures = j_detect(kfp, [jf[i] for i in kf], lc)
        remap = {f: i for i, f in enumerate(kf)}
        edges = [(remap[i], remap[j], T) for (i, j, T) in res.edges if i in remap and j in remap]
        graph = JPG.from_edge_list(J(R=jnp.stack([p.R for p in kfp]), t=jnp.stack([p.t for p in kfp])),
                                   edges + [(i, j, T) for (i, j, T, _) in closures])
        opt, _ = j_opt(graph, iters=10)
        gk = [gt[i] for i in kf]
        after = j_ate([J(R=opt.R[i], t=opt.t[i]) for i in range(len(kf))], gk, align=False)
        jax.block_until_ready(opt.t)
        return kf, [(i, j, r) for i, j, _, r in closures], j_ate(kfp, gk, align=False), after
    tf = [torch_cloud(f) for f in jf]
    res = run_odometry(tf, torch_odometry_config(odo))
    kf = res.keyframe_indices
    kfp = [res.poses[i] for i in kf]
    closures = detect_loop_closures(kfp, [tf[i] for i in kf], _port_config(lc))
    remap = {f: i for i, f in enumerate(kf)}
    edges = [(remap[i], remap[j], T) for (i, j, T) in res.edges if i in remap and j in remap]
    graph = PoseGraph.from_edge_list(SE3(R=torch.stack([p.R for p in kfp]),
                                         t=torch.stack([p.t for p in kfp])),
                                     edges + [(i, j, T) for (i, j, T, _) in closures])
    opt, _ = optimize_pose_graph(graph, iters=10)
    gk = [torch_se3(gt[i]) for i in kf]
    return (kf, [(i, j, r) for i, j, _, r in closures], ate_rmse(kfp, gk, align=False),
            ate_rmse([SE3(R=opt.R[i], t=opt.t[i]) for i in range(len(kf))], gk, align=False))


if __name__ == "__main__":
    # python tests/test_torch_slam.py N_POINTS [jax|port ...] (PYTHONPATH=.:tests):
    # the SLAM loop's closures and keyframe ATE cut at N_POINTS a scan, on the CPU
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    n = int(sys.argv[1])
    for pkg in sys.argv[2:] or ("jax", "port"):
        kf, closures, before, after = slam_loop_run(n, pkg)
        print(f"{pkg} {n} points: {len(kf)} keyframes, closures {closures}, keyframe ATE "
              f"{before:.4f} -> {after:.4f} m ({after / before:.3f} x)", flush=True)

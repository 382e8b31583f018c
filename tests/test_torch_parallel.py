"""Port parity: the stage pipeline, the edge-sharded pose graph,
data-parallel odometry, the batched pair seed, the shard-equivalence
report and the collective-traffic audit, against the JAX package.

Multi-rank cases run in gloo rank processes (`torch_dist.RankPool`) at
W = 1, 2 and 4 against the JAX package on a mesh of the same shape; the
rest run in this process. Inputs are made with numpy from a seed (the
LiDAR scans by the JAX simulator, carried across as numpy). Tolerances:
pipeline and pose-graph poses within 1e-5 (the pose graph's chi2 to 1e-3
relative, as tests/test_posegraph_sharded.py holds it); parallel odometry's
poses within 1e-3, the bound the odometry parity tests give registrations
on sparse 2,048-point scans.

The pipeline centres its inputs where the reference does not: near the
origin the two agree (1e-5); at a 1e5 offset the port still converges (to
the fp32 resolution of such coordinates), and the reference is not asked
to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icpx.cloud import PointCloud
from icpx.distributed.mesh import make_mesh as j_make_mesh
from icpx.distributed.pipeline import pipelined_pyramid_register as j_pipeline
from icpx.geometry.se3 import SE3
from icpx.io.loaders import synthetic_surface
from icpx.kernels.normals import estimate_normals
from icpx.odometry.posegraph import PoseGraph
from icpx.odometry.posegraph import optimize_pose_graph_sharded as j_optimize_sharded
from icpx.odometry.posegraph import pad_edges as j_pad_edges
from icpx.registration.icp import ICPConfig
from icpx_torch import interop
from icpx_torch.odometry.posegraph import optimize_pose_graph
from icpx_torch.utils.debug import shard_equivalence_report
from torch_dist import RankPool

TOL = 1e-5


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _jmesh(w, names, shape=None):
    return j_make_mesh(shape=shape, axis_names=names, devices=jax.devices()[:w])


def _angle(Ra, Rb):
    rel = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    return float(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1)))


# ---- the stage pipeline -------------------------------------------------------------------


def _pipeline_batch(b=3, n=1024, offset=0.0, scale=1.0):
    """tests/test_pipeline.py's batch (the surface times `scale`), then
    moved by `offset` on every axis in float64 and rounded to float32 once;
    the normals are the unmoved clouds' (they do not change with a
    translation) and the GT is conjugated by the offset."""
    srcs, tgts, gts = [], [], []
    c = np.full(3, offset, np.float64)
    for i in range(b):
        xyz = synthetic_surface(n, seed=20 + i) * np.float32(scale)
        src = estimate_normals(PointCloud.create(xyz, capacity=n), k=8)
        axis = np.array([0.1, 0.15, 0.98]) / np.linalg.norm([0.1, 0.15, 0.98])
        gt = SE3.from_axis_angle(jnp.asarray(axis, jnp.float32), 0.25,
                                 jnp.asarray([0.12, -0.08, 0.05], jnp.float32))
        rng = np.random.default_rng(i)
        tgt_xyz = np.asarray(gt.apply(src.xyz))[:n][rng.permutation(n)]
        tgt = estimate_normals(PointCloud.create(tgt_xyz, capacity=n), k=8)
        if offset:
            R = np.asarray(gt.R, np.float64)
            gt = SE3(R=gt.R, t=jnp.asarray(np.asarray(gt.t, np.float64) + c - R @ c, jnp.float32))
            src = src.replace(xyz=jnp.asarray((np.asarray(src.xyz, np.float64) + c).astype(np.float32)))
            tgt = tgt.replace(xyz=jnp.asarray((np.asarray(tgt.xyz, np.float64) + c).astype(np.float32)))
        srcs.append(src)
        tgts.append(tgt)
        gts.append(gt)
    arrays = [jnp.stack([getattr(c, f) for c in cs]) for cs in (srcs, tgts)
              for f in ("xyz", "mask", "normals")]
    cfg = ICPConfig(objective="symmetric", max_iters=6, diff_threshold=0.0, robust="huber",
                    tile_q=256, tile_r=256)
    return arrays, gts, cfg


@pytest.mark.parametrize("w", [1, 2])
def test_pipeline_matches_jax_near_the_origin(pool, w):
    arrays, gts, cfg = _pipeline_batch()
    kw = dict(iters_per_level=8, subsample=4)
    res = pool.run("pipeline", w, arrays=[np.asarray(a) for a in arrays],
                   config=dataclasses.asdict(cfg), kw=kw)
    sx, sm, sn, tx, tm, tn = arrays
    jout = j_pipeline(sx, sm, sn, tx, tm, tn, cfg, _jmesh(w, ("stages",)), **kw)
    for r in res:
        np.testing.assert_array_equal(r["R"], res[0]["R"])
        np.testing.assert_array_equal(r["t"], res[0]["t"])
        assert not r["jax_loaded"]
    np.testing.assert_allclose(res[0]["R"], np.asarray(jout.R), atol=TOL, rtol=0)
    np.testing.assert_allclose(res[0]["t"], np.asarray(jout.t), atol=TOL, rtol=0)
    for i, g in enumerate(gts):
        assert _angle(g.R, res[0]["R"][i]) < 8e-3
        assert np.linalg.norm(res[0]["t"][i] - np.asarray(g.t)) < 8e-3


def test_pipeline_converges_far_from_the_origin(pool):
    """At a 1e5 offset (UTM-scale coordinates, a 20 m surface) the centred
    pipeline converges: the rotation inside the same GT gate, the
    translation about the surface within four fp32 ulps at 1e5 (7.8 mm
    each; the inputs and the returned t are rounded to that)."""
    arrays, gts, cfg = _pipeline_batch(offset=1e5, scale=10.0)
    res = pool.run("pipeline", 2, arrays=[np.asarray(a) for a in arrays],
                   config=dataclasses.asdict(cfg), kw=dict(iters_per_level=8, subsample=4))
    c = np.full(3, 1e5)
    for i, g in enumerate(gts):
        R = res[0]["R"][i].astype(np.float64)
        assert _angle(g.R, R) < 8e-3
        # the translations about the surface (a rotation error of e rad
        # moves the world-frame t by e x 1.7e5 m of lever arm)
        t_local = res[0]["t"][i] + R @ c - c
        t_gt = np.asarray(g.t, np.float64) + np.asarray(g.R, np.float64) @ c - c
        assert np.linalg.norm(t_local - t_gt) < 4 * np.spacing(np.float32(1e5))


# ---- the edge-sharded pose graph -----------------------------------------------------------


def _graph(m=10, seed=0):
    """tests/test_posegraph_sharded.py's chain with one loop edge, from numpy."""
    rng = np.random.default_rng(seed)
    deltas = SE3.exp(jnp.asarray(0.25 * rng.normal(size=(m - 1, 6)), jnp.float32))
    poses = [SE3.identity()]
    for k in range(m - 1):
        poses.append(poses[-1] @ SE3(R=deltas.R[k], t=deltas.t[k]))
    gt = SE3(R=jnp.stack([p.R for p in poses]), t=jnp.stack([p.t for p in poses]))
    edges = [(k, k + 1, SE3(R=deltas.R[k], t=deltas.t[k])) for k in range(m - 1)]
    edges.append((0, m - 1, SE3(R=gt.R[0], t=gt.t[0]).inverse() @ SE3(R=gt.R[-1], t=gt.t[-1])))
    noise = SE3.exp(jnp.asarray(0.08 * rng.normal(size=(m, 6)), jnp.float32))
    init = SE3(R=jnp.concatenate([gt.R[:1], (gt.R @ noise.R)[1:]]),
               t=jnp.concatenate([gt.t[:1], (gt.t + noise.t)[1:]]))
    return PoseGraph.from_edge_list(init, edges), gt


def _graph_np(g):
    return {"poses": _se3_ns(g.poses), "edge_meas": _se3_ns(g.edge_meas),
            "edge_i": np.asarray(g.edge_i), "edge_j": np.asarray(g.edge_j),
            "edge_weight": np.asarray(g.edge_weight)}


def _se3_ns(s):
    import types

    return types.SimpleNamespace(R=np.asarray(s.R), t=np.asarray(s.t))


@pytest.mark.parametrize("w", [1, 2, 4])
def test_sharded_pose_graph_matches_jax(pool, w):
    """Edge shards, one psum of (H, b, chi2) an iteration, the same dense
    solve on every rank: equal to the JAX sharded optimizer at the same W,
    to the port's dense optimizer, and the padding is a no-op."""
    graph, gt = _graph()
    padded = j_pad_edges(graph, 4)
    res = pool.run("posegraph", w, graph=_graph_np(padded), iters=8)
    jp, jchi2 = j_optimize_sharded(padded, _jmesh(w, ("points",)), iters=8)
    for r in res:
        np.testing.assert_array_equal(r["t"], res[0]["t"])
    out = res[0]
    np.testing.assert_allclose(out["R"], np.asarray(jp.R), atol=TOL, rtol=0)
    np.testing.assert_allclose(out["t"], np.asarray(jp.t), atol=TOL, rtol=0)
    np.testing.assert_allclose(out["chi2"], np.asarray(jchi2), rtol=1e-3, atol=1e-6)
    dense, chi2 = optimize_pose_graph(interop.pose_graph_from_numpy(graph, device="cpu"), iters=8)
    np.testing.assert_allclose(out["t"], dense.t.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(out["chi2"], chi2.numpy(), rtol=1e-3, atol=1e-6)
    assert np.linalg.norm(out["t"] - np.asarray(gt.t), axis=1).max() < 5e-3


# ---- data-parallel odometry ----------------------------------------------------------------


@pytest.fixture(scope="module")
def lidar():
    """tests/test_distributed.py's small-motion sequence, 5 frames."""
    from icpx.odometry.kitti import make_trajectory, make_world, simulate_scans

    world = make_world(n_points=60000, extent=30.0, seed=0)
    gt = make_trajectory(5, speed=0.5, turn=0.03)
    frames = simulate_scans(world, gt, max_range=18.0, points_per_scan=2048, noise=0.01, seed=1)
    return frames, [gt[0].inverse() @ g for g in gt]


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_parallel_odometry_matches_jax(pool, lidar, shape):
    """Four pairs from identity over the pairs axis (padded to a multiple
    of 4 pairs at (4, 1): exact, 4 pairs), poses composed on the host."""
    from icpx.odometry.evaluate import ate_rmse
    from icpx.odometry.parallel import parallel_odometry as j_parallel

    frames, gt0 = lidar
    cfg = ICPConfig(objective="symmetric", max_iters=30, diff_threshold=0.0,
                    rmse_change_tol=1e-6, robust="huber", max_corr_dist=2.0, tile_q=512,
                    tile_r=512)
    fr_np = [{"xyz": np.asarray(f.xyz), "mask": np.asarray(f.mask)} for f in frames]
    res = pool.run("parallel_odometry", 4, frames=fr_np, config=dataclasses.asdict(cfg),
                   shape=shape)
    jposes, jedges, jrmse = j_parallel(frames, cfg, _jmesh(4, ("pairs", "points"), shape))
    out = res[0]
    for r in res[1:]:
        np.testing.assert_array_equal(r["t"], out["t"])
    assert out["edges"] == [(i, j) for i, j, _ in jedges]
    np.testing.assert_allclose(out["t"], np.stack([np.asarray(p.t) for p in jposes]), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(out["R"], np.stack([np.asarray(p.R) for p in jposes]), atol=1e-3,
                               rtol=0)
    assert np.isfinite(out["rmse"]).all() and out["rmse"].shape == (4,)
    # the trajectory's error: the reference's within 1e-3, and inside
    # bench.py's odometry gate (0.5 m, unaligned)
    poses = [SE3(R=jnp.asarray(out["R"][k]), t=jnp.asarray(out["t"][k])) for k in range(5)]
    ate = ate_rmse(poses, gt0, align=False)
    assert abs(ate - ate_rmse(jposes, gt0, align=False)) < 1e-3 and ate < 0.5


def test_batched_pair_seed_matches_jax(lidar):
    """The sector-profile yaw seed of each pair, and the centroid
    translation, equal to the reference's."""
    from icpx.odometry.parallel import batched_pair_seed as j_seed
    from icpx_torch.odometry.parallel import batched_pair_seed

    frames, _ = lidar
    sx = np.stack([np.asarray(f.xyz) for f in frames[1:]])
    sm = np.stack([np.asarray(f.mask) for f in frames[1:]])
    tx = np.stack([np.asarray(f.xyz) for f in frames[:-1]])
    tm = np.stack([np.asarray(f.mask) for f in frames[:-1]])
    for translation in ("none", "centroid"):
        js = j_seed(*(jnp.asarray(a) for a in (sx, sm, tx, tm)), translation=translation)
        ts = batched_pair_seed(*(torch.tensor(a) for a in (sx, sm, tx, tm)),
                               translation=translation)
        np.testing.assert_allclose(ts.R.numpy(), np.asarray(js.R), atol=1e-6, rtol=0)
        np.testing.assert_allclose(ts.t.numpy(), np.asarray(js.t), atol=1e-5, rtol=0)


# ---- the audits ----------------------------------------------------------------------------


def test_shard_equivalence_report_matches_jax():
    """The same leaf paths and verdicts as the reference's report: equal
    trees give {}, a float beyond tolerance its max diff, a finiteness
    mismatch inf, a differing integer leaf NaN."""
    from icpx.utils.debug import shard_equivalence_report as j_report

    a = {"pose": (np.eye(3, dtype=np.float32), np.zeros(3, np.float32)),
         "iters": np.int32(7), "rmse": np.float32(1e-3)}
    b = {"pose": (np.eye(3, dtype=np.float32) + 1e-3, np.array([0, np.inf, 0], np.float32)),
         "iters": np.int32(8), "rmse": np.float32(1e-3 + 1e-7)}
    to_t = lambda tree: {"pose": tuple(torch.tensor(x) for x in tree["pose"]),  # noqa: E731
                         "iters": torch.tensor(tree["iters"]), "rmse": torch.tensor(tree["rmse"])}
    assert shard_equivalence_report(to_t(a), to_t(a)) == {} == j_report(a, a)
    got = shard_equivalence_report(to_t(a), to_t(b))
    want = j_report(a, b)
    assert set(got) == set(want) == {"['pose'][0]", "['pose'][1]", "['iters']"}
    assert np.isclose(got["['pose'][0]"], want["['pose'][0]"])
    assert got["['pose'][1]"] == np.inf and np.isnan(got["['iters']"])


def test_collective_traffic_of_one_iteration(pool):
    """One iteration's collectives (max_iters=1), brute ring at W = 2: one
    ring shift (W - 1 a pass), then the centroid, normal-equation and
    convergence all-reduces and the stop flag's; the same on each rank."""
    from icpx.io.loaders import synthetic_surface as surf

    src = estimate_normals(PointCloud.create(surf(512, seed=2)), k=10)
    tgt = estimate_normals(PointCloud.create(surf(512, seed=3)), k=10)
    cfg = ICPConfig(objective="symmetric", max_iters=10, diff_threshold=1e-5, tile_q=256,
                    tile_r=256)
    cd = lambda c: {"xyz": np.asarray(c.xyz), "mask": np.asarray(c.mask),  # noqa: E731
                    "normals": np.asarray(c.normals)}
    res = pool.run("sharded_register", 2, src=cd(src), tgt=cd(tgt),
                   config=dataclasses.asdict(cfg), ring=True, traffic=True)
    rows = res[0]["traffic"]
    assert rows == res[1]["traffic"]
    assert rows == [
        # xyz, the mask (as uint8) and the xyz + normal payload of 256 rows
        ("ring_nearest_neighbor", "collective-permute", 256 * (4 * 3 + 1 + 4 * 6)),
        ("estimate_increment", "all-reduce", 4 * 7),
        ("estimate_increment", "all-reduce", 4 * (36 + 6)),
        ("step_stats", "all-reduce", 4 * 3),
        ("_icp_scan", "all-reduce", 4),
    ]


@pytest.mark.parametrize("w", [2, 4])
def test_block_ring_posts_before_each_fold(pool, w):
    """The block ring's shifts (index tiles, boxes, centroids, order,
    payload tiles) are posted before the fold they hide behind and waited
    on after it, W - 1 of them a pass."""
    res = pool.run("block_ring_order", w)
    for out in res:
        assert out["order"] == [("collective-permute", "post"), ("fold", ""),
                                ("collective-permute", "wait")] * (w - 1) + [("fold", "")]
        assert out["folds_between"] == [1] * (w - 1)
        assert out["exact"] > 0.95

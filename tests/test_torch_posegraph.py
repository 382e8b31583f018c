"""Port parity: the pose-graph back end against `icpx`, on the reference
tests' chains (tests/test_posegraph.py: consecutive exact edges of random
twists, a closing edge, noisy initial poses), and the frontend's sliding
window on the odometry fixture.

Held to 1e-4: the dense and the sparse Gauss-Newton solvers' poses (every
robust kernel, edge weights, a marginal prior) and their per-iteration
chi2 (relative, with 1e-4 absolute where chi2 has fallen to ~0),
`schur_condense`, and the sliding window's poses and prior. The
frontend's window case is held as `tests/test_torch_odometry.py` holds
the frontend (keyframes and edges equal, poses within 1e-3, for the
reason given there), and its resume bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icpx.geometry.se3 import SE3 as JSE3
from icpx.kernels.normals import estimate_normals as j_normals
from icpx.odometry import kitti as j_kitti
from icpx.odometry import posegraph as jpg
from icpx.odometry.frontend import OdometryConfig as JOdoConfig
from icpx.odometry.frontend import run_odometry as j_run_odometry
from icpx.registration.icp import ICPConfig as JConfig
from icpx.utils.checkpoint import OdometryCheckpoint as JCheckpoint
from icpx_torch import interop
from icpx_torch.geometry.se3 import SE3
from icpx_torch.odometry import posegraph as tpg
from icpx_torch.odometry.frontend import run_odometry
from icpx_torch.utils.checkpoint import OdometryCheckpoint
from torch_parity import to_np, torch_cloud, torch_odometry_config, torch_se3

TOL = 1e-4


def _chain(m, seed, noise=0.1, loop=True, anchor_noisy=False):
    """(JAX graph, ground truth): exact consecutive edges of 0.3-scaled
    random twists, a first->last closure, initial poses off by `noise`."""
    rng = np.random.default_rng(seed)
    deltas = JSE3.exp(jnp.asarray(0.3 * rng.normal(size=(m - 1, 6)), jnp.float32))
    poses = [JSE3.identity()]
    for k in range(m - 1):
        poses.append(poses[-1] @ JSE3(R=deltas.R[k], t=deltas.t[k]))
    gt = JSE3(R=jnp.stack([p.R for p in poses]), t=jnp.stack([p.t for p in poses]))
    edges = [(k, k + 1, JSE3(R=deltas.R[k], t=deltas.t[k])) for k in range(m - 1)]
    if loop:
        edges.append((0, m - 1, poses[0].inverse() @ poses[-1]))
    nz = JSE3.exp(jnp.asarray(noise * rng.normal(size=(m, 6)), jnp.float32))
    first = 0 if anchor_noisy else 1
    init = JSE3(R=jnp.concatenate([gt.R[:first], (gt.R @ nz.R)[first:]]),
                t=jnp.concatenate([gt.t[:first], (gt.t + nz.t)[first:]]))
    return init, edges, gt


def _graphs(init, edges, weights=None):
    jg = jpg.PoseGraph.from_edge_list(init, edges, weights)
    return jg, interop.pose_graph_from_numpy(jg, device="cpu")


def _close(jp, tp_, jchi, tchi):
    np.testing.assert_allclose(to_np(tp_.t), np.asarray(jp.t), atol=TOL)
    np.testing.assert_allclose(to_np(tp_.R), np.asarray(jp.R), atol=TOL)
    np.testing.assert_allclose(to_np(tchi), np.asarray(jchi), rtol=TOL, atol=TOL)


def test_pose_graph_from_edge_list_matches_interop():
    init, edges, _ = _chain(6, 0)
    jg, tg = _graphs(init, edges, [1.0] * 5 + [0.5])
    mine = tpg.PoseGraph.from_edge_list(torch_se3(init),
                                        [(i, j, torch_se3(T)) for i, j, T in edges],
                                        [1.0] * 5 + [0.5])
    for f in ("edge_i", "edge_j", "edge_weight"):
        assert torch.equal(getattr(mine, f), getattr(tg, f))
    assert torch.equal(mine.edge_meas.R, tg.edge_meas.R) and mine.n_nodes == 6
    assert mine.n_edges == 6


def _hub_edges(m, seed):
    """A chain over m nodes, every node tied to node 0 and a few edges
    given twice (the sums' duplicate destinations): (init, edges)."""
    init, edges, gt = _chain(m, seed, noise=0.05, loop=False)
    pose = lambda k: JSE3(R=gt.R[k], t=gt.t[k])  # noqa: E731
    edges += [(0, k, pose(0).inverse() @ pose(k)) for k in range(2, m)]
    edges += [edges[3], edges[3], edges[m + 1]]
    return init, edges


@pytest.mark.parametrize("case", ["loop", "weighted bad edge", "consistent",
                                  "hub and duplicate edges"])
def test_dense_matches_jax(case):
    if case == "hub and duplicate edges":
        init, edges = _hub_edges(10, 11)
        weights, iters = None, 6
    elif case == "loop":
        init, edges, _ = _chain(12, 1)
        weights, iters = None, 10
    elif case == "weighted bad edge":
        init, edges, _ = _chain(8, 2, noise=0.05, loop=False, anchor_noisy=True)
        edges.append((1, 5, JSE3.exp(jnp.asarray([0.5, -0.3, 0.2, 1.0, -1.0, 0.5]))))
        weights, iters = [1.0] * (len(edges) - 1) + [1e-6], 10
    else:
        _, edges, gt = _chain(6, 3)
        init, weights, iters = gt, None, 3
    jg, tg = _graphs(init, edges, weights)
    jp, jchi = jpg.optimize_pose_graph(jg, iters=iters)
    tp_, tchi = tpg.optimize_pose_graph(tg, iters=iters)
    _close(jp, tp_, jchi, tchi)


@pytest.mark.parametrize("robust, delta", [("none", 1.0), ("huber", 1.0), ("dcs", 0.0),
                                           ("cauchy", 0.5)])
def test_sparse_matches_jax(robust, delta):
    """The sparse solver on a 30-node chain with a false closure, under each
    robust kernel (`robust_delta <= 0`: the median-scaled one)."""
    init, edges, _ = _chain(30, 4, noise=0.05, loop=False)
    edges.append((2, 27, JSE3.exp(jnp.asarray([0.4, -0.2, 0.3, 2.0, -1.5, 1.0]))))
    jg, tg = _graphs(init, edges)
    jp, jchi = jpg.optimize_pose_graph_sparse(jg, iters=8, robust=robust, robust_delta=delta)
    tp_, tchi = tpg.optimize_pose_graph_sparse(tg, iters=8, robust=robust, robust_delta=delta)
    _close(jp, tp_, jchi, tchi)


def test_sparse_with_hub_and_duplicate_edges_matches_jax():
    init, edges = _hub_edges(10, 11)
    jg, tg = _graphs(init, edges)
    jp, jchi = jpg.optimize_pose_graph_sparse(jg, iters=6, robust="huber")
    tp_, tchi = tpg.optimize_pose_graph_sparse(tg, iters=6, robust="huber")
    _close(jp, tp_, jchi, tchi)


def test_sparse_with_a_prior_matches_jax(windows):
    """The sparse solver with a marginal prior (the JAX window's, handed
    over) and no anchor, as the window runs it once it has marginalized."""
    jw = windows[0]
    prior = jw._local_prior()
    a0 = jw.active0
    poses = JSE3(R=jnp.stack([p.R for p in jw.poses[a0:]]),
                 t=jnp.stack([p.t for p in jw.poses[a0:]]))
    jg, tg = _graphs(poses, [(i - a0, j - a0, m) for (i, j, m, _) in jw.edges])
    t_prior = tpg.MarginalPrior(
        nodes=torch.tensor(np.asarray(prior.nodes)), H=torch.tensor(np.asarray(prior.H)),
        b=torch.tensor(np.asarray(prior.b)), lin=torch_se3(prior.lin))
    kw = dict(iters=jw.iters, cg_iters=jw.cg_iters, anchor_weight=0.0, robust=jw.robust,
              robust_delta=jw.robust_delta)
    jp, jchi = jpg.optimize_pose_graph_sparse(jg, prior=prior, **kw)
    tp_, tchi = tpg.optimize_pose_graph_sparse(tg, prior=t_prior, **kw)
    _close(jp, tp_, jchi, tchi)


def test_pcg_stop_rule_and_cap():
    """The PCG loop stops on the reference's rule: at the iteration cap, or
    once ||r|| <= tol ||b|| (its state then stays frozen)."""
    rng = np.random.default_rng(6)
    A = rng.normal(size=(8, 6, 6)).astype(np.float32)
    blocks = np.einsum("mij,mkj->mik", A, A) + 6 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(8, 6)).astype(np.float32)
    Minv = np.linalg.inv(blocks)
    for iters, tol in ((1, 1e-5), (3, 1e-5), (100, 1e-5), (100, 1e-1)):
        want = np.asarray(jpg._pcg(lambda x: jnp.einsum("mij,mj->mi", jnp.asarray(blocks), x),
                                   jnp.asarray(b), jnp.asarray(Minv), iters, tol))
        got = tpg._pcg(lambda x: torch.einsum("mij,mj->mi", torch.as_tensor(blocks), x),
                       torch.as_tensor(b), torch.as_tensor(Minv), iters, tol)
        np.testing.assert_allclose(to_np(got), want, rtol=1e-5, atol=1e-6)


def test_schur_condense_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(30, 30)).astype(np.float32)
    H = A @ A.T + 30 * np.eye(30, dtype=np.float32)
    b = rng.normal(size=(30,)).astype(np.float32)
    jH, jb = jpg.schur_condense(jnp.asarray(H), jnp.asarray(b), 18)
    tH, tb = tpg.schur_condense(torch.as_tensor(H), torch.as_tensor(b), 18)
    np.testing.assert_allclose(to_np(tH), np.asarray(jH), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to_np(tb), np.asarray(jb), rtol=TOL, atol=TOL)
    x = np.linalg.solve(to_np(tH), to_np(tb))
    np.testing.assert_allclose(x, np.linalg.solve(H, b)[:18], atol=1e-3)


def test_pad_edges_matches_jax():
    init, edges, _ = _chain(5, 7)
    jg, tg = _graphs(init, edges)
    jp, tp_ = jpg.pad_edges(jg, 4), tpg.pad_edges(tg, 4)
    assert tp_.n_edges == jp.n_edges == 8
    for f in ("edge_i", "edge_j", "edge_weight"):
        np.testing.assert_array_equal(to_np(getattr(tp_, f)), np.asarray(getattr(jp, f)))
    np.testing.assert_array_equal(to_np(tp_.edge_meas.R), np.asarray(jp.edge_meas.R))
    assert tpg.pad_edges(tg, 5) is tg


@pytest.fixture(scope="module")
def windows():
    """A 7-keyframe chain streamed through both windows (window 2, DCS),
    each keyframe's noisy initial pose made once and handed to both:
    (JAX window, port window, and each step's chi2 on both sides)."""
    _, edges, gt = _chain(7, 8, loop=False)
    rng = np.random.default_rng(8)
    jw = jpg.SlidingWindowBackend(window=2, iters=3)
    tw = tpg.SlidingWindowBackend(window=2, iters=3)
    jw.add_keyframe(JSE3(R=gt.R[0], t=gt.t[0]))
    tw.add_keyframe(torch_se3(JSE3(R=gt.R[0], t=gt.t[0])))
    chi2 = []
    for k in range(6):
        nz = JSE3.exp(jnp.asarray(0.02 * rng.normal(size=6), jnp.float32))
        jp = jw.poses[-1] @ edges[k][2] @ nz
        jw.add_keyframe(jp)
        tw.add_keyframe(torch_se3(jp))
        jw.add_edge(k, k + 1, edges[k][2])
        tw.add_edge(k, k + 1, torch_se3(edges[k][2]))
        chi2.append((jw.step(), tw.step()))
    return jw, tw, chi2, edges


def test_sliding_window_matches_jax(windows):
    """Every pose, each step's chi2, active0, and the marginal prior's
    nodes, H and b."""
    jw, tw, chi2, edges = windows
    for jc, tc in chi2:
        assert abs(tc - jc) <= TOL * max(1.0, abs(jc))
    assert tw.active0 == jw.active0 == 5
    for a, b in zip(jw.poses, tw.poses):
        np.testing.assert_allclose(to_np(b.t), np.asarray(a.t), atol=TOL)
        np.testing.assert_allclose(to_np(b.R), np.asarray(a.R), atol=TOL)
    np.testing.assert_array_equal(to_np(tw.prior.nodes), np.asarray(jw.prior.nodes))
    scale = np.abs(np.asarray(jw.prior.H)).max()
    np.testing.assert_allclose(to_np(tw.prior.H), np.asarray(jw.prior.H), atol=TOL * scale)
    np.testing.assert_allclose(to_np(tw.prior.b), np.asarray(jw.prior.b), atol=TOL * scale)
    with pytest.raises(ValueError, match="marginalized"):
        tw.add_edge(0, 6, torch_se3(edges[0][2]))


# ---- the frontend's sliding window --------------------------------------------------------

WINDOW = JOdoConfig(icp=JConfig(objective="symmetric", max_iters=12, diff_threshold=0.0,
                                rmse_change_tol=1e-6, robust="huber", max_corr_dist=2.0),
                    keyframe_trans=0.5, keyframe_rot=0.15, backend="sliding_window", window=3)


@pytest.fixture(scope="module")
def window_runs():
    """6 frames of the odometry fixture, every one a keyframe, through
    both frontends with the window back end: (jax run, port run, port
    frames)."""
    world = j_kitti.make_world(n_points=60000, extent=30.0, seed=0)
    gt = j_kitti.make_trajectory(6, speed=0.6, turn=0.04)
    jf = [j_normals(f, k=10) for f in j_kitti.simulate_scans(
        world, gt, max_range=18.0, points_per_scan=2048, noise=0.01, seed=1)]
    tf = [torch_cloud(f) for f in jf]
    return j_run_odometry(jf, WINDOW), run_odometry(tf, torch_odometry_config(WINDOW)), tf


def test_frontend_window_matches_jax(window_runs):
    jres, tres, _ = window_runs
    assert tres.is_keyframe == jres.is_keyframe and tres.keyframe_indices == list(range(6))
    assert [(i, j) for i, j, _ in tres.edges] == [(i, j) for i, j, _ in jres.edges]
    for a, b in zip(jres.poses, tres.poses):
        np.testing.assert_allclose(to_np(b.t), np.asarray(a.t), atol=1e-3)
        np.testing.assert_allclose(to_np(b.R), np.asarray(a.R), atol=1e-3)
    assert tres.window.active0 == jres.window.active0 == 3
    np.testing.assert_array_equal(to_np(tres.window.prior.nodes), np.asarray(jres.window.prior.nodes))


def test_frontend_window_resume_is_bit_exact(window_runs, tmp_path):
    """Resumed from its own checkpoint saved to disk after frame 3, the
    window run equals the uninterrupted one bit for bit, its prior too."""
    _, full, tf = window_runs
    cfg = torch_odometry_config(WINDOW)
    OdometryCheckpoint.from_result(run_odometry(tf[:4], cfg)).save(tmp_path / "ck.npz")
    ck = OdometryCheckpoint.load(tmp_path / "ck.npz")
    assert ck.win_active0 == 1 and ck.win_prior_H is not None
    resumed = run_odometry(tf, cfg, resume=ck)
    assert resumed.is_keyframe == full.is_keyframe
    for p, q in zip(full.poses + [e[2] for e in full.edges],
                    resumed.poses + [e[2] for e in resumed.edges]):
        assert torch.equal(p.R, q.R) and torch.equal(p.t, q.t)
    assert torch.equal(resumed.window.prior.H, full.window.prior.H)


def test_checkpoint_keys_shared_both_ways(window_runs, tmp_path):
    """A port checkpoint (window state included) loads in the JAX package
    field for field, and the JAX package's in the port."""
    jres, tres, _ = window_runs
    OdometryCheckpoint.from_result(tres).save(tmp_path / "port.npz")
    JCheckpoint.from_result(jres).save(tmp_path / "jax.npz")
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
    for mine, theirs in ((JCheckpoint.load(tmp_path / "port.npz"),
                          OdometryCheckpoint.from_result(tres)),
                         (OdometryCheckpoint.load(tmp_path / "jax.npz"),
                          JCheckpoint.from_result(jres))):
        for f in dataclasses.fields(JCheckpoint):
            x, y = getattr(mine, f.name), getattr(theirs, f.name)
            if f.name in ("edges", "win_edges"):
                assert [e[:2] for e in x] == [e[:2] for e in y]
            elif f.name.startswith(("poses", "win_prior", "motion", "rmse")):
                np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64),
                                           rtol=1e-3, atol=2e-3)
            else:
                assert np.array_equal(np.asarray(x), np.asarray(y)), f.name
    assert OdometryCheckpoint.load(tmp_path / "jax.npz").poses(device="cpu")[0].t.device.type == "cpu"


def test_pose_graph_round_trips_through_interop():
    init, edges, _ = _chain(5, 9)
    jg, tg = _graphs(init, edges, [1.0, 2.0, 3.0, 4.0, 5.0])
    again = interop.pose_graph_from_numpy(tg, device="cpu")
    for f in ("edge_i", "edge_j", "edge_weight"):
        assert torch.equal(getattr(again, f), getattr(tg, f))
    assert torch.equal(again.poses.R, tg.poses.R) and isinstance(again.edge_meas, SE3)
    np.testing.assert_array_equal(to_np(tg.edge_weight), np.asarray(jg.edge_weight))

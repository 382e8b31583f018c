"""Port parity: linearize / solve / step units and `register()` of
`icpx_torch` against `icpx`, and the slice end to end (cat golden pair,
65k-style synthetic pair at 2048 points).

Unit tolerances: JtJ / Jtr rtol 1e-4; solves x rtol 1e-4, atol 1e-7.

Histories. Both packages score NN candidates in fp32, the port by the
direct (q - r)^2 form and the JAX package by the |q|^2 + |r|^2 - 2 q.r
expansion, so near-ties between candidates resolve by each side's own
rounding. While the alignment is coarse (rmse > 1 on the cat pair) that
changes nothing measurable and the histories agree within rtol 1e-3; once
the clouds nearly coincide, those near-ties move the per-iteration sums
by up to ~1% (measured 6e-3 on the cat pair's 4th iteration, with either
scoring form in the port), and the last iteration sits at the fp32
coordinate-resolution floor (rmse ~1e-5 at coordinates ~50). Those
iterations are held to rtol 1e-2, the floor to an absolute bound, and the
final transforms to 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icpx.cloud import PointCloud as JCloud
from icpx.distributed.fault import degenerate_solve_guard as j_guard
from icpx.geometry.transforms import make_rigid_perturbation as j_perturb
from icpx.io.loaders import load_cat_pair as j_load_cat_pair
from icpx.io.loaders import synthetic_surface
from icpx.kernels.normals import estimate_normals as j_estimate_normals
from icpx.registration import linearize as jlin
from icpx.registration import solve as jsolve
from icpx.registration import step as jstep
from icpx.registration.icp import ICPConfig as JConfig
from icpx.registration.icp import format_trace as j_format_trace
from icpx.registration.icp import register as j_register
from icpx_torch import interop
from icpx_torch.distributed.fault import degenerate_solve_guard
from icpx_torch.geometry.transforms import make_rigid_perturbation
from icpx_torch.registration import linearize as tlin
from icpx_torch.registration import solve as tsolve
from icpx_torch.registration import step as tstep
from icpx_torch.registration.icp import ICPConfig, format_trace, register
from torch_parity import to_np, torch_cloud, torch_config, torch_se3



def T(x):
    """numpy -> CPU tensor (a copy: JAX's host arrays are read-only)."""
    return torch.tensor(np.array(x))

CAT_CFG = dict(objective="symmetric", max_iters=20, diff_threshold=1.0,
               max_corr_dist=50.0, robust="huber")


def _corr(n=700, seed=0):
    """Random correspondence data (p, q, n_p, n_q, w) as float32 numpy."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    q = (p + 0.05 * rng.normal(size=(n, 3))).astype(np.float32)
    n_p = rng.normal(size=(n, 3)).astype(np.float32)
    n_p /= np.linalg.norm(n_p, axis=1, keepdims=True)
    n_q = (n_p + 0.1 * rng.normal(size=(n, 3))).astype(np.float32)
    n_q /= np.linalg.norm(n_q, axis=1, keepdims=True)
    w = rng.uniform(0.0, 1.0, n).astype(np.float32)
    w[rng.uniform(size=n) < 0.1] = 0.0
    return p, q, n_p, n_q, w


def _close_ne(t, j):
    np.testing.assert_allclose(to_np(t.JtJ), np.asarray(j.JtJ), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(t.Jtr), np.asarray(j.Jtr), rtol=1e-4, atol=1e-5)
    for f in ("sq_residual_sum", "weight_sum", "p_centroid_num", "q_centroid_num"):
        np.testing.assert_allclose(to_np(getattr(t, f)), np.asarray(getattr(j, f)),
                                   rtol=1e-4, atol=1e-5)


def test_normal_equations_match_jax():
    p, q, n_p, n_q, w = _corr()
    jpb, jqb = jlin.weighted_centroids(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w))
    tpb, tqb = tlin.weighted_centroids(T(p), T(q), T(w))
    np.testing.assert_allclose(to_np(tpb), np.asarray(jpb), rtol=1e-5, atol=1e-6)
    _close_ne(
        tlin.build_normal_equations_symmetric(T(p), T(q), T(n_p), T(n_q), T(w), tpb, tqb),
        jlin.build_normal_equations_symmetric(*map(jnp.asarray, (p, q, n_p, n_q, w)), jpb, jqb),
    )
    _close_ne(
        tlin.build_normal_equations_p2plane(T(p), T(q), T(n_q), T(w)),
        jlin.build_normal_equations_p2plane(*map(jnp.asarray, (p, q, n_q, w))),
    )


@pytest.mark.parametrize("kind", ["none", "huber", "tukey", "welsch", "cauchy"])
def test_robust_weight_and_mad_scale_match_jax(kind):
    rng = np.random.default_rng(1)
    r = np.abs(rng.normal(size=501)).astype(np.float32)
    valid = (rng.uniform(size=501) > 0.2).astype(np.float32)
    js = jlin.mad_scale(jnp.asarray(r), jnp.asarray(valid))
    ts = tlin.mad_scale(T(r), T(valid))
    assert float(ts) == pytest.approx(float(js), rel=1e-6)
    np.testing.assert_allclose(
        to_np(tlin.robust_weight(T(r), kind, ts)),
        np.asarray(jlin.robust_weight(jnp.asarray(r), kind, js)), rtol=1e-5, atol=1e-7,
    )
    # no valid entry: scale falls back to 1.4826
    assert float(tlin.mad_scale(T(r), T(valid * 0))) == pytest.approx(1.4826)


@pytest.mark.parametrize("damping,clamp", [(1e-6, 0.0), (1e-3, 0.0), (1e-6, 1e-2)])
def test_solve_and_reconstruct_match_jax(damping, clamp):
    p, q, n_p, n_q, w = _corr(seed=2)
    ne = jlin.build_normal_equations_symmetric(
        *map(jnp.asarray, (p, q, n_p, n_q, w)), jnp.zeros(3), jnp.zeros(3))
    JtJ, Jtr = np.asarray(ne.JtJ), np.asarray(ne.Jtr)
    if clamp:
        # a well-conditioned system with one weakly observed direction
        # (eigenvalue 0.05 < clamp * 10) for the clamp to drop
        V = np.linalg.qr(np.random.default_rng(6).normal(size=(6, 6)))[0]
        JtJ = ((V * np.float64([10, 8, 5, 3, 1, 0.05])) @ V.T).astype(np.float32)
    xj = np.asarray(jsolve.solve_damped_6x6(jnp.asarray(JtJ), jnp.asarray(Jtr), damping, clamp))
    xt = to_np(tsolve.solve_damped_6x6(T(JtJ), T(Jtr), damping, clamp))
    np.testing.assert_allclose(xt, xj, rtol=1e-4, atol=1e-7)
    pb, qb = np.float32([0.3, -0.2, 0.1]), np.float32([1.0, 2.0, -0.5])
    x = np.float32([0.05, -0.1, 0.2, 0.3, -0.4, 0.5])
    for jf, tf, args in (
        (jsolve.reconstruct_symmetric_transform, tsolve.reconstruct_symmetric_transform, (pb, qb)),
        (jsolve.reconstruct_about_point, tsolve.reconstruct_about_point, (pb,)),
        (jsolve.reconstruct_p2plane_transform, tsolve.reconstruct_p2plane_transform, ()),
    ):
        for xx in (x, np.zeros(6, np.float32)):  # and the zero-rotation branch
            js = jf(jnp.asarray(xx), *map(jnp.asarray, args))
            ts = tf(T(xx), *map(T, args))
            np.testing.assert_allclose(to_np(ts.R), np.asarray(js.R), atol=1e-6)
            np.testing.assert_allclose(to_np(ts.t), np.asarray(js.t), atol=1e-6)


@pytest.mark.parametrize(
    "cfg",
    [
        dict(objective="symmetric", robust="huber", max_corr_dist=1.0),
        dict(objective="p2plane", robust="tukey", robust_scale=0.05),
        dict(objective="p2p", robust="none", trim_fraction=0.8),
        dict(objective="p2p", robust="cauchy"),
    ],
)
def test_step_units_match_jax(cfg):
    p, q, n_p, n_q, _ = _corr(seed=3)
    rng = np.random.default_rng(4)
    dist = np.linalg.norm(p - q, axis=1).astype(np.float32)
    dist[rng.uniform(size=len(dist)) < 0.05] = np.inf  # misses
    src_mask = rng.uniform(size=len(dist)) > 0.1
    jc, tc = JConfig(**cfg), ICPConfig(**cfg)
    jw = jstep.correspondence_weights(jc, *map(jnp.asarray, (p, n_p, q, n_q, dist, src_mask)))
    tw = tstep.correspondence_weights(tc, *map(T, (p, n_p, q, n_q, dist, src_mask)))
    np.testing.assert_allclose(to_np(tw), np.asarray(jw), rtol=1e-5, atol=1e-7)
    ji = jstep.estimate_increment(jc, *map(jnp.asarray, (p, q, n_p, n_q)), jw)
    ti = tstep.estimate_increment(tc, *map(T, (p, q, n_p, n_q)), tw)
    np.testing.assert_allclose(to_np(ti.R), np.asarray(ji.R), atol=2e-6)
    np.testing.assert_allclose(to_np(ti.t), np.asarray(ji.t), atol=2e-6)
    js = jstep.step_stats(jc, *map(jnp.asarray, (p, q, dist, src_mask)))
    ts = tstep.step_stats(tc, *map(T, (p, q, dist, src_mask)))
    for a, b in zip(ts, js):
        assert float(a) == pytest.approx(float(b), rel=1e-5)


def test_p2p_reflection_gives_a_rotation():
    """Kabsch on mirrored data: the det-sign fix must return a proper
    rotation, the same one as the JAX package."""
    rng = np.random.default_rng(5)
    p = rng.normal(size=(200, 3)).astype(np.float32) * np.float32([3, 2, 1])
    q = p * np.float32([1, 1, -1])
    w = np.ones(200, np.float32)
    jc, tc = JConfig(objective="p2p"), ICPConfig(objective="p2p")
    ji = jstep.estimate_increment(jc, jnp.asarray(p), jnp.asarray(q), None, None, jnp.asarray(w))
    ti = tstep.estimate_increment(tc, T(p), T(q), None, None, T(w))
    assert float(torch.linalg.det(ti.R)) == pytest.approx(1.0, abs=1e-5)
    np.testing.assert_allclose(to_np(ti.R), np.asarray(ji.R), atol=1e-5)


def test_degenerate_solve_guard_matches_jax():
    js_new, js_old = j_perturb(angle=0.3), j_perturb(angle=0.1)
    ts_new, ts_old = torch_se3(js_new), torch_se3(js_old)
    for diff, rmse, count in ((1.0, 0.5, 10.0), (np.nan, 0.5, 10.0), (1.0, 0.5, 2.0)):
        jst = jstep.StepStats(jnp.float32(diff), jnp.float32(rmse), jnp.float32(count))
        tst = tstep.StepStats(*(torch.tensor(v, dtype=torch.float32) for v in (diff, rmse, count)))
        (jT, jok), (tT, tok) = j_guard(js_new, jst, js_old), degenerate_solve_guard(ts_new, tst, ts_old)
        assert bool(tok) == bool(jok)
        np.testing.assert_allclose(to_np(tT.R), np.asarray(jT.R), atol=1e-7)
    bad = ts_new.replace(t=torch.tensor([np.nan, 0.0, 0.0]))
    _, ok = degenerate_solve_guard(bad, tstep.StepStats(*(torch.tensor(1.0),) * 3 ), ts_old)
    assert not bool(ok)


def test_config_converts_field_for_field():
    for jc in (JConfig(), JConfig(**CAT_CFG), JConfig(nn_method="brute", tile_r=8192)):
        tc = torch_config(jc)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert [f.name for f in dataclasses.fields(ICPConfig)] == [
        f.name for f in dataclasses.fields(JConfig)]
    with pytest.raises(ValueError):
        interop.config_from_dict({"objective": "symmetric", "bogus": 1})
    for bad in (dict(objective="x"), dict(nn_method="kd"), dict(refine_full_iters=0),
                dict(feat_nn="intensity")):
        with pytest.raises(ValueError):
            JConfig(**bad)
        with pytest.raises(ValueError):
            ICPConfig(**bad)


def test_unported_paths_raise():
    tc = torch_cloud(JCloud.create(synthetic_surface(300, seed=1)))
    # GICP runs now (covariances estimated inside register()): an
    # identical pair stays put
    res = register(tc, tc, ICPConfig(objective="gicp"))
    assert torch.allclose(res.transform.R, torch.eye(3), atol=1e-3)
    assert float(res.transform.t.norm()) < 1e-3 and torch.isfinite(res.final_rmse)
    # block NN runs every payload mode now, whether auto (from 8192 target
    # points) or nn_method="block" picked it: an identical pair stays put
    big = torch_cloud(JCloud.create(synthetic_surface(8192, seed=1)))
    for a, cfg in ((big, ICPConfig(payload_mode="select")),
                   (tc, ICPConfig(nn_method="block", payload_mode="vmem7"))):
        res = register(a, a, cfg)
        assert torch.allclose(res.transform.R, torch.eye(3), atol=1e-3)
        assert float(res.transform.t.norm()) < 1e-3 and torch.isfinite(res.final_rmse)
    with pytest.raises(ValueError, match="block NN"):
        register(tc, tc, ICPConfig(feat_nn="intensity", feat_nn_weight=1.0))


def _shuffled_cat():
    src, tgt = j_load_cat_pair()
    tgt_np = tgt.to_numpy()
    tsh = JCloud.create(tgt_np[np.random.default_rng(0).permutation(len(tgt_np))])
    return src, tgt_np, tsh


def test_cat_pair_shuffled_recovers_gt_and_matches_jax():
    """The golden test through the port: the shuffled cat pair recovers
    Rz(pi/4) + (2.5, 0, 0), in as many iterations as the JAX run."""
    src, tgt_np, tsh = _shuffled_cat()
    res = register(torch_cloud(src), torch_cloud(tsh), ICPConfig(**CAT_CFG))
    rot_err, t_err = res.transform.distance_to(make_rigid_perturbation(device="cpu"))
    assert float(rot_err) < 5e-3 and float(t_err) < 0.5
    pred = to_np(res.transform.apply(T(np.asarray(src.xyz))))[np.asarray(src.mask)]
    assert float(np.sqrt(((pred - tgt_np) ** 2).sum(1).mean())) < 0.5
    assert bool(res.converged)
    jres = j_register(src, tsh, JConfig(**CAT_CFG))
    assert res.iters == int(jres.iters)
    np.testing.assert_allclose(to_np(res.transform.R), np.asarray(jres.transform.R), atol=1e-5)
    np.testing.assert_allclose(to_np(res.transform.t), np.asarray(jres.transform.t), atol=1e-4)
    assert int(res.inlier_count) == int(jres.inlier_count)
    assert format_trace(res).splitlines()[-1].split()[:2] == \
        j_format_trace(jres).splitlines()[-1].split()[:2]


def test_cat_pair_histories_match_jax():
    """Per-iteration histories against the JAX run, with the same normals
    handed to both (the JAX package's, estimated in the target-centroid
    frame as `register` would): the cat cloud has many exactly tied
    neighbour distances, so each side's own kNN rounding picks a different
    10th neighbour for a handful of points (see the normals tests)."""
    src, _, tsh = _shuffled_cat()
    c = tsh.centroid()
    src = src.replace(normals=j_estimate_normals(src.with_xyz(src.xyz - c[None]), k=10).normals)
    tsh = tsh.replace(normals=j_estimate_normals(tsh.with_xyz(tsh.xyz - c[None]), k=10).normals)
    jres = j_register(src, tsh, JConfig(**CAT_CFG))
    res = register(torch_cloud(src), torch_cloud(tsh), ICPConfig(**CAT_CFG))
    k = int(jres.iters)
    assert res.iters == k
    jd, jr = np.asarray(jres.diff_history), np.asarray(jres.rmse_history)
    td, tr = to_np(res.diff_history), to_np(res.rmse_history)
    assert np.isnan(td[k:]).all() and np.isnan(tr[k:]).all()
    coarse = jr[:k] > 1.0
    floor = jr[:k] < 1e-4
    assert coarse.sum() >= 3 and floor[-1]
    np.testing.assert_allclose(td[:k][coarse], jd[:k][coarse], rtol=1e-3)
    np.testing.assert_allclose(tr[:k][coarse], jr[:k][coarse], rtol=1e-3)
    mid = ~coarse & ~floor
    np.testing.assert_allclose(td[:k][mid], jd[:k][mid], rtol=1e-2)
    np.testing.assert_allclose(tr[:k][mid], jr[:k][mid], rtol=1e-2)
    assert (tr[:k][floor] < 1e-4).all()
    np.testing.assert_allclose(to_np(res.transform.R), np.asarray(jres.transform.R), atol=1e-5)
    np.testing.assert_allclose(to_np(res.transform.t), np.asarray(jres.transform.t), atol=1e-4)


def _transform_gap(res, jres):
    """(rotation angle, translation distance) between the two results'
    transforms, for small angles: the angle comes from the skew part of
    Ra^T Rb in float64 (the arccos of the trace in `distance_to` cannot
    resolve angles below ~5e-4 rad in fp32)."""
    Ra, Rb = to_np(res.transform.R).astype(np.float64), np.asarray(jres.transform.R, np.float64)
    M = Ra.T @ Rb
    w = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    dt = to_np(res.transform.t).astype(np.float64) - np.asarray(jres.transform.t, np.float64)
    return float(np.arcsin(min(0.5 * np.linalg.norm(w), 1.0))), float(np.linalg.norm(dt))


def _synthetic_pair(n):
    """bench.py's pair construction at n points, carried across as numpy."""
    src = JCloud.create(synthetic_surface(n, seed=0))
    gt = j_perturb(angle=0.2, translation=(0.12, -0.06, 0.03))
    tgt_np = np.asarray(gt.apply(src.xyz))[: src.capacity]
    perm = np.random.default_rng(1).permutation(src.capacity)
    tgt = JCloud.create(tgt_np[perm], capacity=src.capacity).replace(mask=src.mask[perm])
    return src, tgt, gt


@pytest.mark.parametrize("objective", ["symmetric", "p2plane"])
def test_synthetic_pair_matches_jax(objective):
    """bench.py's brute configuration at 2048 points: final transforms
    within 1e-4 (rad and units) of the JAX run, iterations within one."""
    src, tgt, gt = _synthetic_pair(2048)
    cfg = JConfig(objective=objective, max_iters=10, diff_threshold=0.0, rmse_change_tol=1e-6,
                  k_normals=10, nn_method="brute", tile_q=2048, tile_r=8192)
    jres = j_register(src, tgt, cfg)
    res = register(torch_cloud(src), torch_cloud(tgt), torch_config(cfg))
    assert abs(res.iters - int(jres.iters)) <= 1
    d_rot, d_t = _transform_gap(res, jres)
    assert d_rot < 1e-4 and d_t < 1e-4, (d_rot, d_t)
    rot_err, t_err = res.transform.distance_to(torch_se3(gt))
    assert float(rot_err) < 5e-3 and float(t_err) < 5e-3
    out = interop.result_to_numpy(res)
    assert out["R"].shape == (3, 3) and out["diff_history"].shape == (10,)


def test_p2p_with_source_weights_matches_jax():
    src, tgt, _ = _synthetic_pair(1024)
    w = np.ones(src.capacity, np.float32)
    w[::3] = 0.25
    cfg = JConfig(objective="p2p", max_iters=6, diff_threshold=0.0, nn_method="brute")
    jres = j_register(src, tgt, cfg, src_weight=jnp.asarray(w))
    res = register(torch_cloud(src), torch_cloud(tgt), torch_config(cfg), src_weight=T(w))
    assert res.iters == int(jres.iters)
    d_rot, d_t = _transform_gap(res, jres)
    assert d_rot < 1e-4 and d_t < 1e-4, (d_rot, d_t)

"""Port parity: the distributed layer's mesh, collectives, ring NN and
sharded ICP (`icpx_torch.distributed`) against `icpx.distributed`.

The port runs in gloo rank processes on the CPU (`torch_dist.RankPool`,
torch only), at W = 1, 2 and 4 ranks and a (pairs 2 x points 2) mesh; the
JAX package runs the same inputs, made with numpy from a seed, on a mesh of
the same shape over `jax.devices()[:W]` (the 8 host devices that
`tests/conftest.py` forces).
Tolerances: R, t and the final RMSE within 1e-5 (gloo's all-reduce and
XLA's psum round in their own orders), 1e-4 where the histogram quantiles
of the MAD scale and the trim fraction decide the weights; every rank
returns the same result bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icpx.cloud import PointCloud
from icpx.distributed.mesh import make_mesh as j_make_mesh
from icpx.distributed.mesh import mesh_shape_for as j_mesh_shape_for
from icpx.distributed.sharded_icp import sharded_register as j_sharded_register
from icpx.distributed.sharded_icp import sharded_register_pairs as j_sharded_pairs
from icpx.geometry.se3 import SE3
from icpx.io.loaders import synthetic_surface
from icpx.kernels.knn import nearest_neighbor as j_nearest_neighbor
from icpx.kernels.normals import estimate_covariances, estimate_normals
from icpx.registration.icp import ICPConfig, register
from icpx_torch.distributed import comm
from icpx_torch.distributed.mesh import make_mesh, mesh_shape_for
from torch_dist import RankPool
from torch_parity import torch_cloud, torch_config

TOL = 1e-5
TOL_HIST = 1e-4


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _jmesh(w, names=("points",), shape=None):
    return j_make_mesh(shape=shape, axis_names=names, devices=jax.devices()[:w])


def _pair(n=1024, seed=0, angle=0.2, trans=0.15):
    """tests/test_distributed.py's pair: a surface and its shuffled image."""
    xyz = synthetic_surface(n, seed=seed)
    src = PointCloud.create(xyz)
    axis = jnp.asarray([0.0, 0.3, 0.954]) / np.linalg.norm([0.0, 0.3, 0.954])
    gt = SE3.from_axis_angle(axis, angle, jnp.asarray([trans, 0.0, -trans]))
    rng = np.random.default_rng(seed + 5)
    tgt_np = np.asarray(gt.apply(src.xyz))[:n][rng.permutation(n)]
    return src, PointCloud.create(tgt_np), gt


def _cd(c):
    """A JAX cloud's arrays for the rank processes."""
    d = {"xyz": np.asarray(c.xyz), "mask": np.asarray(c.mask)}
    for f in ("normals", "covs", "feats"):
        if getattr(c, f) is not None:
            d[f] = np.asarray(getattr(c, f))
    if c.feat_names:
        d["feat_names"] = tuple(c.feat_names)
    return d


def _replicated(results):
    """Every rank returned the same result bit for bit; rank 0's."""
    for r in results[1:]:
        for k in ("R", "t", "final_rmse"):
            np.testing.assert_array_equal(r[k], results[0][k])
    assert not any(r["jax_loaded"] for r in results)
    return results[0]


def _close(rt, jres, tol):
    np.testing.assert_allclose(rt["R"], np.asarray(jres.transform.R), atol=tol, rtol=0)
    np.testing.assert_allclose(rt["t"], np.asarray(jres.transform.t), atol=tol, rtol=0)
    np.testing.assert_allclose(rt["final_rmse"], np.asarray(jres.final_rmse), atol=tol, rtol=0)


def _gt_gate(rt, gt, tol=5e-3):
    R, t = np.asarray(gt.R, np.float64), np.asarray(gt.t, np.float64)
    rel = R.T @ rt["R"].astype(np.float64)
    ang = np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1))
    assert ang < tol and np.linalg.norm(rt["t"] - t) < tol, (ang, rt["t"], t)


# ---- the mesh and the collectives --------------------------------------------------------


@pytest.mark.parametrize("n,pairs", [(8, None), (8, 4), (8, 3), (6, 12), (4, 2), (1, 5)])
def test_mesh_shape_for(n, pairs):
    assert mesh_shape_for(n, n_pairs=pairs) == j_mesh_shape_for(n, n_pairs=pairs)


def test_make_mesh_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 1), device="cuda")


@pytest.mark.parametrize("w", [1, 2, 4])
def test_mesh_over_ranks(pool, w):
    shape = (1, w) if w < 4 else (2, 2)
    res = pool.run("mesh", w, shape=shape, names=("pairs", "points"))
    jm = _jmesh(w, ("pairs", "points"), shape)
    for r, out in enumerate(res):
        assert out["shape"] == tuple(jm.devices.shape) and out["names"] == jm.axis_names
        assert out["index"] == {"pairs": r // shape[1], "points": r % shape[1]}
        assert out["size"] == {"pairs": shape[0], "points": shape[1]}
    with pytest.raises(RuntimeError, match="mesh shape"):
        pool.run("mesh", w, shape=(w, 2), names=("pairs", "points"))


@pytest.mark.parametrize("w", [1, 2, 4])
def test_comm_collectives(pool, w):
    """psum sums every leaf over the group; at ring step s rank r holds
    shard (r + s) % W; a forward permute leaves zeros where nothing
    arrives; all_to_all's row j is what rank j sent (lax.all_to_all's chunk
    order); all_gather concatenates in rank order; each kind is recorded
    under XLA's opcode name with its bytes, and each ring shift has a fold
    between its post and its wait."""
    res = pool.run("comm", w)
    for r, out in enumerate(res):
        total = sum(range(1, w + 1))
        np.testing.assert_array_equal(out["psum"][0], np.float32(total))
        np.testing.assert_array_equal(out["psum"][1], np.full((2, 3), sum(range(w)), np.float32))
        np.testing.assert_array_equal(out["psum"][2], [sum(range(w))])
        assert out["held"] == [(r + s) % w for s in range(w)]
        np.testing.assert_array_equal(out["fwd"], [10.0 * (r - 1) if r > 0 else 0.0])
        want = np.stack([np.arange(w * 2, dtype=np.float32).reshape(w, 2)[r] + 100 * j
                         for j in range(w)])
        np.testing.assert_array_equal(out["a2a"], want)
        np.testing.assert_array_equal(out["gather"][0], np.repeat(np.arange(w), 2))
        np.testing.assert_array_equal(out["gather"][1], np.arange(w) % 2 == 1)
        kinds = [k for k, _, _ in out["kinds"]]
        assert kinds[:2] == ["all-reduce", "all-reduce"] and out["kinds"][0][2] == 4 * 7
        assert kinds[-3:] == ["all-to-all", "all-gather", "all-gather"]
        if w > 1:
            assert out["overlap"] == [1] * (w - 1)
            assert out["ring_kinds"][:3] == [("collective-permute", "post"), ("fold", ""),
                                             ("collective-permute", "wait")]
        else:
            assert "collective-permute" not in kinds


@pytest.mark.parametrize("w", [2, 4])
def test_ring_nn_matches_jax(pool, w):
    """tests/test_distributed.py's ring case: each rank answers the whole
    query set against the union of the shards; equal to the JAX ring at the
    same W, and the exact NN."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(256, 3)).astype(np.float32)
    r = rng.normal(size=(512, 3)).astype(np.float32)
    mask = np.ones(512, bool)
    mask[rng.permutation(512)[:40]] = False
    payload = rng.normal(size=(512, 4)).astype(np.float32)
    res = pool.run("ring_nn", w, q=q, r=r, mask=mask, payload=payload, tile_q=64, tile_r=64)
    from functools import partial

    from jax.sharding import PartitionSpec as P

    from icpx.distributed.ring import ring_nearest_neighbor

    @jax.jit
    @partial(jax.shard_map, mesh=_jmesh(w), in_specs=(P(), P("points"), P("points"),
                                                      P("points")),
             out_specs=(P(), P(), P()), check_vma=False)
    def run(qq, rr, mm, pl):
        return ring_nearest_neighbor(qq, rr, mm, "points", payload_shard=pl, tile_q=64, tile_r=64)

    d_j, i_j, pl_j = (np.asarray(x) for x in run(q, r, mask, payload))
    d_ref, _ = j_nearest_neighbor(q, r, ref_mask=mask)
    for out in res:
        np.testing.assert_allclose(out["d"], d_j, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(out["i"], i_j)
        np.testing.assert_array_equal(out["pl"], payload[out["i"]])
        np.testing.assert_array_equal(out["pl"], pl_j)
        np.testing.assert_allclose(out["d"], np.asarray(d_ref), rtol=0, atol=1e-5)
        # the shifts ride behind the folds: post, fold, wait at every step
        # but the last, which posts nothing
        assert out["order"] == [("collective-permute", "post"), ("fold", ""),
                                ("collective-permute", "wait")] * (w - 1) + [("fold", "")]


# ---- sharded_register ---------------------------------------------------------------------


def _normals(src, tgt, k):
    return estimate_normals(src, k=k), estimate_normals(tgt, k=k)


def _run_pair(pool, w, src, tgt, cfg, ring):
    res = _replicated(pool.run("sharded_register", w, src=_cd(src), tgt=_cd(tgt),
                               config=dataclasses.asdict(cfg), ring=ring))
    return res, j_sharded_register(src, tgt, cfg, _jmesh(w), ring=ring)


@pytest.mark.parametrize("w,ring", [(1, False), (4, False), (2, True)])
def test_sharded_register_brute_matches_jax(pool, w, ring):
    """The brute path (the nn kernel per shard on the card), the target
    replicated or riding the ring; robust settings exact, so W = 1 also
    equals the port's register() to 1e-5."""
    src, tgt, gt = _pair()
    cfg = ICPConfig(objective="symmetric", max_iters=10, diff_threshold=1e-5, tile_q=256,
                    tile_r=256)
    src, tgt = _normals(src, tgt, cfg.k_normals)
    res, jres = _run_pair(pool, w, src, tgt, cfg, ring)
    _close(res, jres, TOL)
    assert int(res["iters"]) == int(jres.iters)
    _gt_gate(res, gt)
    if w == 1:
        from icpx_torch.registration.icp import register as t_register

        single = t_register(torch_cloud(src), torch_cloud(tgt), torch_config(cfg))
        np.testing.assert_allclose(res["R"], single.transform.R.numpy(), atol=TOL, rtol=0)
        np.testing.assert_allclose(res["t"], single.transform.t.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("w,ring", [(2, True), (4, False)])
def test_sharded_register_block_matches_jax(pool, w, ring):
    """The block path: a per-shard KD index of the local source (the sort
    kernel on the card), tile-index NN against the whole target or, with
    the ring, per-shard target indexes whose tiles and payload rotate."""
    src, tgt, gt = _pair(n=4096, seed=3)
    cfg = ICPConfig(objective="symmetric", max_iters=12, diff_threshold=1e-6, nn_method="block",
                    block_tile=64, block_q_tile=32, block_k=6, robust="huber")
    src, tgt = _normals(src, tgt, cfg.k_normals)
    res, jres = _run_pair(pool, w, src, tgt, cfg, ring)
    _close(res, jres, TOL)
    assert int(res["iters"]) == int(jres.iters)


def test_sharded_gicp_ring_matches_jax(pool):
    """GICP: the 9-wide covariance channel rides the ring's payload."""
    src, tgt, gt = _pair(n=1024, seed=7, angle=0.15, trans=0.1)
    cfg = ICPConfig(objective="gicp", max_iters=12, diff_threshold=1e-6, tile_q=256, tile_r=256)
    src, tgt = estimate_covariances(src, k=15), estimate_covariances(tgt, k=15)
    res, jres = _run_pair(pool, 2, src, tgt, cfg, True)
    _close(res, jres, TOL)
    _gt_gate(res, gt)


def test_sharded_feat_nn_matches_jax(pool):
    """feat_nn on the sharded block path: the degenerate plane only the 4D
    metric solves (tests/test_distributed.py's case), ring mode at W = 2."""
    n = 8192
    rng = np.random.default_rng(11)
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    xyz = np.concatenate([xy, np.zeros((n, 1), np.float32)], 1)
    inten = 3.0 * xy[:, 0]
    shift = np.asarray([0.15, 0.0, 0.0], np.float32)
    src = PointCloud.create(xyz, feats=inten, feat_names=("intensity",))
    tgt = PointCloud.create(xyz + shift, feats=inten, feat_names=("intensity",))
    cfg = ICPConfig(objective="p2p", max_iters=25, diff_threshold=0.0, rmse_change_tol=1e-7,
                    nn_method="block", block_tile=64, block_q_tile=32, feat_nn="intensity",
                    feat_nn_weight=1.0)
    res, jres = _run_pair(pool, 2, src, tgt, cfg, True)
    np.testing.assert_allclose(res["R"], np.asarray(jres.transform.R), atol=TOL_HIST, rtol=0)
    np.testing.assert_allclose(res["t"], np.asarray(jres.transform.t), atol=TOL_HIST, rtol=0)
    assert np.linalg.norm(res["t"] - shift) < 0.02


@pytest.mark.parametrize("w", [4])
def test_robust_stats_shard_independent(pool, w):
    """The MAD scale and the trim quantile from psum'd histograms: the port
    at W ranks equals the JAX package at W devices, and its W = 4 run
    equals its own W = 1 run (the histograms do not see the layout)."""
    src, tgt, gt = _pair(n=2048, seed=11)
    cfg = ICPConfig(objective="symmetric", max_iters=10, diff_threshold=1e-6, robust="huber",
                    robust_scale=0.0, trim_fraction=0.9, tile_q=256, tile_r=256)
    src, tgt = _normals(src, tgt, cfg.k_normals)
    res, jres = _run_pair(pool, w, src, tgt, cfg, False)
    _close(res, jres, TOL_HIST)
    _gt_gate(res, gt)
    if w == 4:
        one = _replicated(pool.run("sharded_register", 1, src=_cd(src), tgt=_cd(tgt),
                                   config=dataclasses.asdict(cfg)))
        np.testing.assert_allclose(res["R"], one["R"], atol=TOL_HIST, rtol=0)
        np.testing.assert_allclose(res["t"], one["t"], atol=TOL_HIST, rtol=0)
        # and the single-device exact quantiles agree to the same resolution
        np.testing.assert_allclose(res["t"], np.asarray(register(src, tgt, cfg).transform.t),
                                   atol=TOL_HIST, rtol=0)


# ---- data-parallel pairs ----------------------------------------------------------------


def _pairs_arrays(b, n, objective):
    srcs, tgts, gts = [], [], []
    for i in range(b):
        s, t, g = _pair(n=n, seed=20 + i, angle=0.15, trans=0.1)
        if objective == "gicp":
            s, t = estimate_covariances(s, k=15), estimate_covariances(t, k=15)
        else:
            s, t = estimate_normals(s, k=8), estimate_normals(t, k=8)
        srcs.append(s)
        tgts.append(t)
        gts.append(g)

    def aux(c):
        return c.covs.reshape(n, 9) if objective == "gicp" else c.normals

    arrays = [jnp.stack([f(c) for c in cs]) for cs in (srcs, tgts)
              for f in (lambda c: c.xyz, lambda c: c.mask, aux)]
    return arrays, gts


@pytest.mark.parametrize("shape", [(2, 2)])
def test_sharded_register_pairs_matches_jax(pool, shape):
    """DP over pairs x points (pairs 2 x points 2): every rank returns the
    whole batch, equal to the JAX mesh of the same shape."""
    cfg = ICPConfig(objective="symmetric", max_iters=10, diff_threshold=1e-5, k_normals=8,
                    tile_q=128, tile_r=128)
    arrays, gts = _pairs_arrays(2, 512, "symmetric")
    out = _replicated(pool.run("pairs", 4, arrays=[np.asarray(a) for a in arrays],
                               config=dataclasses.asdict(cfg), shape=shape))
    jres = j_sharded_pairs(*arrays, cfg, _jmesh(4, ("pairs", "points"), shape))
    _close(out, jres, TOL)
    np.testing.assert_array_equal(out["iters"], np.asarray(jres.iters))
    for i, g in enumerate(gts):
        _gt_gate({"R": out["R"][i], "t": out["t"][i]}, g)


def test_pairs_aux_width_validated(pool):
    """GICP needs (B, N, 9) covariances in the aux channel, the normals
    objectives (B, N, 3): a mismatch is refused, as in the reference."""
    z3 = np.zeros((2, 256, 3), np.float32)
    z9 = np.zeros((2, 256, 9), np.float32)
    m = np.ones((2, 256), bool)
    for aux, objective, match in ((z3, "gicp", "covariances"), (z9, "symmetric", "aux channel width")):
        cfg = dataclasses.asdict(ICPConfig(objective=objective))
        out = pool.run("pairs", 1, arrays=[z3, m, aux, z3, m, aux], config=cfg, shape=(1, 1))
        assert match in out[0]["error"]
        with pytest.raises(ValueError, match=match):
            j_sharded_pairs(*(jnp.asarray(a) for a in (z3, m, aux, z3, m, aux)),
                            ICPConfig(objective=objective), _jmesh(2, ("pairs", "points"), (2, 1)))

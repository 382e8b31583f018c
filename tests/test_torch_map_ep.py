"""Port parity: map blocks and all-to-all routed NN
(`icpx_torch.distributed.map_ep`) against `icpx.distributed.map_ep`.

`partition_map` runs in this process and must equal the JAX partition bit
for bit; the routed NN and scan-to-map ICP run in gloo rank processes
(`torch_dist.RankPool`) at W = 2 and 4 against the JAX package on a mesh
of the same size, fed the same `MapBlocks` (carried across as numpy).
Sizes are tests/test_map_ep.py's cheap ones (an 8,192-point map, 2,048
queries). Tolerances: routed distances within 1e-5 (the port answers with
`nearest_neighbor`, the reference with `_nearest_neighbor_jnp`: the same
contract, each rounding its expansion in its own order), the same points
dropped, matched rows equal except at near-ties; transforms within 1e-5.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from icpx.cloud import PointCloud
from icpx.distributed.map_ep import partition_map as j_partition_map
from icpx.distributed.map_ep import routed_map_nn as j_routed_map_nn
from icpx.distributed.map_ep import sharded_map_register as j_sharded_map_register
from icpx.distributed.mesh import make_mesh as j_make_mesh
from icpx.geometry.se3 import SE3
from icpx.io.loaders import synthetic_surface
from icpx.kernels.knn import _nearest_neighbor_jnp
from icpx.kernels.normals import estimate_normals
from icpx.registration.icp import ICPConfig
from icpx_torch import interop
from icpx_torch.distributed.map_ep import partition_map
from torch_dist import RankPool

TOL = 1e-5


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _jmesh(w):
    return j_make_mesh(axis_names=("blocks",), devices=jax.devices()[:w])


def _map_cloud(n=8192, seed=0):
    xyz = synthetic_surface(n, seed=seed)
    return estimate_normals(PointCloud.create(xyz, capacity=n), k=8)


def _blocks_np(mb):
    return {f: np.asarray(getattr(mb, f)) for f in
            ("block_xyz", "block_normals", "block_mask", "boundaries", "lo", "inv_extent")}


@pytest.mark.parametrize("n_blocks", [2, 4, 8])
def test_partition_map_bit_equal(n_blocks):
    """The same Morton keys, stable order and equal-count boundaries: every
    array of the partition equal bit for bit (a third of the map masked
    out, so invalid rows sort last in both)."""
    pc = _map_cloud(4096)
    mask = np.asarray(pc.mask).copy()
    mask[np.random.default_rng(3).permutation(4096)[:1300]] = False
    jmb = j_partition_map(pc.xyz, pc.normals, jnp.asarray(mask), n_blocks=n_blocks)
    tmb = partition_map(torch.tensor(np.asarray(pc.xyz)), torch.tensor(np.asarray(pc.normals)),
                        torch.tensor(mask), n_blocks=n_blocks)
    for f, want in _blocks_np(jmb).items():
        got = getattr(tmb, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert tmb.n_blocks == n_blocks and tmb.block_size == 4096 // n_blocks
    # and it carries across to the port unchanged
    back = interop.map_blocks_from_numpy(jmb, device="cpu")
    for f, want in _blocks_np(jmb).items():
        np.testing.assert_array_equal(interop.map_blocks_to_numpy(back)[f], want)


def _j_routed(w, mb, q, kw):
    @jax.jit
    @partial(jax.shard_map, mesh=_jmesh(w),
             in_specs=(P("blocks", None), P("blocks", None, None), P("blocks", None, None),
                       P("blocks", None), P(None), P(None), P(None)),
             out_specs=(P("blocks"), P("blocks", None), P("blocks", None)), check_vma=False)
    def run(qs, bx, bn, bm, bounds, lo, inv_e):
        return j_routed_map_nn(qs, bx[0], bn[0], bm[0], bounds, lo, inv_e, "blocks", **kw)

    return [np.asarray(x) for x in run(jnp.asarray(q), mb.block_xyz, mb.block_normals,
                                       mb.block_mask, mb.boundaries, mb.lo, mb.inv_extent)]


@pytest.mark.parametrize("w,mode", [(2, "spatial"), (4, "spatial"), (4, "morton")])
def test_routed_nn_matches_jax(pool, w, mode):
    """Spatial and Morton routing with two hops: the same points dropped,
    distances within 1e-5, matched rows equal but at near-ties; and the
    reference test's recall against the exact NN over the whole map."""
    pc = _map_cloud(8192, seed=0)
    mb = j_partition_map(pc.xyz, pc.normals, pc.mask, n_blocks=w)
    q = synthetic_surface(2048, seed=1)
    kw = dict(n_route=2, tile_q=256, tile_r=512, route_mode=mode)
    res = pool.run("routed_nn", w, blocks=_blocks_np(mb), q=q, kw=kw)
    d_j, mx_j, mn_j = _j_routed(w, mb, q, kw)
    d = np.concatenate([r["d"] for r in res])
    mx = np.concatenate([r["mx"] for r in res])
    mn = np.concatenate([r["mn"] for r in res])
    np.testing.assert_array_equal(np.isfinite(d), np.isfinite(d_j))
    f = np.isfinite(d)
    np.testing.assert_allclose(d[f], d_j[f], rtol=0, atol=TOL)
    same = (mx == mx_j).all(1)
    assert same.mean() > 0.99
    np.testing.assert_array_equal(mn[same], mn_j[same])
    # a differing row is a near-tie: its match is as near as the reference's
    dd = ((q - mx) ** 2).sum(1)
    np.testing.assert_allclose(dd[f & ~same], d_j[f & ~same], rtol=0, atol=TOL)
    d_ref, _ = _nearest_neighbor_jnp(jnp.asarray(q), pc.xyz, ref_mask=pc.mask)
    d_ref = np.asarray(d_ref)
    assert f.mean() > 0.98
    if mode == "spatial":
        assert (d[f] <= d_ref[f] + 1e-6).mean() > 0.95


def _scan_case(seed=3):
    world = _map_cloud(8192, seed=seed)
    scan_xyz = world.to_numpy()[::4][:2048]
    gt = SE3.from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]), 0.06, jnp.asarray([0.03, -0.02, 0.01]))
    scan = PointCloud.create(np.asarray(gt.inverse().apply(jnp.asarray(scan_xyz))), capacity=2048)
    scan = estimate_normals(scan, k=8)
    cfg = ICPConfig(objective="p2plane", max_iters=10, diff_threshold=1e-5, max_corr_dist=0.3,
                    tile_q=256, tile_r=512)
    return world, scan, gt, cfg


@pytest.mark.parametrize("w,nn", [(2, "brute"), (4, "block")])
def test_sharded_map_register_matches_jax(pool, w, nn):
    """Scan-to-map ICP with the brute answer and with the block index
    (built once a registration): equal to the JAX run, and the GT gate of
    tests/test_map_ep.py."""
    world, scan, gt, cfg = _scan_case()
    mb = j_partition_map(world.xyz, world.normals, world.mask, n_blocks=w)
    scan_np = {"xyz": np.asarray(scan.xyz), "mask": np.asarray(scan.mask),
               "normals": np.asarray(scan.normals)}
    res = pool.run("map_register", w, scan=scan_np, blocks=_blocks_np(mb),
                   config=dataclasses.asdict(cfg), nn=nn)
    jres = j_sharded_map_register(scan, mb, cfg, _jmesh(w), nn=nn)
    for r in res[1:]:
        np.testing.assert_array_equal(r["R"], res[0]["R"])
    out = res[0]
    np.testing.assert_allclose(out["R"], np.asarray(jres.transform.R), atol=TOL, rtol=0)
    np.testing.assert_allclose(out["t"], np.asarray(jres.transform.t), atol=TOL, rtol=0)
    assert int(out["iters"]) == int(jres.iters)
    R, t = np.asarray(gt.R, np.float64), np.asarray(gt.t)
    ang = np.arccos(np.clip((np.trace(R.T @ out["R"]) - 1) / 2, -1, 1))
    assert ang < 5e-3 and np.linalg.norm(out["t"] - t) < 5e-3
    assert not any(r["jax_loaded"] for r in res)


def test_block_answer_matches_brute(pool):
    """The port's block answer against its brute answer on the same
    routing (W = 2): the exact rate of per-query candidate ranking."""
    pc = _map_cloud(8192, seed=5)
    mb = j_partition_map(pc.xyz, pc.normals, pc.mask, n_blocks=2)
    q = synthetic_surface(2048, seed=6)
    brute = pool.run("routed_nn", 2, blocks=_blocks_np(mb), q=q, kw=dict(n_route=2))
    block = pool.run("routed_nn", 2, blocks=_blocks_np(mb), q=q,
                     kw=dict(n_route=2, block_tile=64))
    d_b = np.concatenate([r["d"] for r in brute])
    d_k = np.concatenate([r["d"] for r in block])
    f = np.isfinite(d_b)
    np.testing.assert_array_equal(np.isfinite(d_k), f)
    assert (d_k[f] <= d_b[f] + 1e-6).mean() > 0.99


def test_mismatched_blocks_raise(pool):
    pc = _map_cloud(1024)
    mb = j_partition_map(pc.xyz, pc.normals, pc.mask, n_blocks=4)
    scan = estimate_normals(PointCloud.create(synthetic_surface(256)), k=8)
    scan_np = {"xyz": np.asarray(scan.xyz), "mask": np.asarray(scan.mask),
               "normals": np.asarray(scan.normals)}
    with pytest.raises(RuntimeError, match="4 blocks but mesh axis 'blocks' has 2"):
        pool.run("map_register", 2, scan=scan_np, blocks=_blocks_np(mb),
                 config=dataclasses.asdict(ICPConfig()), nn="auto")

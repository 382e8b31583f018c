"""Port parity: the feature-augmented block NN (`block_nn`,
`block_nn_payload` with `query_feat` / `feat_tiles`), the tile-index k-NN
`block_knn`, and `register()` with `feat_nn`, against `icpx`.

Inputs are made with numpy from a seed; both packages get the same KD
indexes (built by the JAX package, carried across). Tolerances: at score
precision "highest", d2 within 1e-6 of the score's scale, max over the
queries of |q|^2 + w^2 f_q^2: the expansion ||r||^2 - 2 q.r + ||q||^2 is
rounded at that scale, in a different summation order by each package, so
a small d2 agrees only to that absolute error; positions and payload rows
equal except where that rounding ranks a near-tie differently (then the
two winners' d2 agree within the same tolerance); `block_knn`'s index sets
equal except at k-th-boundary ties (the differing rows' k-th d2 within the
same tolerance); `register` with `feat_nn` on
tests/test_registration.py's degenerate plane: transform within 1e-4 and
the same iteration count.
"""

import numpy as np
import pytest
import torch

import icpx.kernels.blocknn as jb
import jax.numpy as jnp
from icpx.cloud import PointCloud as JCloud
from icpx.registration.icp import ICPConfig as JConfig
from icpx.registration.icp import register as j_register
from icpx_torch import interop
from icpx_torch.kernels import blocknn as tb
from icpx_torch.registration.icp import ICPConfig, register
from torch_parity import to_np, torch_cloud, torch_config


def _feature_case(n=4096, seed=21):
    """A reference cloud with a smooth intensity, queries near its points
    with their source point's intensity: (jq index, ji index, query_feat
    (Tq, Sq), feat_tiles (T, S), payload tiles (T, S, 4))."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    f_r = (np.sin(3 * r[:, 0]) + r[:, 1]).astype(np.float32)
    pick = rng.permutation(n)[: n // 2]
    q = (r[pick] + rng.normal(0, 0.01, (len(pick), 3))).astype(np.float32)
    f_q = f_r[pick]
    ji = jb.build_kd_index(jnp.asarray(r), tile_size=128)
    jq = jb.build_kd_index(jnp.asarray(q), tile_size=64)
    order = np.asarray(jq.order)
    qf = np.where(order >= 0, f_q[np.maximum(order, 0)], 0.0).astype(np.float32)
    qf = qf.reshape(jq.tiles.shape[0], jq.tiles.shape[1])
    ft = np.asarray(jb.tile_payload(ji, jnp.asarray(f_r[:, None])))[..., 0]
    pl = rng.normal(size=(n, 4)).astype(np.float32)
    pl_tiles = np.asarray(jb.tile_payload(ji, jnp.asarray(pl)))
    return jq, ji, qf, ft, pl_tiles


def _score_tol(query_tiles, query_feat=None, weight=1.0):
    """1e-6 of the largest |q|^2 + w^2 f_q^2 over real queries."""
    q = np.asarray(query_tiles, np.float64).reshape(-1, 3)
    scale = (q ** 2).sum(1)
    if query_feat is not None:
        scale = scale + weight ** 2 * np.asarray(query_feat, np.float64).reshape(-1) ** 2
    return 1e-6 * float(scale[np.abs(q).max(1) < 1e6].max())


def _check_d2(d_t, d_j, tol):
    d_t, d_j = to_np(d_t), np.asarray(d_j)
    np.testing.assert_array_equal(np.isfinite(d_t), np.isfinite(d_j))
    fin = np.isfinite(d_j)
    np.testing.assert_allclose(d_t[fin], d_j[fin], rtol=0, atol=tol)


@pytest.mark.parametrize("max_chunk", [32768, 5])
@pytest.mark.parametrize("weight", [1.0, 0.5])
def test_feature_block_nn_matches_jax(max_chunk, weight):
    """Unchunked, and in chunks of 5 query tiles (the port slices each
    chunk's query features; the reference pads its last chunk)."""
    jq, ji, qf, ft, _ = _feature_case()
    ti = interop.tile_index_from_numpy(ji, device="cpu")
    qt = torch.as_tensor(np.asarray(jq.tiles))
    kw = dict(k_tiles=4, max_chunk=max_chunk, return_pos=True, feat_weight=weight)
    d_t, p_t = tb.block_nn(qt, ti, query_feat=torch.as_tensor(qf), feat_tiles=torch.as_tensor(ft),
                           **kw)
    d_j, p_j = jb.block_nn(jq.tiles, ji, query_feat=jnp.asarray(qf), feat_tiles=jnp.asarray(ft), **kw)
    tol = _score_tol(jq.tiles, qf, weight)
    _check_d2(d_t, d_j, tol)
    differ = to_np(p_t) != np.asarray(p_j)
    assert differ.mean() < 1e-2
    # where the winners differ, both are the same augmented distance (a near-tie)
    np.testing.assert_allclose(to_np(d_t)[differ], np.asarray(d_j)[differ], rtol=0, atol=tol)
    # the feature moves matches: the 3D metric picks other rows for some queries
    d3, p3 = tb.block_nn(qt, ti, k_tiles=4, return_pos=True)
    assert (to_np(p3) != to_np(p_t)).mean() > 0.01


@pytest.mark.parametrize("max_chunk", [32768, 5])
def test_feature_block_nn_payload_matches_jax(max_chunk):
    jq, ji, qf, ft, pl_tiles = _feature_case(seed=22)
    ti = interop.tile_index_from_numpy(ji, device="cpu")
    kw = dict(k_tiles=4, max_chunk=max_chunk, feat_weight=1.0)
    d_t, pl_t = tb.block_nn_payload(torch.as_tensor(np.asarray(jq.tiles)), ti,
                                    torch.as_tensor(pl_tiles), query_feat=torch.as_tensor(qf),
                                    feat_tiles=torch.as_tensor(ft), **kw)
    d_j, pl_j = jb.block_nn_payload(jq.tiles, ji, jnp.asarray(pl_tiles), query_feat=jnp.asarray(qf),
                                    feat_tiles=jnp.asarray(ft), **kw)
    tol = _score_tol(jq.tiles, qf)
    _check_d2(d_t, d_j, tol)
    differ = (to_np(pl_t) != np.asarray(pl_j)).any(1)
    assert differ.mean() < 1e-2
    np.testing.assert_allclose(to_np(d_t)[differ], np.asarray(d_j)[differ], rtol=0, atol=tol)


@pytest.mark.parametrize("k", [1, 8])
def test_block_knn_matches_jax(k):
    jq, ji, _, _, _ = _feature_case(seed=23)
    ti = interop.tile_index_from_numpy(ji, device="cpu")
    d_t, i_t = tb.block_knn(torch.as_tensor(np.asarray(jq.tiles)), ti, k, k_tiles=4)
    d_j, i_j = jb.block_knn(jq.tiles, ji, k, k_tiles=4)
    d_t, i_t, d_j, i_j = to_np(d_t), to_np(i_t), np.asarray(d_j), np.asarray(i_j)
    assert d_t.shape == d_j.shape == (jq.tiles.shape[0] * jq.tiles.shape[1], k)
    np.testing.assert_array_equal(np.isfinite(d_t), np.isfinite(d_j))
    fin = np.isfinite(d_j)
    tol = _score_tol(jq.tiles)
    np.testing.assert_allclose(d_t[fin], d_j[fin], rtol=0, atol=tol)
    assert (np.diff(d_t, axis=1)[fin[:, 1:]] >= 0).all()  # ascending
    same = np.array([set(a) == set(b) for a, b in zip(i_t, i_j)])
    assert same.mean() > 0.99
    # rows whose sets differ hold a near-tie at the k-th place: the port's
    # k-th and the reference's (k+1)-th candidate are as near as rounding
    kth = d_j[~same, -1]
    np.testing.assert_allclose(d_t[~same, -1], kth, rtol=0, atol=tol)
    # miss rows (pad queries) are (inf, 0) in both
    assert ((i_t == 0) | np.isfinite(d_t)).all()


def _plane():
    """tests/test_registration.py::test_feature_matching_pins_degenerate_plane."""
    n = 8192
    rng = np.random.default_rng(11)
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    xyz = np.concatenate([xy, np.zeros((n, 1), np.float32)], 1)
    inten = 3.0 * xy[:, 0]  # a gradient along x only
    shift = np.asarray([0.15, 0.0, 0.0], np.float32)
    src = JCloud.create(xyz, feats=inten, feat_names=("intensity",))
    tgt = JCloud.create(xyz + shift, feats=inten, feat_names=("intensity",))
    base = dict(objective="p2p", max_iters=25, diff_threshold=0.0, rmse_change_tol=1e-7,
                nn_method="block")
    return src, tgt, shift, base


def test_register_feat_nn_matches_jax():
    src, tgt, shift, base = _plane()
    jcfg = JConfig(feat_nn="intensity", feat_nn_weight=1.0, **base)
    jres = j_register(src, tgt, jcfg)
    res = register(torch_cloud(src), torch_cloud(tgt), torch_config(jcfg))
    np.testing.assert_allclose(to_np(res.transform.R), np.asarray(jres.transform.R), atol=1e-4)
    np.testing.assert_allclose(to_np(res.transform.t), np.asarray(jres.transform.t), atol=1e-4)
    assert res.iters == int(jres.iters)
    # the JAX test's gate: the in-plane shift is recovered
    err = np.linalg.norm(to_np(res.transform.t) - shift)
    assert err < 0.02, err


def test_feat_nn_needs_the_block_path():
    src, tgt, _, base = _plane()
    cfg = ICPConfig(**dict(base, nn_method="brute"), feat_nn="intensity", feat_nn_weight=1.0)
    with pytest.raises(ValueError, match="block NN"):
        register(torch_cloud(src), torch_cloud(tgt), cfg)
    with pytest.raises(KeyError, match="no feature"):
        register(torch_cloud(src), torch_cloud(tgt),
                 ICPConfig(**base, feat_nn="rgb", feat_nn_weight=1.0))

"""Port parity: block NN of `icpx_torch` against `icpx`.

Inputs are made with numpy from a seed; where a build's ties could differ,
both packages get the same index through `interop.tile_index_from_numpy`.
The Pallas kernels run in interpret mode, as `tests/test_blocknn.py` runs
them. Tolerances:

* builds: tiles and order bitwise equal (the same stable sorts of the
  same keys); boxes exact; centroids 1e-6 (sum order);
* candidate tiles: equal, order included (same index, same fp32 scores);
* distances: rtol 1e-5 plus atol 1e-6 * max |q|^2, since the JAX package
  scores by the expansion |q|^2 + |r|^2 - 2 q.r, whose fp32 cancellation
  error scales with |q|^2 (the port's fold kernel scores (q - r)^2);
* positions and payloads: equal on rows whose best and second-best
  candidate distances differ by more than 1e-4 relative (elsewhere each
  side's rounding may pick either);
* moments: counts equal on >= 99.9% of valid rows (a radius-border flip
  between the two scoring forms is allowed), means 1e-5 and covariance
  components 1e-4 on rows whose counts agree.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icpx.kernels.blocknn as jb
from icpx.io.loaders import synthetic_surface
from icpx.kernels.blocknn_pallas import (
    block_fold7_pre as j_fold7,
    block_fold_fused,
    block_nn_fused4 as j_fused4,
    block_radius_moments_fused as j_moments_fused,
    block_radius_moments_fused6 as j_moments6,
    fold7_prepare as j_fold7_prepare,
    group_unions as j_group_unions,
    payload_select_fused as j_select,
)
from icpx.kernels.normals import estimate_normals as j_estimate_normals
from icpx.kernels.voxel import auto_cell_size as j_auto_cell_size
import icpx_torch.kernels.blocknn as tb
from icpx_torch import interop
from icpx_torch.cloud import PAD_COORD
from icpx_torch.kernels import blocknn_cuda
from icpx_torch.kernels.blocknn_cuda import (
    block_fold_fused_pre,
    block_radius_moments_fused6,
    fold6_prepare,
    fold6_reference,
    moments6,
    moments6_reference,
)
from icpx_torch.kernels.knn import nearest_neighbor_reference
from icpx_torch.kernels.normals import estimate_normals
from icpx_torch.kernels.voxel import auto_cell_size
from icpx_torch.utils import profiling
import chip_smoke
from torch_fixtures import (F4_SHAPE, F6_FIXTURE_SHAPES, F6_FIXTURES, F6_SHAPE, F7_FIXTURE_SHAPES,
                            F7_FIXTURES, F7_SHAPE, M6_FIXTURE_SHAPES, M6_FIXTURES, M6_SHAPE,
                            MF_SHAPE, RADIUS_U, _cov_tol, _fused4_tie_case, _slot_weights_fixture,
                            _table_view, _tie_fixture)
from torch_parity import clouds, to_np

GAP = 1e-4


def _cloud(n, seed, masked_frac=0.0, surface=False):
    rng = np.random.default_rng(seed)
    x = synthetic_surface(n, seed=seed) if surface else rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return x, rng.uniform(size=n) >= masked_frac


def _same_index(jidx):
    return interop.tile_index_from_numpy(jidx, device="cpu")


def _dist_tol(q):
    q = np.asarray(q, np.float64).reshape(-1, 3)
    real = np.abs(q).max(1) < 1e6
    return 1e-6 * float((q[real] ** 2).sum(1).max())


def _separated(query_tiles, tiles, cand):
    """Rows whose best and second-best distances over their candidate rows
    (float64) differ by more than GAP relative."""
    q = np.asarray(query_tiles, np.float64)
    r = np.asarray(tiles, np.float64)[np.asarray(cand)]  # (Tq, k, S, 3)
    r = r.reshape(r.shape[0], -1, 3)
    d = ((q[:, :, None, :] - r[:, None, :, :]) ** 2).sum(-1)
    d.sort(axis=2)
    return ((d[..., 1] - d[..., 0]) > GAP * d[..., 1]).reshape(-1)


@pytest.mark.parametrize("n,s,masked_frac", [
    (5000, 64, 0.0),
    (20000, 128, 0.3),  # masked rows sink to the tile padding
    (70000, 64, 0.0),  # > _KD_SEG padded rows: the Morton pre-sort runs
])
def test_kd_index_matches_jax(n, s, masked_frac):
    x, m = _cloud(n, seed=n, masked_frac=masked_frac)
    ji = jb.build_kd_index(jnp.asarray(x), jnp.asarray(m), tile_size=s)
    ti = tb.build_kd_index(torch.as_tensor(x), torch.as_tensor(m), tile_size=s)
    np.testing.assert_array_equal(to_np(ti.tiles), np.asarray(ji.tiles))
    np.testing.assert_array_equal(to_np(ti.order), np.asarray(ji.order))
    np.testing.assert_array_equal(to_np(ti.box_lo), np.asarray(ji.box_lo))
    np.testing.assert_array_equal(to_np(ti.box_hi), np.asarray(ji.box_hi))
    np.testing.assert_allclose(to_np(ti.centroids), np.asarray(ji.centroids), atol=1e-6)


def test_morton_index_matches_jax():
    x, m = _cloud(3000, seed=1, masked_frac=0.2)
    ji = jb.build_tile_index(jnp.asarray(x), jnp.asarray(m), tile_size=128)
    ti = tb.build_tile_index(torch.as_tensor(x), torch.as_tensor(m), tile_size=128)
    np.testing.assert_array_equal(to_np(ti.tiles), np.asarray(ji.tiles))
    np.testing.assert_array_equal(to_np(ti.order), np.asarray(ji.order))
    np.testing.assert_allclose(to_np(ti.centroids), np.asarray(ji.centroids), atol=1e-6)
    keys = tb.morton_keys(torch.as_tensor(x), torch.zeros(3) - 1, torch.ones(3) * 0.5)
    np.testing.assert_array_equal(
        to_np(keys), np.asarray(jb.morton_keys(jnp.asarray(x), -jnp.ones(3), 0.5 * jnp.ones(3))))


def test_trim_and_coarsen_match_jax():
    x, m = _cloud(9000, seed=2, masked_frac=0.1)
    ji = jb.build_kd_index(jnp.asarray(x), jnp.asarray(m), tile_size=64)
    ti = tb.build_kd_index(torch.as_tensor(x), torch.as_tensor(m), tile_size=64)
    for jt, tt in (
        (jb.trim_index(ji, 9000, multiple=4), tb.trim_index(ti, 9000, multiple=4)),
        (jb.coarsen_index(jb.trim_index(ji, 9000, 4), 2), tb.coarsen_index(tb.trim_index(ti, 9000, 4), 2)),
    ):
        assert tt.tiles.shape == jt.tiles.shape
        np.testing.assert_array_equal(to_np(tt.order), np.asarray(jt.order))
        np.testing.assert_array_equal(to_np(tt.box_lo), np.asarray(jt.box_lo))
        np.testing.assert_allclose(to_np(tt.centroids), np.asarray(jt.centroids), atol=1e-6)
    with pytest.raises(ValueError):
        tb.coarsen_index(ti, 3)


def test_tile_index_interop_roundtrip():
    x, m = _cloud(3000, seed=4)
    ji = jb.build_kd_index(jnp.asarray(x), jnp.asarray(m), tile_size=64)
    back = interop.tile_index_to_numpy(_same_index(ji))
    for f, a in back.items():
        np.testing.assert_array_equal(a, np.asarray(getattr(ji, f)))
    assert back["order"].dtype == np.int32


def _query_and_index(n=36864, seed=5):
    rng = np.random.default_rng(seed)
    r = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    q = (r + rng.normal(0, 0.002, r.shape)).astype(np.float32)
    ji = jb.build_kd_index(jnp.asarray(r), tile_size=128)  # 512 tiles
    jq = jb.build_kd_index(jnp.asarray(q), tile_size=64)
    return r, jq, ji


@pytest.mark.parametrize("hier", [False, True])
def test_candidate_tiles_match_jax(hier, monkeypatch):
    """Flat ranking, and the two-level ranking forced at CPU size by
    lowering _HIER_MIN_TILES / _SUPER_G on both packages (32 super-tiles of
    16, the top 4 expanded), as tests/test_blocknn.py forces it."""
    _, jq, ji = _query_and_index()
    if hier:
        for mod in (jb, tb):
            monkeypatch.setattr(mod, "_HIER_MIN_TILES", 64)
            monkeypatch.setattr(mod, "_SUPER_G", 16)
    k = 7
    cj, qcj = jb._candidate_tiles(jq.tiles, ji, k)
    ct, qct = tb._candidate_tiles(torch.as_tensor(np.asarray(jq.tiles)), _same_index(ji), k)
    np.testing.assert_array_equal(to_np(ct), np.asarray(cj))
    np.testing.assert_allclose(to_np(qct), np.asarray(qcj), atol=1e-6)


@pytest.mark.parametrize("variant", ["index", "return_pos", "frozen", "chunked", "bf16"])
def test_block_nn_matches_jax(variant):
    _, jq, ji = _query_and_index(n=12288, seed=6)
    ti = _same_index(ji)
    qt_np = np.asarray(jq.tiles)
    qt = torch.as_tensor(qt_np)
    cand_j, _ = jb._candidate_tiles(jq.tiles, ji, 6)
    kw_j = dict(k_tiles=6, return_pos=variant != "index")
    kw_t = dict(kw_j)
    if variant in ("frozen", "chunked"):
        kw_j["cand_tiles"] = cand_j
        kw_t["cand_tiles"] = torch.as_tensor(np.asarray(cand_j))
    if variant == "chunked":
        kw_t["max_chunk"] = 20  # 192 query tiles: chunks of 16 (an exact divisor)
    if variant == "bf16":
        kw_j["score_prec"] = kw_t["score_prec"] = "bf16"
    d_j, p_j = jb.block_nn(jq.tiles, ji, **kw_j)
    d_t, p_t = tb.block_nn(qt, ti, **kw_t)
    d_j, d_t = np.asarray(d_j), to_np(d_t)
    fin = np.isfinite(d_j)
    np.testing.assert_array_equal(np.isfinite(d_t), fin)
    atol = _dist_tol(qt_np) * (1e4 if variant == "bf16" else 1)  # bf16: 8 mantissa bits
    np.testing.assert_allclose(d_t[fin], d_j[fin], rtol=1e-5, atol=atol)
    valid = np.asarray(jq.order) >= 0
    sep = _separated(qt_np, np.asarray(ji.tiles), np.asarray(cand_j)) & valid
    assert sep[valid].mean() > 0.9
    if variant != "bf16":
        np.testing.assert_array_equal(to_np(p_t)[sep], np.asarray(p_j)[sep])
    assert p_t.dtype == torch.int32


def test_matmul_precision_modes():
    """The fold's product at each score precision, held to float64: "highest"
    is fp32; "bf16" multiplies bf16-rounded inputs exactly and sums in fp32;
    "high" (the three-pass split) drops only lo*lo, ~2^-16 of |a||b|. (JAX
    on the CPU computes every precision in fp32, so these are not compared
    with it.)"""
    rng = np.random.default_rng(15)
    a = torch.as_tensor(rng.uniform(-1, 1, (3, 40, 4)).astype(np.float32))
    b = torch.as_tensor(rng.uniform(-1, 1, (3, 4, 50)).astype(np.float32))
    exact = (a.double() @ b.double())
    scale = (a.double().abs() @ b.double().abs())
    assert torch.equal(tb._matmul(a, b, "highest"), torch.bmm(a, b))
    a16, b16 = a.bfloat16().double(), b.bfloat16().double()
    torch.testing.assert_close(tb._matmul(a, b, "bf16").double(), a16 @ b16, rtol=0, atol=1e-6)
    err_high = ((tb._matmul(a, b, "high").double() - exact).abs() / scale).max()
    err_bf16 = ((tb._matmul(a, b, "bf16").double() - exact).abs() / scale).max()
    assert err_high < 2.0**-15 < err_bf16
    with pytest.raises(ValueError):
        tb._matmul(a, b, "fp8")


def test_block_nn_recall_default_operating_point():
    """The bound of tests/test_blocknn.py::test_default_operating_point_recall
    on its own input construction (seed 0; 20,000 points here, exact NN
    checked on 5,000 sampled queries): at the registration defaults (S=128,
    Sq=64, refine k=6, near-aligned clouds) < 0.2% of queries miss their
    exact NN. (The miss rate depends on the draw: other seeds give ~1% on
    both packages alike.)"""
    rng = np.random.default_rng(0)
    r = rng.uniform(-1, 1, (20000, 3)).astype(np.float32)
    q = (r + rng.normal(0, 0.002, r.shape)).astype(np.float32)
    ri = tb.build_kd_index(torch.as_tensor(r), tile_size=128)
    qi = tb.build_kd_index(torch.as_tensor(q), tile_size=64)
    d_v, _ = tb.block_nn(qi.tiles, ri, k_tiles=6)
    rows = np.random.default_rng(1).choice(np.nonzero(to_np(qi.order) >= 0)[0], 5000, replace=False)
    rows = torch.as_tensor(rows)
    d_b, _ = nearest_neighbor_reference(qi.tiles.reshape(-1, 3)[rows], torch.as_tensor(r))
    miss = (to_np(d_v[rows]) > to_np(d_b) + 1e-6).mean()
    assert miss < 0.002, f"refine-regime miss rate {miss}"


def test_block_nn_feature_metric_raises():
    """The feature metric needs both its operands: a query feature without
    the reference's feature tiles, or the reverse, raises."""
    _, jq, ji = _query_and_index(n=4096, seed=8)
    qt = torch.as_tensor(np.asarray(jq.tiles))
    with pytest.raises(ValueError, match="both query_feat and feat_tiles"):
        tb.block_nn(qt, _same_index(ji), query_feat=torch.zeros(qt.shape[:2]))
    with pytest.raises(ValueError, match="both query_feat and feat_tiles"):
        tb.block_nn(qt, _same_index(ji), feat_tiles=torch.zeros(ji.tiles.shape[:2]))


def test_payload_tables_match_jax():
    x, m = _cloud(3000, seed=9, masked_frac=0.2)
    aux = np.random.default_rng(9).normal(size=(3000, 3)).astype(np.float32)
    ji = jb.build_kd_index(jnp.asarray(x), jnp.asarray(m), tile_size=64)
    ti = _same_index(ji)
    np.testing.assert_array_equal(to_np(tb.tile_payload(ti, torch.as_tensor(aux))),
                                  np.asarray(jb.tile_payload(ji, jnp.asarray(aux))))
    np.testing.assert_array_equal(to_np(tb.fused_payload_table(ti, torch.as_tensor(aux))),
                                  np.asarray(jb.fused_payload_table(ji, jnp.asarray(aux))))


# ---- radius moments (kernel #2) -------------------------------------------------


def _moments_case():
    """A 1M-style self query at CPU size: a surface cloud's KD index, each
    tile its own query tile, k_tiles = 2, the registration's radius."""
    x, m = _cloud(12000, seed=10, surface=True)
    ji = jb.build_kd_index(jnp.asarray(x), jnp.asarray(m), tile_size=128)
    flat = np.asarray(ji.tiles).reshape(-1, 3)
    valid = np.asarray(ji.order) >= 0
    radius = float(j_auto_cell_size(jnp.asarray(flat), jnp.asarray(valid), scale=3.0))
    return ji, valid, radius


def _check_moments(cnt_t, mean_t, comps_t, cnt_j, mean_j, comps_j, valid, ji, centred=None):
    """`centred`: (centres, rows a centre) the moments were centred on; by
    default each query tile's centroid."""
    cnt_t, cnt_j = to_np(cnt_t)[valid], np.asarray(cnt_j)[valid]
    same = cnt_t == cnt_j
    assert same.mean() >= 0.999, f"counts agree on {same.mean():.5f} of rows"
    assert cnt_j.mean() > 5  # the radius holds real neighbourhoods
    np.testing.assert_allclose(to_np(mean_t)[valid][same], np.asarray(mean_j)[valid][same], atol=1e-5)
    if centred is None:
        centred = (jb._candidate_tiles(ji.tiles, ji, 2)[1], ji.tile_size)
    tol = _cov_tol(mean_j, comps_j, *centred)[valid][same]
    for ct, cj in zip(comps_t, comps_j):
        ct, cj = to_np(ct)[valid][same], np.asarray(cj)[valid][same]
        np.testing.assert_allclose(ct, cj, atol=1e-4)
        assert (np.abs(ct.astype(np.float64) - cj) <= tol).all(), float(np.max(np.abs(ct - cj) - tol))


def test_moments6_plain_matches_pallas_interpret():
    ji, valid, radius = _moments_case()
    cnt_j, mean_j, comps_j = j_moments6(ji.tiles, ji, jnp.float32(radius), k_tiles=2,
                                        interpret=True, soa=True)
    ti = _same_index(ji)
    before = dict(profiling.LAUNCHES)
    cnt_t, mean_t, comps_t = block_radius_moments_fused6(ti.tiles, ti, radius, k_tiles=2)
    assert profiling.LAUNCHES == before  # CPU tensors: the plain version ran
    _check_moments(cnt_t, mean_t, comps_t, cnt_j, mean_j, comps_j, valid, ji)


def test_xla_moments_match_pallas_interpret():
    """The port's `block_radius_moments` (moments_mode="xla") against the
    same Pallas oracle."""
    ji, valid, radius = _moments_case()
    cnt_j, mean_j, comps_j = j_moments6(ji.tiles, ji, jnp.float32(radius), k_tiles=2,
                                        interpret=True, soa=True)
    ti = _same_index(ji)
    cnt_t, mean_t, cov_t = tb.block_radius_moments(ti.tiles, ti, radius, k_tiles=2)
    comps_t = [cov_t[:, i, j] for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]
    _check_moments(cnt_t, mean_t, comps_t, cnt_j, mean_j, comps_j, valid, ji)


def test_moments6_sentinels_never_count():
    """A query tile whose candidates are one real tile and one all-sentinel
    tile: the sentinel rows add nothing, padded query rows get count 0."""
    rng = np.random.default_rng(11)
    real = rng.uniform(-0.1, 0.1, (8, 3)).astype(np.float32)
    tiles = np.stack([real, np.full((8, 3), PAD_COORD, np.float32)])
    query = np.concatenate([real[:5], np.full((3, 3), PAD_COORD, np.float32)])[None]
    cand = torch.tensor([[0, 1]])
    q_cent = torch.as_tensor(real[:5].mean(0, keepdims=True))
    r2 = torch.tensor(1.0)  # every real row is inside
    out = moments6_reference(torch.as_tensor(query), torch.as_tensor(tiles), cand, q_cent, r2)
    np.testing.assert_array_equal(to_np(out[0]), [8, 8, 8, 8, 8, 0, 0, 0])
    np.testing.assert_allclose(to_np(out[1:4]).T[:5], np.repeat(real.mean(0, keepdims=True), 5, 0),
                               atol=1e-6)
    cov = np.cov(real.T.astype(np.float64), bias=True)
    want = [cov[0, 0], cov[0, 1], cov[0, 2], cov[1, 1], cov[1, 2], cov[2, 2]]
    np.testing.assert_allclose(to_np(out[4:, 0]), want, atol=1e-6)
    assert np.isfinite(to_np(out)).all()
    # the dispatching wrapper runs the same plain version on CPU tensors
    np.testing.assert_array_equal(
        to_np(moments6(torch.as_tensor(query), torch.as_tensor(tiles), cand, q_cent, r2)), to_np(out))


# ---- frozen-candidate fold (kernel #3) ---------------------------------------------


def _fold_case(seed=12):
    """Refine-regime queries (near-aligned) against a target KD index, with
    frozen candidates and a fused [xyz || normal-like] payload table."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    q = (r[rng.permutation(4096)[:3000]] + rng.normal(0, 0.003, (3000, 3))).astype(np.float32)
    ji = jb.build_kd_index(jnp.asarray(r), tile_size=128)
    jq = jb.trim_index(jb.build_kd_index(jnp.asarray(q), tile_size=64), 3000, multiple=4)
    aux = rng.normal(size=(4096, 3)).astype(np.float32)
    table = np.asarray(jb.fused_payload_table(ji, jnp.asarray(aux)))
    cand, _ = jb._candidate_tiles(jq.tiles, ji, 6)
    return jq, ji, table, np.asarray(cand)


def _same_bits(got, want):
    """(d2, payload) pairs equal bit for bit, NaN and inf included."""
    for a, b in zip(got, want):
        a, b = to_np(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def test_fold6_plain_matches_pallas_interpret():
    jq, ji, table, cand = _fold_case()
    pl_tiles = jnp.asarray(table.reshape(ji.n_tiles, ji.tile_size, 6))
    d_j, pl_j = block_fold_fused(jq.tiles, jnp.asarray(cand), ji, pl_tiles, interpret=True)
    ti = _same_index(ji)
    ops = fold6_prepare(torch.as_tensor(cand), ti, torch.as_tensor(table))
    before = dict(profiling.LAUNCHES)
    d_t, pl_t = block_fold_fused_pre(torch.as_tensor(np.asarray(jq.tiles)), ops)
    assert profiling.LAUNCHES == before  # CPU tensors: the plain version ran
    d_j, d_t, pl_j, pl_t = np.asarray(d_j), to_np(d_t), np.asarray(pl_j), to_np(pl_t)
    fin = np.isfinite(d_j)
    np.testing.assert_array_equal(np.isfinite(d_t), fin)  # misses (pad query rows) together
    assert (~fin).sum() == np.sum(np.asarray(jq.order) < 0)
    np.testing.assert_allclose(d_t[fin], d_j[fin], rtol=1e-5, atol=_dist_tol(jq.tiles))
    sep = _separated(jq.tiles, ji.tiles, cand) & fin
    assert sep[fin].mean() > 0.9
    np.testing.assert_array_equal(pl_t[sep], pl_j[sep])
    assert np.isfinite(pl_t).all()
    # the port's one-shot wrapper is prepare + fold: the same bits
    _same_bits(blocknn_cuda.block_fold_fused(torch.as_tensor(np.asarray(jq.tiles)),
                                             torch.as_tensor(cand), ti,
                                             torch.as_tensor(np.asarray(pl_tiles))), (d_t, pl_t))


@pytest.mark.parametrize("cand", [[0, 1, 2, 3], [3, 2, 1, 0]])
def test_fold6_tie_rule_lane_then_candidate(cand):
    """Least d2, then the lowest lane, then the earliest candidate, as the
    TPU kernel decides (blocknn_pallas.py:513-526); the plain block_nn fold
    instead keeps the earliest candidate first."""
    query, payload, fields = _tie_fixture()
    index = interop.tile_index_from_numpy(fields, device="cpu")
    ops = fold6_prepare(torch.tensor([cand]), index, torch.as_tensor(payload))
    d_t, pl_t = fold6_reference(torch.as_tensor(query), ops)
    want0 = 1 * 8 + 1  # lane 1 of tile 1 beats lane 3 of tile 0 in any candidate order
    want1 = 8 * cand[min(cand.index(2), cand.index(3))] + 2  # same lane: earliest candidate
    assert pl_t[0, 0] == want0 and pl_t[1, 0] == want1 and d_t[0] == 0 and d_t[1] == 0
    j_index = jb.TileIndex(**{f: jnp.asarray(v) for f, v in vars(fields).items()})
    d_j, pl_j = block_fold_fused(jnp.asarray(query), jnp.asarray([cand], jnp.int32), j_index,
                                 jnp.asarray(payload.reshape(4, 8, 6)), interpret=True)
    np.testing.assert_array_equal(to_np(pl_t), np.asarray(pl_j))
    np.testing.assert_array_equal(to_np(d_t), np.asarray(d_j))
    _same_bits(blocknn_cuda.block_fold_fused(torch.as_tensor(query), torch.tensor([cand]), index,
                                             torch.as_tensor(payload.reshape(4, 8, 6))),
               (d_j, pl_j))
    _, pos = tb.block_nn(torch.as_tensor(query), index, return_pos=True,
                         cand_tiles=torch.tensor([cand]))
    assert int(pos[0]) == (3 if cand.index(0) < cand.index(1) else want0)


def test_fold6_all_sentinel_candidates_miss():
    """A query tile whose candidates are all sentinel tiles: d2 = +inf and
    the payload of the sentinel row it lands on (finite PAD_COORD
    coordinates, zero normals), as the Pallas kernel returns."""
    x, _ = _cloud(900, seed=13)
    ji = jb.build_kd_index(jnp.asarray(x), tile_size=64)  # 16 tiles, the last all padding
    ti = _same_index(ji)
    table = np.asarray(jb.fused_payload_table(ji, jnp.ones((900, 3), jnp.float32)))
    pad_tile = int(np.nonzero((np.asarray(ji.order).reshape(ji.n_tiles, -1) < 0).all(1))[0][0])
    query = np.asarray(ji.tiles[:2])
    cand = np.array([[0, 1], [pad_tile, pad_tile]])
    d_t, pl_t = fold6_reference(torch.as_tensor(query), fold6_prepare(
        torch.as_tensor(cand), ti, torch.as_tensor(table)))
    d_j, pl_j = block_fold_fused(jnp.asarray(query), jnp.asarray(cand, jnp.int32), ji,
                                 jnp.asarray(table.reshape(ji.n_tiles, ji.tile_size, 6)),
                                 interpret=True)
    miss = slice(64, 128)
    assert np.isinf(to_np(d_t)[miss]).all() and np.isinf(np.asarray(d_j)[miss]).all()
    np.testing.assert_array_equal(to_np(pl_t)[miss], np.asarray(pl_j)[miss])
    np.testing.assert_array_equal(to_np(pl_t)[miss][0], [PAD_COORD] * 3 + [0.0] * 3)
    assert np.isfinite(to_np(d_t)[:64]).all()
    _same_bits(blocknn_cuda.block_fold_fused(
        torch.as_tensor(query), torch.as_tensor(cand), ti,
        torch.as_tensor(table.reshape(ji.n_tiles, ji.tile_size, 6))), (d_t, pl_t))


# ---- the fold6 kernel's screen: emulation, margin, plan ------------------------------

# The fold6 kernel's shape (F6_SHAPE, torch_fixtures.py) with short stages,
# so that a candidate tile's lanes span several stages and a block holds
# fewer tiles.
F6_SHORT = F6_SHAPE._replace(stage_rows=48)
F6_DIRECT_D2 = np.float32(1e11)
F6_FAR_ABS = np.float32(5e5)


def _fma32(x, y, z):
    """fma(x, y, z) in float32: the product exact in float64, the sum
    rounded to float64 and then to float32 (a double rounding may move it by
    an ulp; the margin covers that, as it covers any score within E)."""
    return (x.astype(np.float64) * y + z).astype(np.float32)


def _f6_score(a, rows):
    """(Q, 3) a = -2 qc, (R, 4) packed rows -> (Q, R) fma(ax, rx, fma(ay,
    ry, fma(az, rz, rr)))."""
    inner = _fma32(a[:, None, 2], rows[None, :, 2], rows[None, :, 3])
    return _fma32(a[:, None, 0], rows[None, :, 0], _fma32(a[:, None, 1], rows[None, :, 1], inner))


def _f6_direct(q, r):
    """(Q, 3) x (R, 3) -> (Q, R) the plain version's direct form in float32."""
    d = q[:, None, :] - r[None, :, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def _f6_keys(d, j):
    """u64 keys bits(d2) << 32 | j."""
    return (d.astype(np.float32).view(np.uint32).astype(np.uint64) << np.uint64(32)) | j.astype(np.uint64)


def fold6_centres(cand, box_lo, box_hi):
    """(Tq, 4) f32 (cx, cy, cz, R) a query tile, as the fold6 kernel makes
    them at a block's start (`f6_centre` in csrc/blocknn.cu), in the same
    float32 arithmetic: c the centre of the box of its first candidate tile
    that holds a row (lo <= hi; the origin if none does), R the distance
    from c to the farthest corner of those boxes, times 1 + 2^-10."""
    cand = cand.to(torch.int64)
    lo, hi = box_lo[cand].to(torch.float32), box_hi[cand].to(torch.float32)  # (Tq, k, 3)
    has = (lo <= hi).all(2)
    first = has.to(torch.uint8).argmax(1)[:, None, None].expand(-1, 1, 3)
    mid = 0.5 * (torch.gather(lo, 1, first)[:, 0] + torch.gather(hi, 1, first)[:, 0])
    c = torch.where(has.any(1, keepdim=True), mid, 0.0)
    d = torch.maximum((hi - c[:, None]).abs(), (lo - c[:, None]).abs())
    r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    r = torch.sqrt(torch.where(has, r2, 0.0).amax(1)) * 1.0009765625
    return torch.cat([c, r[:, None]], dim=1)


def emulate_fold6(query_tiles, tiles, cand, cent, shape):
    """csrc/blocknn.cu's fold6 in numpy, step for step, a query tile at a
    time (its queries' results depend on nothing else): stages in order
    (candidate slot, run of `fold6_plan`'s lanes), each packed centred on the
    tile's centre (`fold6_centres`) with rr, sentinel rows and group padding (0, 0, 0, +inf),
    valid rows checked against R; groups screened by the FMA chain and
    folded by min, the two least group minima and groups and the third
    least minimum tracked per query in scan order; then thr = m1 + delta_q,
    the exact keys of g1 (and g2 where m2 <= thr) in the raw direct form, or
    the direct scan (far query, no valid row, a third group within thr, a
    row beyond R, best d2 >= 1e11). Returns (d2, flat payload row, counts of
    queries by path)."""
    tq, sq, _ = query_tiles.shape
    s = tiles.shape[1]
    k = cand.shape[1]
    plan = blocknn_cuda.fold6_plan(tq, sq, s, k, shape)
    lc, lcp, group = plan["lanes_per_stage"], plan["padded_lanes"], shape.group
    chunks = -(-s // lc)
    ng = lcp // group
    d_out = np.empty(tq * sq, np.float32)
    pos_out = np.empty(tq * sq, np.int64)
    counts = {"one group": 0, "two groups": 0, "direct": 0}
    inf = np.float32(np.inf)
    j_all = np.arange(s * k)
    for t in range(tq):
        c, big_r = cent[t, :3], cent[t, 3]
        q = query_tiles[t]
        a = np.float32(-2.0) * (q - c)
        m1 = np.full(sq, inf)
        m2, m3 = m1.copy(), m1.copy()
        g1 = np.zeros(sq, np.int64)
        g2 = g1.copy()
        beyond = False
        for st in range(k * chunks):
            ci, l0 = st // chunks, (st % chunks) * lc
            nl = min(lc, s - l0)
            raw = tiles[cand[t, ci], l0:l0 + nl]
            rows = np.zeros((lcp, 4), np.float32)
            rows[:, 3] = inf
            valid = (np.abs(raw) < 1e6).all(1)
            rc = raw - c
            rr = (rc[:, 0] * rc[:, 0] + rc[:, 1] * rc[:, 1]) + rc[:, 2] * rc[:, 2]
            rows[:nl][valid] = np.concatenate([rc, rr[:, None]], 1)[valid]
            beyond |= bool((~(rr[valid] <= big_r * big_r)).any())
            gmin = _f6_score(a, rows).reshape(sq, ng, group).min(2)
            for g in range(ng):
                m, gid = gmin[:, g], st * ng + g
                low2, low1 = m < m2, m < m1
                m3 = np.where(low2, m2, np.minimum(m3, m))
                m2, g2 = np.where(low1, m1, np.where(low2, m, m2)), np.where(low1, g1, np.where(low2, gid, g2))
                m1, g1 = np.where(low1, m, m1), np.where(low1, gid, g1)
        qc = q - c
        qq = (qc[:, 0] * qc[:, 0] + qc[:, 1] * qc[:, 1]) + qc[:, 2] * qc[:, 2]
        delta = blocknn_cuda.fold6_screen_margin(torch.as_tensor(qq), torch.tensor(big_r)).numpy()
        thr = m1 + delta
        for i in range(sq):
            key = np.uint64(2**64 - 1)
            direct = (not np.abs(q[i]).max() < F6_FAR_ABS or m1[i] == inf or m3[i] <= thr[i]
                      or beyond)
            if not direct:
                for gid in ([g1[i], g2[i]] if m2[i] <= thr[i] else [g1[i]]):
                    st, g = divmod(int(gid), ng)
                    ci, l0 = st // chunks, (st % chunks) * lc + g * group
                    lanes = np.arange(l0, min(l0 + group, s))
                    d = _f6_direct(q[i:i + 1], tiles[cand[t, ci], lanes])[0]
                    key = min(key, _f6_keys(d, lanes * k + ci).min())
                counts["two groups" if m2[i] <= thr[i] else "one group"] += 1
            best = (key >> np.uint64(32)).astype(np.uint32).view(np.float32)
            if direct or not best < F6_DIRECT_D2:
                r = tiles[cand[t, j_all % k], j_all // k]  # row j = lane * k + c
                key = _f6_keys(_f6_direct(q[i:i + 1], r)[0], j_all).min()
                counts["direct"] += 1
            d = (key >> np.uint64(32)).astype(np.uint32).view(np.float32)
            j = int(key & np.uint64(0xFFFFFFFF))
            d_out[t * sq + i] = d if d < 1e15 else inf
            pos_out[t * sq + i] = int(cand[t, j % k]) * s + j // k
    return d_out, pos_out, counts


def _fold6_fixture(name, tq=6, sq=20, s=32, k=4, n_tiles=12):
    """chip_smoke.py's fold6 screen fixture (`fold6_fixture`, described
    there) on the CPU: (query tiles, TileIndex, cand, payload), the arrays
    as numpy."""
    query, index, cand, payload = chip_smoke.fold6_fixture(name, tq, sq, s, k, n_tiles)
    return to_np(query), index, to_np(cand), to_np(payload)


@pytest.mark.parametrize("shape", [F6_SHAPE, F6_SHORT], ids=["kernel", "short stages"])
@pytest.mark.parametrize("name", F6_FIXTURES)
@pytest.mark.parametrize("tq,sq,s,k", list(F6_FIXTURE_SHAPES.values()), ids=list(F6_FIXTURE_SHAPES))
def test_emulated_fold6_equals_reference(name, shape, tq, sq, s, k):
    """The kernel's centring, packing, grouped screen, top-three tracking,
    exact rows and direct scan give fold6_reference's d2 and payload bit
    for bit: on each fixture, at query tiles that do not fill a block (sq 3
    and 20), S not a multiple of the group, a tile over two blocks with S
    over two stages (sq 600, S 2000), whole blocks, and with stages of 48
    rows (a candidate tile's lanes over several stages at S = 100)."""
    query, index, cand, payload = _fold6_fixture(name, tq, sq, s, k, n_tiles=max(12, k + 2))
    ops = fold6_prepare(torch.as_tensor(cand), index, torch.as_tensor(payload))
    cent = fold6_centres(ops.cand, ops.box_lo, ops.box_hi)
    assert cent.dtype == torch.float32 and tuple(cent.shape) == (tq, 4)
    d_e, pos_e, counts = emulate_fold6(query, to_np(index.tiles), cand, to_np(cent), shape)
    d_p, pl_p = fold6_reference(torch.as_tensor(query), ops)
    np.testing.assert_array_equal(d_e.view(np.int32), to_np(d_p).view(np.int32))
    np.testing.assert_array_equal(payload[pos_e], to_np(pl_p))
    if name in ("pad queries", "all sentinel", "far queries", "rows beyond R"):
        assert counts["direct"] > 0
    if name == "random":
        assert counts["one group"] > counts["direct"]


def test_emulated_fold6_covers_reversed_near_ties():
    """The near-tie fixture holds pairs of candidate rows whose screen order
    is the reverse of their direct order (direct d2 one ulp or so apart),
    and the emulated kernel still returns the plain version's winner."""
    query, index, cand, payload = _fold6_fixture("near ties", 6, 64, 32, 4)
    ops = fold6_prepare(torch.as_tensor(cand), index, torch.as_tensor(payload))
    tiles = to_np(index.tiles)
    cent = to_np(fold6_centres(ops.cand, ops.box_lo, ops.box_hi))
    reversed_pairs = 0
    for t in range(len(query)):
        c = cent[t, :3]
        r = tiles[cand[t]].reshape(-1, 3)
        rc = r - c
        rows = np.concatenate([rc, ((rc[:, 0] * rc[:, 0] + rc[:, 1] * rc[:, 1])
                                    + rc[:, 2] * rc[:, 2])[:, None]], 1)
        sc = _f6_score(np.float32(-2.0) * (query[t] - c), rows)
        d = _f6_direct(query[t], r)
        near = np.argsort(d, axis=1)[:, :3]  # r1 and its two one-ulp copies
        for i, (a, b, cc) in enumerate(near):
            for x, y in ((a, b), (a, cc), (b, cc)):
                reversed_pairs += int((d[i, x] < d[i, y]) and (sc[i, x] > sc[i, y]))
    assert reversed_pairs > 0
    d_e, pos_e, _ = emulate_fold6(query, tiles, cand, cent, F6_SHAPE)
    d_p, pl_p = fold6_reference(torch.as_tensor(query), ops)
    np.testing.assert_array_equal(d_e.view(np.int32), to_np(d_p).view(np.int32))
    np.testing.assert_array_equal(payload[pos_e], to_np(pl_p))


def test_emulated_fold6_rows_beyond_radius_take_the_direct_scan():
    """An index whose boxes miss its rows (a radius that does not hold):
    the kernel's check sends those tiles to the direct scan, and the
    result is still the plain version's."""
    query, index, cand, payload = _fold6_fixture("rows beyond R")
    ops = fold6_prepare(torch.as_tensor(cand), index, torch.as_tensor(payload))
    cent = fold6_centres(ops.cand, ops.box_lo, ops.box_hi)
    d_e, pos_e, counts = emulate_fold6(query, to_np(index.tiles), cand, to_np(cent), F6_SHAPE)
    assert counts["direct"] == query.shape[0] * query.shape[1]
    d_p, pl_p = fold6_reference(torch.as_tensor(query), ops)
    np.testing.assert_array_equal(d_e.view(np.int32), to_np(d_p).view(np.int32))
    np.testing.assert_array_equal(payload[pos_e], to_np(pl_p))


@pytest.mark.parametrize("scale", [1.0, 100.0])
@pytest.mark.parametrize("name", ["uniform", "box corners", "ulp neighbours"])
def test_fold6_margin_bounds_the_centred_expansion(name, scale):
    """For every valid pair, the centred fp32 screen score s (the FMA chain
    on rc = fl(r - c), rr = fl(|rc|^2), a = -2 fl(q - c)) plus the exact
    |q - c|^2 is within delta_q / 2 of the uncentred fp32 direct-form d2,
    with c and R from fold6_prepare, at coordinates of scale 1 and 100 (far
    from the origin: the uncentred expansion would cancel)."""
    rng = np.random.default_rng(int(scale) + len(name))
    off = np.float32(scale)
    tiles = (rng.uniform(-1, 1, (6, 64, 3)) * 0.05 + off).astype(np.float32)
    query = (rng.uniform(-1, 1, (2, 64, 3)) * 0.05 + off).astype(np.float32)
    if name == "box corners":  # queries on the far corners of the candidates' boxes
        lo, hi = tiles.reshape(-1, 3).min(0), tiles.reshape(-1, 3).max(0)
        pick = rng.integers(0, 2, (2, 64, 3)).astype(bool)
        query = np.where(pick, lo, hi).astype(np.float32)
    elif name == "ulp neighbours":
        flat = tiles.reshape(-1, 3)
        flat[:128] = query.reshape(-1, 3)
        flat[128:256] = np.nextafter(flat[:128], np.float32(np.inf))
    order = np.arange(6 * 64, dtype=np.int32)
    index = tb._finish_index(torch.as_tensor(tiles), torch.as_tensor(order))
    cand = np.array([[0, 1, 2, 3, 4, 5], [5, 4, 3, 2, 1, 0]])
    ops = fold6_prepare(torch.as_tensor(cand), index, torch.zeros((6 * 64, 6)))
    cent = to_np(fold6_centres(ops.cand, ops.box_lo, ops.box_hi))
    worst = 0.0
    for t in range(2):
        c, big_r = cent[t, :3], cent[t, 3]
        r = tiles[cand[t]].reshape(-1, 3)
        rc = r - c
        rr = (rc[:, 0] * rc[:, 0] + rc[:, 1] * rc[:, 1]) + rc[:, 2] * rc[:, 2]
        assert (rr <= big_r * big_r).all()  # the kernel's check holds: R is a radius
        qc = query[t] - c
        s = _f6_score(np.float32(-2.0) * qc, np.concatenate([rc, rr[:, None]], 1))
        qq32 = (qc[:, 0] * qc[:, 0] + qc[:, 1] * qc[:, 1]) + qc[:, 2] * qc[:, 2]
        delta = blocknn_cuda.fold6_screen_margin(torch.as_tensor(qq32), torch.tensor(big_r)).numpy()
        qq = ((query[t].astype(np.float64) - c.astype(np.float64)) ** 2).sum(1)  # |q - c|^2 exact
        err = np.abs(s.astype(np.float64) + qq[:, None] - _f6_direct(query[t], r).astype(np.float64))
        worst = max(worst, float((err / (delta[:, None].astype(np.float64) / 2)).max()))
    assert worst <= 1.0, f"an expansion error reaches {worst:.3f} x delta_q / 2"


@pytest.mark.parametrize("tq,sq,s,k,want", [
    (16384, 64, 128, 6, (8, 128, 128, 16, 6, (2048, 1))),  # the 1M refine shape
    (256, 64, 128, 6, (8, 128, 128, 16, 6, (32, 1))),  # the 16k pair's refine shape
    (2, 8, 8, 4, (64, 8, 8, 1, 4, (1, 1))),  # chip_smoke's fixtures
    (4, 300, 128, 6, (1, 128, 128, 16, 6, (4, 1))),  # a tile of 75 threads
    (5, 600, 2000, 1, (1, 1024, 1024, 128, 2, (5, 2))),  # a tile over two blocks, S over two stages
    (7, 3, 13, 2, (64, 13, 16, 2, 2, (1, 1))),  # S not a multiple of the group
])
def test_fold6_plan_of_the_kernel_shape(tq, sq, s, k, want):
    plan = blocknn_cuda.fold6_plan(tq, sq, s, k, F6_SHAPE)
    assert (plan["tiles_per_block"], plan["lanes_per_stage"], plan["padded_lanes"], plan["groups"],
            plan["stages"], plan["blocks"]) == want
    nqs = min(-(-sq // F6_SHAPE.queries_per_thread), F6_SHAPE.threads)
    assert plan["tiles_per_block"] * plan["padded_lanes"] <= F6_SHAPE.stage_rows
    assert plan["tiles_per_block"] * nqs <= F6_SHAPE.threads


# ---- the moments6 kernel's screen: emulation, margin, plan -------------------------


def emulate_moments6(query_tiles, tiles, cand, q_cent, r2, shape):
    """csrc/blocknn.cu's moments6 in numpy float32, step for step, a query
    tile at a time (its queries' results depend on nothing else): stages in
    order (candidate slot, run of `moments6_plan`'s lanes), each packed
    centred on the tile's c with rr, sentinel rows and the padding to a
    whole mask word (NaN, NaN, NaN, +inf); the stage's R from its largest
    valid rr (as bits); each query's thresholds A -/+ delta and far test in
    float32; no bit in a mask word whose box of valid rows is beyond the
    query's reach r2 + delta; the screen's bit, the sign of the FMA chain on fl(rr - thr_hi)
    (a NaN's sign bit clear, as the card's canonical NaN), then each hit
    either under thr_lo (the FMA chain on rr) or decided by the direct
    form. The sums are taken in
    float64 (the kernel's order of fp32 sums is not the point here); the
    finish is the kernel's, with one reciprocal a query. Returns ((10,
    Tq*Sq) float32, counts: pairs screened, hit and in the band, far query
    stages, query words beyond their reach)."""
    tq, sq, _ = query_tiles.shape
    s, k = tiles.shape[1], cand.shape[1]
    plan = blocknn_cuda.moments6_plan(tq, sq, s, k, shape)
    lc, lcp = plan["lanes_per_stage"], plan["padded_lanes"]
    chunks = -(-s // lc)
    r2 = np.float32(r2)
    f32 = np.float32
    out = np.empty((10, tq * sq), np.float32)
    counts = {"screened": 0, "hit": 0, "band": 0, "far": 0, "beyond": 0}
    for t in range(tq):
        c = q_cent[t]
        qc = query_tiles[t] - c
        a = f32(-2.0) * qc
        qq = (qc[:, 0] * qc[:, 0] + qc[:, 1] * qc[:, 1]) + qc[:, 2] * qc[:, 2]
        qn = np.sqrt(qq)
        sums = np.zeros((sq, 10), np.float64)
        for st in range(k * chunks):
            ci, l0 = st // chunks, (st % chunks) * lc
            raw = tiles[cand[t, ci], l0:l0 + min(lc, s - l0)]
            valid = (np.abs(raw) < 1e6).all(1)
            rc = raw - c
            rr = (rc[:, 0] * rc[:, 0] + rc[:, 1] * rc[:, 1]) + rc[:, 2] * rc[:, 2]
            rows = np.full((lcp, 4), np.nan, np.float32)
            rows[:, 3] = np.inf
            rows[:len(raw)][valid] = np.concatenate([rc, rr[:, None]], 1)[valid]
            big_r = np.sqrt(rr[valid].view(np.uint32).max(initial=0).view(np.float32))
            with np.errstate(invalid="ignore", over="ignore"):
                total = qn + big_r
                w = total * total + np.abs(r2)
                delta = f32(2.0 ** -18) * w + f32(2.0 ** -100)
                a_thr = r2 - qq
                g = qn - big_r
                proven = w < f32(2.0 ** 100)
                far = proven & (g > 0) & (g * g > r2 + delta)
                lo = np.where(proven, a_thr - delta, -np.inf).astype(np.float32)
                hi = np.where(far, -np.inf, np.where(proven, a_thr + delta, np.inf)).astype(np.float32)
                shifted = rows[None, :, 3] - hi[:, None]  # (Sq, lcp) fl(rr - thr_hi)
                t_hi = _fma32(a[:, None, 0], rows[None, :, 0], _fma32(
                    a[:, None, 1], rows[None, :, 1], _fma32(a[:, None, 2], rows[None, :, 2], shifted)))
                hit = np.signbit(t_hi) & ~np.isnan(t_hi)
                # a mask word whose box of valid rows is beyond the query's
                # reach fl(r2 + delta) sets no bit (the kernel skips it when
                # every query of the warp is beyond it)
                word = rows[:, :3].reshape(-1, 32, 3)
                has = ~np.isnan(word[..., 0])
                box_lo = np.where(has[..., None], word, np.inf).min(1)
                box_hi = np.where(has[..., None], word, -np.inf).max(1)
                gap = np.maximum(np.maximum(box_lo[None] - qc[:, None], qc[:, None] - box_hi[None]),
                                 np.float32(0))  # (Sq, words, 3)
                box_d2 = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) + gap[..., 2] * gap[..., 2]
                reach = np.where(far, -np.inf, np.where(proven, r2 + delta, np.inf)).astype(np.float32)
                beyond = ~(box_d2 <= reach[:, None])
                counts["beyond"] += int(beyond.sum())
                hit &= ~np.repeat(beyond, 32, axis=1)
                sc = _f6_score(a, rows)  # (Sq, lcp), the FMA chain on rr
                inside = hit & (sc <= lo[:, None])
                d = _f6_direct(qc, rows[:, :3])
            band = hit & ~inside
            count = inside | (band & (d <= r2))
            counts["screened"] += int((~far).sum()) * lcp
            counts["far"] += int(far.sum())
            counts["hit"] += int(hit.sum())
            counts["band"] += int(band.sum())
            x = np.nan_to_num(rows[:, :3].astype(np.float64))
            feat = np.stack([np.ones(lcp), x[:, 0], x[:, 1], x[:, 2], x[:, 0] * x[:, 0],
                             x[:, 0] * x[:, 1], x[:, 0] * x[:, 2], x[:, 1] * x[:, 1],
                             x[:, 1] * x[:, 2], x[:, 2] * x[:, 2]], 1)
            sums += count.astype(np.float64) @ feat
        m = sums.astype(np.float32)
        inv = f32(1.0) / np.maximum(m[:, 0], f32(1.0))
        mc = m[:, 1:4] * inv[:, None]
        res = np.empty((sq, 10), np.float32)
        res[:, 0] = m[:, 0]
        res[:, 1:4] = mc + c
        for f, (i, j) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))):
            res[:, 4 + f] = m[:, 4 + f] * inv - mc[:, i] * mc[:, j]
        out[:, t * sq:(t + 1) * sq] = res.T
    return out, counts


def _check_moments6(out_e, out_p, q_cent, sq):
    """Counts bit-equal on every row, and rows that count nothing equal
    (count 0, the centroid, zeros); means within 1e-5 and covariances
    within `_cov_tol` on every row."""
    out_p = to_np(out_p)
    np.testing.assert_array_equal(out_e[0], out_p[0])
    none = out_p[0] == 0
    np.testing.assert_array_equal(out_e[:, none], out_p[:, none])
    np.testing.assert_allclose(out_e[1:4], out_p[1:4], rtol=0, atol=1e-5)
    tol = _cov_tol(out_p[1:4].T, out_p[4:], q_cent, sq)
    assert (np.abs(out_e[4:].astype(np.float64) - out_p[4:]) <= tol).all()


@pytest.mark.parametrize("name", M6_FIXTURES)
@pytest.mark.parametrize("tq,sq,s,k", list(M6_FIXTURE_SHAPES.values()), ids=list(M6_FIXTURE_SHAPES))
def test_emulated_moments6_equals_reference(name, tq, sq, s, k):
    """The kernel's staging, centred packing, per-stage R, thresholds, far
    test, screen and direct decisions in the band give moments6_reference's
    counts bit for bit and its moments within tolerance, on each fixture at
    each of chip_smoke's shapes (every kind of `moments6_plan`: the 1M plan,
    k = 8, Sq not a multiple of 4, a tile over two blocks with S over three
    stages, S padded to a mask word)."""
    query, tiles, cand, q_cent, r2 = (to_np(x) for x in chip_smoke.moments6_fixture(
        name, tq, sq, s, k, n_tiles=max(12, k + 2)))
    out_e, counts = emulate_moments6(query, tiles, cand, q_cent, r2, M6_SHAPE)
    out_p = moments6_reference(*(torch.as_tensor(x) for x in (query, tiles, cand, q_cent, r2)))
    _check_moments6(out_e, out_p, q_cent, sq)
    if name == "near the radius" or (name == "far tile" and tq * sq >= 64):
        assert counts["band"] > 0  # the direct form decided some pairs
    if name in ("far queries", "pad queries"):
        assert counts["far"] > 0
    if name == "far queries":
        assert counts["hit"] == 0 and (out_e[0] == 0).all()
    if name == "random":
        assert counts["band"] < counts["hit"] < counts["screened"] // 4


def test_emulated_moments6_on_a_surface_index():
    """The 1M normals shape at test size: the KD index of a 12,000-point
    surface cloud, each tile its own query tile, k_tiles = 2, the
    registration's radius; counts bit for bit, ~15 neighbours a row."""
    x, _ = _cloud(12000, seed=10, surface=True)
    ti = tb.build_kd_index(torch.as_tensor(x), tile_size=128)
    radius = float(auto_cell_size(ti.tiles.reshape(-1, 3), ti.order >= 0, scale=3.0))
    cand, q_cent = tb._candidate_tiles(ti.tiles, ti, 2)
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    out_e, counts = emulate_moments6(to_np(ti.tiles), to_np(ti.tiles), to_np(cand), to_np(q_cent),
                                     float(r2), M6_SHAPE)
    _check_moments6(out_e, moments6_reference(ti.tiles, ti.tiles, cand, q_cent, r2), to_np(q_cent),
                    ti.tile_size)
    assert out_e[0][to_np(ti.order) >= 0].mean() > 5 and counts["hit"] > 0


@pytest.mark.parametrize("scale", [1.0, 1000.0])
@pytest.mark.parametrize("name", ["uniform", "box corners", "ulp neighbours", "on the radius"])
def test_moments6_margin_bounds_the_screen(name, scale):
    """For every valid pair, the fp32 score s (the FMA chain on rc, rr =
    fl(|rc|^2), a = -2 qc) plus the exact |qc|^2 is within delta / 4 of the
    fp32 direct form d, with delta from moments6_screen_margin at the pair's
    stage R (the root of its largest rr): the source note's bound E, which
    delta is four times; and the screen's t (the chain on fl(rr - thr_hi))
    plus thr_hi and |qc|^2 is within delta / 2 of d. Rows and queries centred near the origin
    (scale 1) and centred on a point 1,000 units away (so |qc| and R are
    large), uniform, on the far corners of the rows' box, one ulp from
    the queries, and on the radius."""
    rng = np.random.default_rng(int(scale) + len(name))
    rows = rng.uniform(-1, 1, (512, 3)).astype(np.float32) * np.float32(0.05)
    query = rng.uniform(-1, 1, (64, 3)).astype(np.float32) * np.float32(0.05)
    if name == "box corners":
        lo, hi = rows.min(0), rows.max(0)
        query = np.where(rng.integers(0, 2, (64, 3)).astype(bool), lo, hi).astype(np.float32)
    elif name == "ulp neighbours":
        rows[:64] = query
        rows[64:128] = np.nextafter(query, np.float32(np.inf))
    elif name == "on the radius":
        u = rng.normal(size=(64, 3))
        rows[:64] = (query + 0.02 * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    c = np.float32(scale) * np.float32([1, -1, 1]) if scale > 1 else np.zeros(3, np.float32)
    qc, rc = query - c, rows - c  # the contract's centred floats
    rr = (rc[:, 0] * rc[:, 0] + rc[:, 1] * rc[:, 1]) + rc[:, 2] * rc[:, 2]
    qq32 = (qc[:, 0] * qc[:, 0] + qc[:, 1] * qc[:, 1]) + qc[:, 2] * qc[:, 2]
    r2 = torch.tensor(0.02 * 0.02, dtype=torch.float32)
    delta = blocknn_cuda.moments6_screen_margin(torch.as_tensor(qq32), torch.tensor(np.sqrt(rr.max())),
                                                r2).numpy().astype(np.float64)
    s = _f6_score(np.float32(-2.0) * qc, np.concatenate([rc, rr[:, None]], 1)).astype(np.float64)
    qq = (qc.astype(np.float64) ** 2).sum(1)
    d = _f6_direct(qc, rc).astype(np.float64)
    err = np.abs(s + qq[:, None] - d)
    worst = float((err / (delta[:, None] / 4)).max())
    assert worst <= 1.0, f"the screen's error reaches {worst:.3f} x delta / 4"
    # the screen's bit: the sign of t = fma chain on fl(rr - thr_hi), within
    # delta / 2 of d - |qc|^2 - thr_hi (the note's 11 u W and the direct
    # form's 5 u W)
    hi = ((np.float32(r2) - qq32) + delta.astype(np.float32)).astype(np.float32)
    shifted = (rr[None, :] - hi[:, None]).astype(np.float32)
    a = np.float32(-2.0) * qc
    t = _fma32(a[:, None, 0], rc[None, :, 0], _fma32(a[:, None, 1], rc[None, :, 1],
                                                     _fma32(a[:, None, 2], rc[None, :, 2], shifted)))
    err_t = np.abs(t.astype(np.float64) + hi[:, None] + qq[:, None] - d)
    worst_t = float((err_t / (delta[:, None] / 2)).max())
    assert worst_t <= 1.0, f"the sign screen's error reaches {worst_t:.3f} x delta / 2"


@pytest.mark.parametrize("tq,sq,s,k,want", [
    (8192, 128, 128, 2, (2, 128, 128, 4, 2, (4096, 1))),  # the 1M normals shape
    (8192, 128, 128, 8, (2, 128, 128, 4, 8, (4096, 1))),  # GICP's covariance shape
    (6, 128, 128, 8, (2, 128, 128, 4, 8, (3, 1))),  # k = 8
    (5, 22, 32, 4, (11, 32, 32, 1, 4, (1, 1))),  # 11 threads a tile, 11 tiles a block
    (3, 3, 8, 3, (16, 8, 32, 1, 3, (1, 1))),  # Sq odd; S padded to a mask word
    (2, 600, 300, 2, (1, 128, 128, 4, 6, (2, 3))),  # a tile over three blocks, S over 3 stages
    (7, 64, 100, 3, (4, 100, 128, 4, 3, (2, 1))),  # S not a multiple of 4: padded lanes
    (9, 5, 130, 2, (4, 128, 128, 4, 4, (3, 1))),  # Sq odd, a last stage of 2 lanes
])
def test_moments6_plan_of_the_kernel_shape(tq, sq, s, k, want):
    plan = blocknn_cuda.moments6_plan(tq, sq, s, k, M6_SHAPE)
    assert (plan["tiles_per_block"], plan["lanes_per_stage"], plan["padded_lanes"], plan["words"],
            plan["stages"], plan["blocks"]) == want
    nqs = min(-(-sq // M6_SHAPE.queries_per_thread), M6_SHAPE.threads)
    assert plan["tiles_per_block"] * plan["padded_lanes"] <= M6_SHAPE.stage_rows
    assert plan["tiles_per_block"] * nqs <= M6_SHAPE.threads
    assert plan["lanes_per_stage"] <= M6_SHAPE.stage_lanes and plan["padded_lanes"] % M6_SHAPE.group == 0


# ---- in-fold payload selection ("infold", plain torch) ------------------------------


@pytest.mark.parametrize("variant", ["plain", "frozen", "chunked", "bf16"])
def test_block_nn_payload_matches_jax(variant):
    """`block_nn_payload` against the JAX function, as in
    tests/test_blocknn.py::test_block_nn_payload_matches_gather: the same
    misses (d = inf, zero payload), d2 at the fold's tolerance, payloads
    equal on separated rows ("bf16": payload values rounded to bf16 after
    centring; the bf16 score moves d2 by up to 1e4 x the fp32 tolerance and
    may swap near-tie winners, so rows are held to the bf16 payload
    precision instead)."""
    jq, ji, table, cand = _fold_case(seed=16)
    pl_tiles = table.reshape(ji.n_tiles, ji.tile_size, 6)
    kw_j, kw_t = dict(k_tiles=6), dict(k_tiles=6)
    if variant in ("frozen", "chunked"):
        kw_j["cand_tiles"], kw_t["cand_tiles"] = jnp.asarray(cand), torch.as_tensor(cand)
    if variant == "chunked":
        kw_j["max_chunk"] = kw_t["max_chunk"] = 16  # 48 query tiles: 3 chunks
    if variant == "bf16":
        for kw in (kw_j, kw_t):
            kw.update(score_prec="bf16", payload_prec="bf16", payload_xyz=3)
    d_j, pl_j = jb.block_nn_payload(jq.tiles, ji, jnp.asarray(pl_tiles), **kw_j)
    d_t, pl_t = tb.block_nn_payload(torch.as_tensor(np.asarray(jq.tiles)), _same_index(ji),
                                    torch.as_tensor(pl_tiles), **kw_t)
    d_j, d_t, pl_j, pl_t = np.asarray(d_j), to_np(d_t), np.asarray(pl_j), to_np(pl_t)
    fin = np.isfinite(d_j)  # padded query rows score real rows: huge but finite
    assert fin.all() and np.isfinite(d_t).all()
    atol = _dist_tol(jq.tiles) * (1e4 if variant == "bf16" else 1)
    np.testing.assert_allclose(d_t[fin], d_j[fin], rtol=1e-5, atol=atol)
    if variant == "bf16":
        np.testing.assert_allclose(pl_t[fin], pl_j[fin], atol=2.0**-8 * np.abs(pl_j).max())
        return
    sep = _separated(jq.tiles, ji.tiles, cand) & fin
    assert sep[fin].mean() > 0.9
    np.testing.assert_array_equal(pl_t[sep], pl_j[sep])


def test_block_nn_payload_all_sentinel_candidates_miss():
    x, _ = _cloud(900, seed=13)
    ji = jb.build_kd_index(jnp.asarray(x), tile_size=64)  # 16 tiles, the last all padding
    table = np.asarray(jb.fused_payload_table(ji, jnp.ones((900, 3), jnp.float32)))
    pl_tiles = table.reshape(ji.n_tiles, ji.tile_size, 6)
    pad_tile = int(np.nonzero((np.asarray(ji.order).reshape(ji.n_tiles, -1) < 0).all(1))[0][0])
    query, cand = np.asarray(ji.tiles[:2]), np.array([[0, 1], [pad_tile, pad_tile]])
    d_t, pl_t = tb.block_nn_payload(torch.as_tensor(query), _same_index(ji), torch.as_tensor(pl_tiles),
                                    cand_tiles=torch.as_tensor(cand))
    d_j, pl_j = jb.block_nn_payload(jnp.asarray(query), ji, jnp.asarray(pl_tiles),
                                    cand_tiles=jnp.asarray(cand, jnp.int32))
    assert np.isinf(to_np(d_t)[64:]).all() and (to_np(pl_t)[64:] == 0).all()
    np.testing.assert_array_equal(to_np(pl_t), np.asarray(pl_j))
    np.testing.assert_allclose(to_np(d_t), np.asarray(d_j), rtol=1e-5, atol=_dist_tol(query))


def test_block_nn_payload_feature_metric_raises():
    _, jq, ji = _query_and_index(n=4096, seed=8)
    qt = torch.as_tensor(np.asarray(jq.tiles))
    pl = torch.zeros(ji.tiles.shape)
    with pytest.raises(ValueError, match="both query_feat and feat_tiles"):
        tb.block_nn_payload(qt, _same_index(ji), pl, query_feat=torch.zeros(qt.shape[:2]))
    with pytest.raises(ValueError, match="bf16 scoring"):
        tb.block_nn_payload(qt, _same_index(ji), pl, payload_prec="bf16", payload_xyz=3)


# ---- payload selection (kernel #5) ---------------------------------------------------


def test_select_plain_matches_pallas_interpret():
    """The positions of the plain frozen-candidate fold to payload rows: the
    port's plain version and the Pallas kernel agree on every row."""
    jq, ji, table, cand = _fold_case(seed=17)
    ti = _same_index(ji)
    _, pos = tb.block_nn(torch.as_tensor(np.asarray(jq.tiles)), ti, return_pos=True,
                         cand_tiles=torch.as_tensor(cand))
    pos = pos.reshape(jq.n_tiles, jq.tile_size)
    pl_tiles = table.reshape(ji.n_tiles, ji.tile_size, 6)
    before = dict(profiling.LAUNCHES)
    pl_t = blocknn_cuda.payload_select_fused(pos, torch.as_tensor(cand), torch.as_tensor(pl_tiles))
    assert profiling.LAUNCHES == before  # CPU tensors: the plain version ran
    pl_j = j_select(jnp.asarray(to_np(pos)), jnp.asarray(cand, jnp.int32), jnp.asarray(pl_tiles),
                    interpret=True)
    np.testing.assert_array_equal(to_np(pl_t), np.asarray(pl_j))
    np.testing.assert_array_equal(to_np(pl_t), table[to_np(pos).reshape(-1)])  # hits: the row itself


def test_select_duplicate_candidates_and_misses():
    """A candidate tile listed twice doubles its row, four times quadruples
    it; a position in no candidate tile gives zeros (the TPU kernel's one-hot
    sum, both versions)."""
    _, payload, fields = _tie_fixture()
    pl_tiles = payload.reshape(4, 8, 6) + 0.25
    pos = np.array([[9, 3, 17, 30]], np.int32)  # tiles 1, 0, 2, 3
    for cand, mult in (([1, 1, 2, 3], [2, 0, 1, 1]), ([0, 0, 0, 0], [0, 4, 0, 0])):
        want = pl_tiles.reshape(32, 6)[pos[0]] * np.float32(mult)[:, None]
        got_t = blocknn_cuda.payload_select_fused(torch.as_tensor(pos), torch.tensor([cand]),
                                                  torch.as_tensor(pl_tiles))
        got_j = j_select(jnp.asarray(pos), jnp.asarray([cand], jnp.int32), jnp.asarray(pl_tiles),
                         interpret=True)
        np.testing.assert_array_equal(to_np(got_t), want)
        np.testing.assert_array_equal(np.asarray(got_j), want)


@pytest.mark.parametrize("d,offset,width", [
    (6, 0, 2),  # the symmetric table: float2 chunks
    (12, 0, 4),  # GICP's table: float4 chunks
    (7, 0, 1),  # an odd width: scalar
    (12, 1, 1),  # 4-byte aligned only: scalar
    (12, 2, 2),  # 8-byte aligned: float2
])
def test_select_width_follows_d_and_alignment(d, offset, width):
    table = _table_view(64, d, offset)
    assert table.is_contiguous() and table.data_ptr() % 16 == 4 * offset % 16
    assert blocknn_cuda.select_width(table) == width


# ---- bf16-scored frozen-candidate fold (kernel #4) --------------------------------------


def test_fold7_plain_matches_pallas_interpret():
    """Winners (payload rows, unique per row) equal on >= 99.9% of rows, the
    payload exactly; d2 within 1.2e-7 (two ulps at 0.5) wherever they agree:
    the bf16 operands and their products are the same, but XLA's CPU bf16
    dot sums the four exact products in an order of its own (no fixed order
    reproduces it on every element), and every partial sum of this
    unit-cube input stays below 0.5."""
    jq, ji, table, cand = _fold_case(seed=18)
    _, q_cent = jb._candidate_tiles(jq.tiles, ji, 6)
    pl_tiles = jnp.asarray(table.reshape(ji.n_tiles, ji.tile_size, 6))
    b, pl_c, qc, d_pl = j_fold7_prepare(jnp.asarray(cand), q_cent, ji, pl_tiles)
    d_j, pl_j = j_fold7(jq.tiles, b, pl_c, qc, d_pl, interpret=True)
    ops = blocknn_cuda.fold7_prepare(torch.as_tensor(cand), torch.as_tensor(np.asarray(q_cent)),
                                     _same_index(ji), torch.as_tensor(table))
    before = dict(profiling.LAUNCHES)
    d_t, pl_t = blocknn_cuda.block_fold7_pre(torch.as_tensor(np.asarray(jq.tiles)), ops)
    assert profiling.LAUNCHES == before
    d_j, d_t, pl_j, pl_t = np.asarray(d_j), to_np(d_t), np.asarray(pl_j), to_np(pl_t)
    fin = np.isfinite(d_j)
    np.testing.assert_array_equal(np.isfinite(d_t), fin)
    assert (~fin).sum() == np.sum(np.asarray(jq.order) < 0)
    same = (pl_t == pl_j).all(1)
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(d_t[same], d_j[same], rtol=0, atol=1.2e-7)


def _sentinel_fixture():
    """The tie fixture plus a fifth, all-sentinel tile (order -1, zero
    payload normals)."""
    query, payload, fields = _tie_fixture()
    tiles = np.concatenate([fields.tiles, np.full((1, 8, 3), PAD_COORD, np.float32)])
    order = np.concatenate([fields.order, np.full(8, -1, np.int32)])
    payload = np.concatenate([payload, np.zeros((8, 6), np.float32)])
    payload[32:, :3] = PAD_COORD
    fields = SimpleNamespace(tiles=tiles, box_lo=tiles.min(1), box_hi=tiles.max(1),
                             centroids=tiles.mean(1), order=order)
    return query, payload, fields


@pytest.mark.parametrize("cand", [[0, 1, 2, 3], [3, 2, 1, 0], [4, 4, 4, 4]])
def test_fold7_tie_rule_and_misses(cand):
    """fold6's rule (least score, lowest lane, earliest candidate) on exact
    ties, which integer coordinates centred on 0 keep exact in bf16; a tile
    of all-sentinel candidates misses onto its first sentinel row. Equal to
    the Pallas kernel."""
    query, payload, fields = _sentinel_fixture()
    index = interop.tile_index_from_numpy(fields, device="cpu")
    q_cent = torch.zeros((1, 3))
    ops = blocknn_cuda.fold7_prepare(torch.tensor([cand]), q_cent, index, torch.as_tensor(payload))
    d_t, pl_t = blocknn_cuda.fold7_reference(torch.as_tensor(query), ops)
    if cand[0] == 4:
        assert np.isinf(to_np(d_t)).all() and (to_np(pl_t)[:, 0] == PAD_COORD).all()
        assert (to_np(pl_t)[:, 3:] == 0).all()
    else:
        want1 = 8 * cand[min(cand.index(2), cand.index(3))] + 2
        assert pl_t[0, 0] == 9 and pl_t[1, 0] == want1 and d_t[0] == 0 and d_t[1] == 0
    j_index = jb.TileIndex(**{f: jnp.asarray(v) for f, v in vars(fields).items()})
    b, pl_c, qc, d_pl = j_fold7_prepare(jnp.asarray([cand], jnp.int32), jnp.zeros((1, 3)), j_index,
                                        jnp.asarray(payload.reshape(5, 8, 6)))
    d_j, pl_j = j_fold7(jnp.asarray(query), b, pl_c, qc, d_pl, interpret=True)
    np.testing.assert_array_equal(to_np(pl_t), np.asarray(pl_j))
    np.testing.assert_array_equal(to_np(d_t), np.asarray(d_j))



def _fold7_jax_case(case):
    """(cand, q_cent, torch TileIndex, payload table, the JAX prep's b as
    (Tq, k, S, 4)) on the fold case of seed 18 (its frozen candidates and
    query-tile centroids) or on the sentinel fixture (candidates 0-3 and
    the all-sentinel tile, centred on 0)."""
    if case == "fold case":
        jq, ji, table, cand = _fold_case(seed=18)
        _, q_cent = jb._candidate_tiles(jq.tiles, ji, 6)
        q_cent = np.asarray(q_cent)
        index = _same_index(ji)
        pl_tiles = jnp.asarray(table.reshape(ji.n_tiles, ji.tile_size, 6))
    else:
        _, table, fields = _sentinel_fixture()
        cand, q_cent = np.array([[0, 1, 2, 3], [4, 4, 4, 4]]), np.zeros((2, 3), np.float32)
        index = interop.tile_index_from_numpy(fields, device="cpu")
        ji = jb.TileIndex(**{f: jnp.asarray(v) for f, v in vars(fields).items()})
        pl_tiles = jnp.asarray(table.reshape(5, 8, 6))
    b, _, _, _ = j_fold7_prepare(jnp.asarray(cand, jnp.int32), jnp.asarray(q_cent), ji, pl_tiles)
    b = np.swapaxes(np.asarray(b[:len(cand)]), 2, 3)  # (Tq', k, 4, S) -> (Tq, k, S, 4)
    return cand, q_cent, index, table, b


@pytest.mark.parametrize("case", ["fold case", "sentinel fixture"])
def test_fold7_operands_equal_the_jax_prep(case):
    """The bf16 operands the plain version makes a chunk at a time
    (`fold7_operands`, the rows the kernel makes as it stages them) are the
    JAX prep's `b`, bit for bit: dropping the per-phase copy changed no
    operand."""
    cand, q_cent, index, table, b_j = _fold7_jax_case(case)
    ops = blocknn_cuda.fold7_prepare(torch.as_tensor(cand), torch.as_tensor(q_cent), index,
                                     torch.as_tensor(table))
    got = blocknn_cuda.fold7_operands(ops, 0, len(cand))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == b_j.shape
    np.testing.assert_array_equal(to_np(got.view(torch.int16)), b_j.view(np.int16))
    # and a chunk of it is the same rows
    np.testing.assert_array_equal(to_np(blocknn_cuda.fold7_operands(ops, 1, 2).view(torch.int16)),
                                  b_j[1:2].view(np.int16))


def test_fold7_operands_hold_no_per_candidate_copy():
    """`fold7_prepare` keeps the inputs (the index's tiles and the payload
    table themselves where they are already contiguous float32) and makes
    no tensor of Tq * k * S elements or more."""
    cand, q_cent, index, table, _ = _fold7_jax_case("fold case")
    tq, k = cand.shape
    table_t = torch.as_tensor(table)
    ops = blocknn_cuda.fold7_prepare(torch.as_tensor(cand), torch.as_tensor(q_cent), index, table_t)
    fields = [getattr(ops, f.name) for f in dataclasses.fields(ops)]
    assert all(isinstance(x, torch.Tensor) for x in fields)
    assert max(x.numel() for x in fields) < tq * k * index.tile_size
    assert ops.tiles.data_ptr() == index.tiles.data_ptr() and ops.payload.data_ptr() == table_t.data_ptr()
    assert ops.cand.dtype == torch.int32 and ops.q_cent.dtype == torch.float32


# Step 1's range of the fold7 kernel's source note.
F7_RANGE_A = (np.uint32(0x20000000), np.uint32(0x5F000000))  # [2^-63, 2^63)
F7_RANGE_B = (np.uint32(0x20800000), np.uint32(0x5F800000))  # [2^-62, 2^64)


@pytest.mark.parametrize("tq,sq,s,k,want", [
    (16384, 64, 128, 6, (8, 20, 120, 7, (2048, 1))),  # the 1M refine shape
    (256, 64, 128, 6, (8, 20, 120, 7, (32, 1))),  # the 16k pair's refine shape
    (2, 8, 8, 4, (64, 4, 16, 2, (1, 1))),  # chip_smoke's tie and miss fixtures
    (2, 64, 512, 8, (8, 16, 128, 32, (1, 1))),  # k x S above 3,072 rows
    (5, 600, 2000, 1, (1, 1024, 1024, 2, (5, 2))),  # a tile over two blocks, S over two stages
    (9, 3, 13, 3, (128, 2, 8, 7, (1, 1))),  # S not a multiple of 4: stages of 2 lanes
    (4, 8, 8, 200, (5, 1, 200, 8, (1, 1))),  # k = 200 caps a block at 5 tiles
    (3, 30, 100, 6, (16, 8, 48, 13, (1, 1))),  # Sq not a multiple of 4
    (1, 1, 4, 2000, (1, 1, 2000, 4, (1, 1))),  # k beyond a stage: fold7_cuda refuses it
])
def test_fold7_plan_of_the_kernel_shape(tq, sq, s, k, want):
    plan = blocknn_cuda.fold7_plan(tq, sq, s, k, F7_SHAPE)
    assert (plan["tiles_per_block"], plan["lanes_per_stage"], plan["padded_rows"], plan["stages"],
            plan["blocks"]) == want
    nqs = min(-(-sq // F7_SHAPE.queries_per_thread), F7_SHAPE.threads)
    assert plan["tiles_per_block"] * nqs <= F7_SHAPE.threads
    assert plan["padded_rows"] % F7_SHAPE.group == 0 and plan["lanes_per_stage"] <= s
    fits = plan["tiles_per_block"] * plan["padded_rows"] <= F7_SHAPE.stage_rows
    assert fits == (k <= F7_SHAPE.stage_rows)
    if 4 <= plan["lanes_per_stage"] < s:  # a split stage starts on 16 bytes
        assert plan["lanes_per_stage"] % 4 == 0


def _bf16(x):
    """float32 -> bf16, rounded to nearest even -> float32."""
    return to_np(torch.as_tensor(np.ascontiguousarray(x)).to(torch.bfloat16).to(torch.float32))


def _f7_outside(x, rng):
    """Nonzero entries of x whose magnitude lies outside [lo, hi) (the
    range given as float bits), as the kernel's f7_outside."""
    m = np.asarray(x, np.float32).view(np.uint32) & np.uint32(0x7FFFFFFF)
    return ((m - np.uint32(1)) < rng[0] - np.uint32(1)) | (m >= rng[1])


def _f7_fast(a, rows):
    """(Q, 3) x (R, 4) -> (Q, R) fadd(fma(az, Bz, fma(ay, By, ax * Bx)),
    Bw), the kernel's 4-instruction score."""
    p0 = a[:, None, 0] * rows[None, :, 0]
    s2 = _fma32(a[:, None, 2], rows[None, :, 2], _fma32(a[:, None, 1], rows[None, :, 1], p0))
    return s2 + rows[None, :, 3]


def _f7_steps(a, rows):
    """(Q, 3) x (R, 4) -> (Q, R) ((ax Bx + ay By) + az Bz) + Bw, each step
    rounded: the contract's score."""
    p = a[:, None, :] * rows[None, :, :3]
    return ((p[..., 0] + p[..., 1]) + p[..., 2]) + rows[None, :, 3]


def emulate_fold7(query_tiles, index, cand, q_cent, shape):
    """csrc/blocknn.cu's fold7 in numpy, a query tile at a time: the
    operands of its k x S rows in j order (`fold7_operands`), staged as
    `fold7_plan` cuts them (lanes [l0, l0 + L) of every candidate, padded
    to whole groups with (0, 0, 0, +inf)), scored by the 4-instruction form
    and folded by group minima; the strict '<' over groups in scan order
    keeps the first least group, whose rows are scored again in the
    contract's steps, the first equal to the best winning; a query outside
    step 1's range (or in a tile with an operand outside it) takes the
    direct scan in the contract's steps instead. Returns (d2, flat payload
    row, counts of queries by path)."""
    tq, sq, _ = query_tiles.shape
    s, k = index.tile_size, cand.shape[1]
    plan = blocknn_cuda.fold7_plan(tq, sq, s, k, shape)
    lc, lcp, group = plan["lanes_per_stage"], plan["padded_rows"], shape.group
    ops = blocknn_cuda.fold7_prepare(torch.as_tensor(cand), torch.as_tensor(q_cent), index,
                                     torch.zeros((index.n_tiles * s, 1)))
    ops_b = to_np(blocknn_cuda.fold7_operands(ops, 0, tq).to(torch.float32))
    ops_b = np.ascontiguousarray(ops_b.transpose(0, 2, 1, 3)).reshape(tq, s * k, 4)  # j = lane * k + c
    d_out = np.empty(tq * sq, np.float32)
    pos_out = np.empty(tq * sq, np.int64)
    counts = {"group": 0, "direct": 0}
    inf = np.float32(np.inf)
    for t in range(tq):
        qc = query_tiles[t] - q_cent[t]
        qq = (qc[:, 0] * qc[:, 0] + qc[:, 1] * qc[:, 1]) + qc[:, 2] * qc[:, 2]
        a = _bf16(qc)
        b = ops_b[t]
        tile_out = bool(_f7_outside(b[:, :3], F7_RANGE_B).any())
        gmins, firsts = [], []
        for st in range(plan["stages"]):
            l0 = st * lc
            nl = min(lc, s - l0)
            rows = np.zeros((lcp, 4), np.float32)
            rows[:, 3] = inf
            rows[:nl * k] = b[l0 * k:(l0 + nl) * k]
            ng = -(-nl * k // group)
            gmins.append(_f7_fast(a, rows[:ng * group]).reshape(sq, ng, group).min(2))
            firsts.append(l0 * k + group * np.arange(ng))
        gmin, first = np.concatenate(gmins, 1), np.concatenate(firsts)
        g = np.argmin(gmin, axis=1)  # the first least group: a strict '<' in scan order
        best, bj = gmin[np.arange(sq), g], first[g]
        for i in range(sq):
            if tile_out or _f7_outside(a[i], F7_RANGE_A).any():
                sc = _f7_steps(a[i:i + 1], b)[0]
                j = int(np.argmin(sc))  # the least score, then the least j
                best[i] = sc[j]
                counts["direct"] += 1
            else:
                js = np.arange(bj[i], min(bj[i] + group, s * k))
                j = int(js[np.nonzero(_f7_steps(a[i:i + 1], b[js])[0] == best[i])[0][0]])
                counts["group"] += 1
            d = np.maximum(best[i] + qq[i], np.float32(0))
            d_out[t * sq + i] = d if d < 1e15 else inf
            pos_out[t * sq + i] = int(cand[t, j % k]) * s + j // k
    return d_out, pos_out, counts


@pytest.mark.parametrize("name", F7_FIXTURES)
@pytest.mark.parametrize("tq,sq,s,k", list(F7_FIXTURE_SHAPES.values()), ids=list(F7_FIXTURE_SHAPES))
def test_emulated_fold7_equals_reference(name, tq, sq, s, k):
    """The kernel's lane-major stages, group minima of the 4-instruction
    score, first-least-group tracking, rescoring and direct scan give
    fold7_reference's d2 and payload bit for bit, on each of chip_smoke's
    fold7 fixtures at each of its shapes (every kind of plan)."""
    query, index, cand, q_cent, payload = chip_smoke.fold7_fixture(name, tq, sq, s, k,
                                                                   n_tiles=max(12, k + 2))
    query, cand, q_cent, payload = to_np(query), to_np(cand), to_np(q_cent), to_np(payload)
    d_e, pos_e, counts = emulate_fold7(query, index, cand, q_cent, F7_SHAPE)
    ops = blocknn_cuda.fold7_prepare(torch.as_tensor(cand), torch.as_tensor(q_cent), index,
                                     torch.as_tensor(payload))
    d_p, pl_p = blocknn_cuda.fold7_reference(torch.as_tensor(query), ops)
    np.testing.assert_array_equal(d_e.view(np.int32), to_np(d_p).view(np.int32))
    np.testing.assert_array_equal(payload[pos_e], to_np(pl_p))
    assert counts["direct"] == (tq * sq if name == "tiny products" else 0)


def test_fold7_fma_form_is_the_contract_inside_the_range():
    """Where a and B lie in step 1's range, the 4-instruction score equals
    the contract's steps bit for bit (the fold case of seed 18, every
    pair); on the tiny-products fixture some pairs differ, and every pair
    that differs has a factor outside the range, which the kernel sends to
    the direct scan."""
    cand, q_cent, index, _, _ = _fold7_jax_case("fold case")
    jq, _, _, _ = _fold_case(seed=18)
    ops = blocknn_cuda.fold7_prepare(torch.as_tensor(cand), torch.as_tensor(q_cent), index,
                                     torch.zeros((index.n_tiles * index.tile_size, 1)))
    b = to_np(blocknn_cuda.fold7_operands(ops, 0, len(cand)).to(torch.float32))
    query = np.asarray(jq.tiles)
    for t in range(len(cand)):
        a = _bf16(query[t] - q_cent[t])
        rows = b[t].reshape(-1, 4)
        assert not _f7_outside(a, F7_RANGE_A).any() and not _f7_outside(rows[:, :3], F7_RANGE_B).any()
        np.testing.assert_array_equal(_f7_fast(a, rows).view(np.int32), _f7_steps(a, rows).view(np.int32))
    query, index, cand, q_cent, _ = chip_smoke.fold7_fixture("tiny products", 6, 20, 32, 4)
    ops = blocknn_cuda.fold7_prepare(cand, q_cent, index, torch.zeros((12 * 32, 1)))
    b = to_np(blocknn_cuda.fold7_operands(ops, 0, 6).to(torch.float32))
    differ = 0
    for t in range(6):
        a = _bf16(to_np(query[t] - q_cent[t]))
        rows = b[t].reshape(-1, 4)
        bad = _f7_fast(a, rows).view(np.int32) != _f7_steps(a, rows).view(np.int32)
        out = _f7_outside(a, F7_RANGE_A).any(1)[:, None] | _f7_outside(rows[:, :3], F7_RANGE_B).any(1)[None, :]
        assert not (bad & ~out).any()
        differ += int(bad.sum())
    assert differ > 0


# ---- the fused union fold (kernel #6) ----------------------------------------------------


@pytest.mark.parametrize("case", ["overflow", "duplicates", "random8", "random32"])
def test_group_unions_match_jax(case):
    if case == "overflow":  # 6 unique ids into 4 slots: the largest takes the last
        cand, group, u_max, want = [[0, 1, 2], [3, 4, 5]], 2, 4, [[0, 1, 2, 5]]
    elif case == "duplicates":  # 3 unique ids, 5 slots padded with the smallest
        cand, group, u_max, want = [[5, 1, 1], [1, 5, 2]], 2, 8, [[1, 2, 5, 1, 1, 1, 1, 1]]
    else:
        rng = np.random.default_rng(19)
        cand, group, want = rng.integers(0, 40, (64, 6)), 4, None
        u_max = 8 if case == "random8" else 32
    cand = np.asarray(cand, np.int32)
    got = to_np(blocknn_cuda.group_unions(torch.as_tensor(cand), group, u_max))
    ref = np.asarray(j_group_unions(jnp.asarray(cand), group, u_max))
    np.testing.assert_array_equal(got, ref)
    if want is not None:
        np.testing.assert_array_equal(got, want)


def test_fused4_plain_matches_pallas_interpret():
    """tests/test_blocknn.py::test_fused4_matches_brute's case through the
    port (exact NN on > 99.9% of rows, < 0.1% misses) and against the Pallas
    kernel: d2 at the fold's tolerance (both score by the expansion; their
    fp32 roundings differ), indices equal on separated rows."""
    rng = np.random.default_rng(20)
    r = rng.uniform(-1, 1, (8000, 3)).astype(np.float32)
    q = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
    ji = jb.build_kd_index(jnp.asarray(r), tile_size=128)
    jq = jb.build_kd_index(jnp.asarray(q), tile_size=32)
    d_j, i_j = j_fused4(jq.tiles, ji, k_tiles=12, group=4, u_max=32, interpret=True)
    qt = torch.as_tensor(np.asarray(jq.tiles))
    before = dict(profiling.LAUNCHES)
    d_t, i_t = blocknn_cuda.block_nn_fused4(qt, _same_index(ji), k_tiles=12, group=4, u_max=32)
    assert profiling.LAUNCHES == before
    valid = np.asarray(jq.order) >= 0
    d_b, i_b = nearest_neighbor_reference(qt.reshape(-1, 3), torch.as_tensor(r))
    i_t, d_t = to_np(i_t), to_np(d_t)
    assert (i_t[valid] == to_np(i_b)[valid]).mean() > 0.999
    assert (d_t[valid] > to_np(d_b)[valid] + 1e-6).mean() < 0.001
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    np.testing.assert_array_equal(np.isfinite(d_t), np.isfinite(d_j))
    assert np.isinf(d_t[~valid]).all()
    np.testing.assert_allclose(d_t[valid], d_j[valid], rtol=1e-5, atol=_dist_tol(qt))
    _, pos = blocknn_cuda.block_nn_fused4(qt, _same_index(ji), k_tiles=12, group=4, u_max=32,
                                          return_pos=True)
    assert pos.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ji.order)[to_np(pos)][valid], i_t[valid])
    sep = (np.abs(d_j - to_np(d_b)) < 1e-6) & valid  # rows whose union holds the exact NN
    assert (i_t[sep] == i_j[sep]).mean() > 0.999


def test_fused4_tie_rule_and_misses():
    """Exact duplicates across union slots: within a lane the earliest slot
    wins, across lanes the largest u * S + lane (the TPU kernel's epilogue,
    not fold6's lowest lane), here through a union padded with its smallest
    id. Equal to the Pallas kernel. A union of one all-sentinel tile misses
    (d = inf) onto its last lane."""
    query, _, fields = _sentinel_fixture()
    tiles = fields.tiles.copy()
    p, p2 = np.float32([1, 2, 3]), np.float32([-4, 5, -6])
    tiles[0] = np.arange(24, dtype=np.float32).reshape(8, 3) * 10.0 + 100.0
    tiles[0, 1] = tiles[1, 6] = p  # lowest lane: tile 0; largest u*S + lane: tile 1
    tiles[2, 2] = tiles[3, 2] = p2  # one lane: the earliest slot, tile 2
    tiles[1, 1] = 99.0
    fields = SimpleNamespace(tiles=tiles, box_lo=tiles.min(1), box_hi=tiles.max(1),
                             centroids=tiles.mean(1), order=fields.order)
    index = interop.tile_index_from_numpy(fields, device="cpu")
    qt = torch.as_tensor(query)
    d_t, pos_t = blocknn_cuda.block_nn_fused4(qt, index, k_tiles=4, group=1, u_max=8,
                                              return_pos=True)
    assert int(pos_t[0]) == 8 + 6 and int(pos_t[1]) == 16 + 2
    assert float(d_t[0]) == 0.0 and float(d_t[1]) == 0.0
    j_index = jb.TileIndex(**{f: jnp.asarray(v) for f, v in vars(fields).items()})
    d_j, pos_j = j_fused4(jnp.asarray(query), j_index, k_tiles=4, group=1, u_max=8,
                          return_pos=True, interpret=True)
    np.testing.assert_array_equal(to_np(pos_t), np.asarray(pos_j))
    np.testing.assert_allclose(to_np(d_t), np.asarray(d_j), rtol=1e-6)
    unions = blocknn_cuda.group_unions(torch.tensor([[4, 4, 4, 4]]), 1, 8)
    d_m, pos_m = blocknn_cuda.fused4_reference(qt, index.tiles, unions, 1)
    assert np.isinf(to_np(d_m)).all() and (to_np(pos_m) == 4 * 8 + 7).all()


def test_fused4_group_must_divide_query_tiles():
    _, jq, ji = _query_and_index(n=4096, seed=8)
    qt = torch.as_tensor(np.asarray(jq.tiles))[:6]
    with pytest.raises(ValueError, match="divisible"):
        blocknn_cuda.block_nn_fused4(qt, _same_index(ji), group=4)


# The fused4 kernel's shape (F4_SHAPE, torch_fixtures.py) with short chunks,
# so that a union's lanes span several chunks.
F4_SHORT = F4_SHAPE._replace(chunk_rows=32)


def _take(best, key, b, k):
    """The kernel's combine, vectorised: the smaller score, then the larger key."""
    better = (b < best) | ((b == best) & (k > key))
    return np.where(better, b, best), np.where(better, k, key)


def emulate_fused4(query_tiles, tiles, unions, group, shape):
    """csrc/blocknn.cu's fused4 in numpy, step for step: the union's slots
    before the first repeat of slot 0's id, streamed in chunks of whole
    lanes (`fused4_plan`); lane thread j of each quad scans lanes j, j +
    lane_threads, ... of a chunk, keeping each lane's least score (the
    earliest slot on a tie) and folding it into its (least score, largest
    key) state; the quad's threads then combine by shuffles at offsets 1,
    2, ...; the score is fma(-2, dot, rr), i.e. rr - 2 dot rounded once."""
    tq, sq, _ = query_tiles.shape
    s = tiles.shape[1]
    g, u_max = unions.shape
    gq = group * sq
    q = query_tiles.reshape(g, gq, 3)
    lt = shape.lane_threads
    d_out = np.empty(g * gq, np.float32)
    pos_out = np.empty(g * gq, np.int64)
    for gi in range(g):
        un = unions[gi]
        n_u = 1
        while n_u < u_max and un[n_u] != un[0]:
            n_u += 1
        lc = blocknn_cuda.fused4_plan(gq, s, n_u, shape)["lanes_per_chunk"]
        r = tiles[un[:n_u]]  # (n_u, S, 3)
        rr = (r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1]) + r[..., 2] * r[..., 2]
        qx, qy, qz = (q[gi, :, i][:, None] for i in range(3))
        best = np.full((lt, gq), np.inf, np.float32)
        key = np.zeros((lt, gq), np.int64)
        for l0 in range(0, s, lc):
            for j in range(lt):
                for lane in range(l0 + j, min(l0 + lc, s), lt):
                    rx, ry, rz = r[:, lane, 0], r[:, lane, 1], r[:, lane, 2]
                    dot = (qx * rx + qy * ry) + qz * rz  # (gq, n_u), each step rounded
                    sc = rr[:, lane] - np.float32(2.0) * dot
                    mu = sc.argmin(1)  # the first minimum: the earliest slot
                    best[j], key[j] = _take(best[j], key[j], sc.min(1), mu * s + lane)
        off = 1
        while off < lt:
            best, key = _take(best, key, best[np.arange(lt) ^ off], key[np.arange(lt) ^ off])
            off *= 2
        assert (best == best[0]).all() and (key == key[0]).all()  # every thread agrees
        qq = (qx[:, 0] * qx[:, 0] + qy[:, 0] * qy[:, 0]) + qz[:, 0] * qz[:, 0]
        dd = np.maximum(best[0] + qq, np.float32(0.0))
        d_out[gi * gq:(gi + 1) * gq] = np.where(dd < 1e15, dd, np.inf)
        pos_out[gi * gq:(gi + 1) * gq] = un[key[0] // s].astype(np.int64) * s + key[0] % s
    return d_out, pos_out


@pytest.mark.parametrize("shape", [F4_SHAPE, F4_SHORT], ids=["kernel", "short chunks"])
@pytest.mark.parametrize("name", ["lanes and slots", "all sentinel", "random"])
def test_emulated_fused4_lane_split_equals_reference(name, shape):
    """The kernel's lane split, chunking and combine give the plain
    version's d2 and position bit for bit on the tie fixtures (the same
    row in several lanes and slots, padded unions, an all-sentinel union)
    and on a random case, with the kernel's chunks and with chunks of 32
    rows (several a union)."""
    if name == "random":
        rng = np.random.default_rng(34)
        tiles = rng.uniform(-1, 1, (40, 32, 3)).astype(np.float32)
        query = rng.uniform(-1, 1, (16, 8, 3)).astype(np.float32)
        cand = torch.as_tensor(rng.integers(0, 40, (16, 6)))
        group, want = 4, None
        # short chunks hold 4 lanes of at most 8 slots: overflowing unions there
        unions = blocknn_cuda.group_unions(cand, group, 32 if shape == F4_SHAPE else 8)
    else:
        query, tiles, unions, group, want = _fused4_tie_case(name)
    assert unions.dtype == torch.int32  # made int32 once, where the unions are made
    d_e, pos_e = emulate_fused4(query, tiles, to_np(unions), group, shape)
    d_p, pos_p = blocknn_cuda.fused4_reference(torch.as_tensor(query), torch.as_tensor(tiles),
                                               unions, group)
    np.testing.assert_array_equal(d_e.view(np.int32), to_np(d_p).view(np.int32))
    np.testing.assert_array_equal(pos_e, to_np(pos_p))
    if want is not None:
        assert int(pos_p[0]) == want and float(d_p[0]) == 1.0
    if name == "all sentinel":  # the second group: every lane ties, the last lane wins
        real = slice(16, 29)  # its rows but the padded ones (PAD_COORD against PAD_COORD: d 0)
        assert np.isinf(d_e[real]).all() and (pos_e[real] == 4 * 32 + 31).all()


@pytest.mark.parametrize("gq,s,n_u,want", [
    (256, 128, 11, (1, 44, 3)),  # the flagship's refine: groups of 4 tiles of 64
    (256, 128, 23, (1, 20, 7)),  # its largest union
    (256, 128, 1, (1, 128, 1)),  # one slot: the whole union in one chunk
    (512, 128, 128, (2, 4, 32)),  # the longest union: 4 lanes a chunk
    (8, 8, 4, (1, 8, 1)),  # chip_smoke's fixtures
])
def test_fused4_plan_of_the_kernel_shape(gq, s, n_u, want):
    plan = blocknn_cuda.fused4_plan(gq, s, n_u, F4_SHAPE)
    assert (plan["query_blocks"], plan["lanes_per_chunk"], plan["chunks"]) == want
    assert plan["max_union"] == 128 and n_u * plan["lanes_per_chunk"] <= F4_SHAPE.chunk_rows


def test_select_takes_candidates_converted_once():
    """The registration converts the frozen candidates to int32 once a
    phase; the selected rows are the same as from the int64 list."""
    jq, ji, table, cand = _fold_case(seed=17)
    ti = _same_index(ji)
    cand64 = torch.as_tensor(cand).to(torch.int64)
    _, pos = tb.block_nn(torch.as_tensor(np.asarray(jq.tiles)), ti, return_pos=True,
                         cand_tiles=cand64)
    pos = pos.reshape(jq.n_tiles, jq.tile_size)
    pl_tiles = torch.as_tensor(table.reshape(ji.n_tiles, ji.tile_size, 6))
    once = blocknn_cuda.payload_select_fused(pos, cand64.to(torch.int32).contiguous(), pl_tiles)
    every = blocknn_cuda.payload_select_fused(pos, cand64, pl_tiles)
    assert torch.equal(once, every)
    np.testing.assert_array_equal(to_np(once), table[to_np(pos).reshape(-1)])


# ---- the union radius moments (kernel #7) -------------------------------------------


@pytest.fixture(scope="module")
def union_moments_case():
    """tests/test_blocknn.py::test_fused_moments_superset_of_jnp's case: 8,000
    uniform points (the conftest rng's first draw), tiles of 128, radius
    0.15, k_tiles 8, group 4, u_max 32; the Pallas kernel's output in
    interpret mode and the port's plain version's."""
    r = np.random.default_rng(0).uniform(-1, 1, (8000, 3)).astype(np.float32)
    ji = jb.build_kd_index(jnp.asarray(r), tile_size=128)
    want = j_moments_fused(ji.tiles, ji, jnp.float32(RADIUS_U), k_tiles=8, group=4, u_max=32,
                           interpret=True)
    ti = _same_index(ji)
    before = dict(profiling.LAUNCHES)
    got = blocknn_cuda.block_radius_moments_fused(ti.tiles, ti, RADIUS_U, k_tiles=8, group=4,
                                                  u_max=32)
    assert profiling.LAUNCHES == before  # CPU tensors: the plain version ran
    return r, ji, ti, want, got


def _comps(cov):
    return [cov[:, i, j] for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]


def test_moments_fused_plain_matches_pallas_interpret(union_moments_case):
    """Counts equal on >= 99.9% of rows (the two sides round the expansion
    score in their own orders: a radius-border row may flip), means and
    covariances on equal-count rows within `_cov_tol` about the group
    centroid."""
    _, ji, ti, (cnt_j, mean_j, cov_j), (cnt_t, mean_t, cov_t) = union_moments_case
    valid = np.asarray(ji.order) >= 0
    q_cent = to_np(blocknn_cuda.group_centroids(ti.tiles, 4))
    _check_moments(cnt_t, mean_t, _comps(cov_t), cnt_j, mean_j, _comps(np.asarray(cov_j)), valid, ji,
                   centred=(q_cent, 4 * ji.tile_size))


def test_moments_fused_counts_padded_slots_again(union_moments_case):
    """A fault of the reference, kept: the TPU kernel sums every one of the
    u_max union slots, and `group_unions` pads an underfull union with its
    first id, so that tile's rows count once more for each padded slot. On
    this case 458 of the 8,000 rows count more neighbours than the cloud
    holds within the radius (float64 brute force), by up to 224; the port
    gives the same rows the same counts, but for two rows where the
    packages' fp32 scores put one neighbour on either side of the radius
    (456 rows over). The plain XLA-style fold never exceeds the brute
    count."""
    r, ji, ti, (cnt_j, *_), (cnt_t, *_) = union_moments_case
    valid = np.asarray(ji.order) >= 0
    q = np.asarray(ji.tiles, np.float64).reshape(-1, 3)[valid]
    pts = r.astype(np.float64)
    brute = np.concatenate([(((q[i:i + 1000, None] - pts[None]) ** 2).sum(-1) <= RADIUS_U ** 2).sum(1)
                            for i in range(0, len(q), 1000)])
    cnt_t, cnt_j = to_np(cnt_t)[valid], np.asarray(cnt_j)[valid]
    over_t, over_j = cnt_t > brute, cnt_j > brute
    same = cnt_t == cnt_j  # all but 2 rows, each a radius-border flip of 1
    assert (~same).sum() == 2 and (np.abs(cnt_t - cnt_j) <= 1).all()
    np.testing.assert_array_equal(over_t[same], over_j[same])
    assert int(over_j.sum()) == 458 and int(over_t.sum()) == 456  # the 2 flipped rows
    assert int((cnt_j - brute).max()) == int((cnt_t - brute).max()) == 224
    cnt_x, _, _ = tb.block_radius_moments(ti.tiles, ti, RADIUS_U, k_tiles=8)
    assert (to_np(cnt_x)[valid] <= brute).all()
    assert (cnt_t >= to_np(cnt_x)[valid]).all()  # the union holds every tile's candidates


def test_moments_fused_slot_weights_equal_summing_every_slot():
    """The plain version (and the kernel) score slot 0's tile once and weigh
    it by 1 + the padded slots; summing every slot as the TPU kernel does
    gives the same counts and, to fp32, the same sums, sentinel rows (in
    tile 7) and padded queries included."""
    query, tiles, unions = _slot_weights_fixture()
    np.testing.assert_array_equal(to_np(blocknn_cuda._slot_weights(unions)),
                                  [[6, 1, 1, 0, 0, 0, 0, 0], [1] * 8])
    qt = torch.as_tensor(query)
    q_cent = blocknn_cuda.group_centroids(qt, 4)
    r2 = torch.tensor(0.6, dtype=torch.float32)
    out = to_np(blocknn_cuda.moments_fused(qt, torch.as_tensor(tiles), unions, q_cent, r2, 4))
    # the TPU kernel's loop, every slot, the same score order, in numpy fp32
    qc = query.reshape(2, 64, 3) - to_np(q_cent)[:, None]
    c = (qc[..., 0] * qc[..., 0] + qc[..., 1] * qc[..., 1]) + qc[..., 2] * qc[..., 2] - np.float32(0.6)
    want = np.zeros((2, 64, 10), np.float64)
    for u in range(8):
        rc = tiles[to_np(unions)[:, u]] - to_np(q_cent)[:, None]  # (2, 16, 3)
        x, y, z = rc[..., 0][:, None], rc[..., 1][:, None], rc[..., 2][:, None]
        rr = (x * x + y * y) + z * z
        score = (((-2 * qc[..., 0:1]) * x + (-2 * qc[..., 1:2]) * y) + (-2 * qc[..., 2:3]) * z + rr) + c[..., None]
        w = (score <= 0).astype(np.float64)
        feat = np.stack([np.ones_like(x), x, y, z, x * x, y * y, z * z, x * y, x * z, y * z], -1)
        want += (w[..., None] * feat).sum(2)
    want = want.reshape(-1, 10).T
    np.testing.assert_array_equal(out[0], want[0])
    counts = out[0].reshape(8, 16)
    # a padded query sits on the sentinel rows (both at PAD_COORD): it counts
    # tile 7's six, as the TPU kernel's score does; its row is dropped later
    assert (counts[5, 12:] == 6).all() and (counts > 0).mean() > 0.9
    np.testing.assert_allclose(out[1:], want[1:], rtol=1e-5, atol=1e-5)


# The moments_fused kernel's shape (MF_SHAPE, torch_fixtures.py) with chunks
# of 32 rows (unions of up to 8 slots), so that a union's lanes span several
# chunks.
MF_SHORT = MF_SHAPE._replace(chunk_rows=32)


def emulate_moments_fused(query_tiles, tiles, unions, q_cent, r2, group, shape):
    """csrc/blocknn.cu's moments_fused in numpy fp32, step for step: the
    union's slots before the first repeat of slot 0's id, centred on the
    group's q_cent and streamed in chunks of whole lanes (`fused4_plan`);
    lane thread j of each quad scans lanes j, j + lane_threads, ... of a
    chunk, in each lane slot 0 first, weighted u_max - n_u + 1, then slots
    1 .. n_u - 1; a row counts for a query when s1 <= -c, s1 = ((ax rx +
    ay ry) + az rz) + rr; each thread sums its hits' features in that order;
    thread k of the quad then holds query k as (P[k] + P[k ^ 2]) + (P[k ^ 1]
    + P[k ^ 3]). The kernel forms a weighted slot-0 term by one FMA; here
    w * f is rounded first (sums within tolerance, counts exact)."""
    tq, sq, _ = query_tiles.shape
    s = tiles.shape[1]
    g, u_max = unions.shape
    gq = group * sq
    lt = shape.lane_threads
    assert lt == shape.queries_per_thread == 4  # the kernel's two shuffle rounds
    q = query_tiles.reshape(g, gq, 3)
    out = np.empty((10, g * gq), np.float32)
    r2 = np.float32(r2)
    for gi in range(g):
        un = unions[gi]
        n_u = 1
        while n_u < u_max and un[n_u] != un[0]:
            n_u += 1
        lc = blocknn_cuda.fused4_plan(gq, s, n_u, shape)["lanes_per_chunk"]
        r = tiles[un[:n_u]] - q_cent[gi]  # (n_u, S, 3), centred once a chunk in the kernel
        x, y, z = r[..., 0], r[..., 1], r[..., 2]
        rr = (x * x + y * y) + z * z
        feat = np.stack([np.ones_like(x), x, y, z, x * x, y * y, z * z, x * y, x * z, y * z], -1)
        qc = q[gi] - q_cent[gi]
        qx, qy, qz = qc[:, 0:1], qc[:, 1:2], qc[:, 2:3]
        nc = -(((qx * qx + qy * qy) + qz * qz) - r2)
        mult0 = np.float32(u_max - n_u + 1)
        part = np.zeros((lt, gq, 10), np.float32)
        for l0 in range(0, s, lc):
            for j in range(lt):
                lanes = np.arange(l0 + j, min(l0 + lc, s), lt)
                us = np.tile(np.arange(n_u), len(lanes))  # per lane: slot 0, then 1 .. n_u - 1
                ls = np.repeat(lanes, n_u)
                s1 = (((np.float32(-2) * qx) * x[us, ls] + (np.float32(-2) * qy) * y[us, ls])
                      + (np.float32(-2) * qz) * z[us, ls]) + rr[us, ls]  # (gq, rows)
                w = np.where(us == 0, mult0, np.float32(1))[:, None] * feat[us, ls]
                terms = np.where((s1 <= nc)[..., None], w[None], np.float32(0))
                part[j] = np.add.accumulate(np.concatenate([part[j][:, None], terms], 1), 1)[:, -1]
        k = np.arange(gq) % lt  # query i is query k of its quad: thread k keeps it
        i = np.arange(gq)
        out[:, gi * gq:(gi + 1) * gq] = ((part[k, i] + part[k ^ 2, i])
                                         + (part[k ^ 1, i] + part[k ^ 3, i])).T
    return out


def _check_emulated_moments(out_e, out_p, q_cent, gq, valid):
    """Counts bit-equal on every row; on the valid rows means within 1e-5
    and covariances within `_cov_tol` about the group centroid."""
    np.testing.assert_array_equal(out_e[0], to_np(out_p[0]))
    (_, mean_e, cov_e), (_, mean_p, cov_p) = (
        blocknn_cuda.finish_union_moments(torch.as_tensor(o), torch.as_tensor(q_cent), gq)
        for o in (out_e, out_p))
    np.testing.assert_allclose(to_np(mean_e)[valid], to_np(mean_p)[valid], rtol=0, atol=1e-5)
    tol = _cov_tol(to_np(mean_p), _comps(to_np(cov_p)), q_cent, gq)[valid]
    for ce, cp in zip(_comps(to_np(cov_e)), _comps(to_np(cov_p))):
        err = np.abs(ce[valid].astype(np.float64) - cp[valid])
        assert (err <= tol).all(), float(np.max(err - tol))


@pytest.mark.parametrize("u_max,shape", [
    (32, MF_SHAPE), (8, MF_SHAPE), (128, MF_SHAPE), (32, MF_SHAPE._replace(chunk_rows=128)),
], ids=["u_max 32", "u_max 8", "largest union", "short chunks"])
def test_emulated_moments_fused_equals_reference(union_moments_case, u_max, shape):
    """The kernel's chunks, lane split, peeled slot 0, s1 <= -c compare and
    shuffle combine give the plain version's counts bit for bit, and its
    moments within tolerance, on `union_moments_case`'s 8,000 points at
    u_max 32, at 8 (overflowing unions) and at the kernel's largest union
    (every union padded, slot 0 weighted ~100 times); and with chunks of
    128 rows (a union of 15 slots in 16 chunks of 8 lanes)."""
    _, ji, ti, *_ = union_moments_case
    assert u_max <= blocknn_cuda.fused4_plan(512, 128, 1, shape)["max_union"]
    cand, _ = tb._candidate_tiles(ti.tiles, ti, 8)
    unions = blocknn_cuda.group_unions(cand, 4, u_max)
    q_cent = blocknn_cuda.group_centroids(ti.tiles, 4)
    r2 = torch.tensor(RADIUS_U * RADIUS_U, dtype=torch.float32)
    out_p = blocknn_cuda.moments_fused_reference(ti.tiles, ti.tiles, unions, q_cent, r2, 4)
    out_e = emulate_moments_fused(to_np(ti.tiles), to_np(ti.tiles), to_np(unions), to_np(q_cent),
                                  float(r2), 4, shape)
    assert float(out_p[0].max()) > u_max - 32  # slot 0's weight shows in the counts
    _check_emulated_moments(out_e, out_p, to_np(q_cent), 4 * ti.tile_size, np.asarray(ji.order) >= 0)


@pytest.mark.parametrize("shape", [MF_SHAPE, MF_SHORT], ids=["kernel", "short chunks"])
def test_emulated_moments_fused_slot_weights_fixture(shape):
    """The same on the slot-weights fixture: a padded union (slot 0 weighted
    6), sentinel rows in tile 7 and padded queries, which count tile 7's six
    sentinel rows as the plain version does (their rows are dropped later);
    with short chunks each union spans 4 chunks of 4 lanes."""
    query, tiles, unions = _slot_weights_fixture()
    q_cent = blocknn_cuda.group_centroids(torch.as_tensor(query), 4)
    r2 = torch.tensor(0.6, dtype=torch.float32)
    out_p = blocknn_cuda.moments_fused_reference(torch.as_tensor(query), torch.as_tensor(tiles),
                                                 unions, q_cent, r2, 4)
    out_e = emulate_moments_fused(query, tiles, to_np(unions), to_np(q_cent), 0.6, 4, shape)
    valid = (np.abs(query) < 1e6).all(-1).reshape(-1)
    assert (~valid).sum() == 4 and (out_e[0][~valid] == 6).all()
    _check_emulated_moments(out_e, out_p, to_np(q_cent), 64, valid)


def test_moments_fused_compare_without_the_last_add():
    """The kernel tests s1 <= -c where the plain version tests
    round(s1 + c) <= 0: the same verdict for every pair of fp32 values
    (rounding to nearest is monotone, and a nonzero sum never rounds to 0
    without flush-to-zero), here at radius-border values: exact zeros of
    both signs, exact cancellations, neighbours of a cancellation a few ulps
    apart, subnormals and sums that cancel to one ulp of a large value."""
    rng = np.random.default_rng(40)
    c = np.concatenate([rng.uniform(-1, 1, 2000), rng.uniform(-1e3, 1e3, 2000),
                        [0.0, -0.0, 1e-45, -1e-45, 1e-38, -1e-38, 3e16, -3e16]]).astype(np.float32)
    s1 = [-c, -c + np.float32(0), c, np.zeros_like(c), -np.zeros_like(c)]
    for steps in (1, 2, 3):  # a few ulps either side of the cancellation
        s1 += [np.nextafter(-c, np.float32(np.inf)), np.nextafter(-c, np.float32(-np.inf))]
        for _ in range(steps - 1):
            s1[-2], s1[-1] = (np.nextafter(s1[-2], np.float32(np.inf)),
                              np.nextafter(s1[-1], np.float32(-np.inf)))
    s1 += [(-c + rng.uniform(-1e-6, 1e-6, c.shape).astype(np.float32)).astype(np.float32)]
    s1 = np.concatenate(s1).astype(np.float32)
    cc = np.tile(c, len(s1) // len(c))
    assert s1.dtype == cc.dtype == np.float32
    with np.errstate(over="ignore"):
        rounded = (s1 + cc) <= np.float32(0)  # fp32 add, rounded to nearest
    assert ((s1 + cc) == 0).sum() > 4000 and rounded.any() and not rounded.all()
    np.testing.assert_array_equal(s1 <= -cc, rounded)


@pytest.mark.parametrize("gq,s,n_u,want", [
    (512, 128, 15, (2, 32, 4)),  # the 1M covariance index: unions of 15.4 tiles on average
    (512, 128, 30, (2, 16, 8)),  # its largest union
    (512, 128, 32, (2, 16, 8)),  # a full union of u_max 32
    (512, 128, 1, (2, 128, 1)),  # one slot: the whole union in one chunk
    (512, 128, 128, (2, 4, 32)),  # the longest union: 4 lanes a chunk
    (64, 16, 3, (1, 16, 1)),  # the slot-weights fixture
])
def test_moments_fused_plan_of_the_kernel_shape(gq, s, n_u, want):
    plan = blocknn_cuda.fused4_plan(gq, s, n_u, MF_SHAPE)
    assert (plan["query_blocks"], plan["lanes_per_chunk"], plan["chunks"]) == want
    assert plan["max_union"] == 128 and n_u * plan["lanes_per_chunk"] <= MF_SHAPE.chunk_rows


# ---- radius, normals ---------------------------------------------------------------


@pytest.mark.parametrize("n,masked", [(4096, 0.0), (5000, 0.3)])
def test_auto_cell_size_matches_jax(n, masked):
    """n = 4096: a 1,024-point sample, an even count whose median is the mean
    of the two middle spacings (jnp.nanmedian; torch.nanmedian would take
    the lower one); n = 5000 with masked rows: a ragged valid count."""
    x, m = _cloud(n, seed=n, masked_frac=masked, surface=True)
    want = float(j_auto_cell_size(jnp.asarray(x), jnp.asarray(m), scale=3.0))
    got = float(auto_cell_size(torch.as_tensor(x), torch.as_tensor(m), scale=3.0))
    assert abs(got - want) <= 1e-6 * want


def test_block_normals_match_jax():
    """|n . n'| > 0.99 on at least 99.9% of the rows that have a normal, and
    the same rows without one (fewer than 3 points in the radius) on at
    least 99.9% (radius-border flips aside, the same neighbourhoods and
    eigensolver)."""
    jc, tc = clouds(synthetic_surface(20000, seed=14))
    jn = np.asarray(j_estimate_normals(jc, k=10, method="block").normals)
    tn = to_np(estimate_normals(tc, k=10, method="block").normals)
    has = np.linalg.norm(jn, axis=1) > 0  # < 3 points in radius: no normal
    assert ((np.linalg.norm(tn, axis=1) > 0) == has).mean() >= 0.999
    dots = np.abs(np.sum(jn * tn, axis=1))[has]
    assert (dots > 0.99).mean() >= 0.999, float((dots > 0.99).mean())
    assert (tn[~np.asarray(jc.mask)] == 0).all()

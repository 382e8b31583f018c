"""The port's CUDA kernels on the card, each against its plain PyTorch version.

Every test here needs an NVIDIA GPU and skips without one. The file
imports nothing of JAX, of the JAX package or of `tests/torch_parity.py`,
so it runs where the card is, without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Inputs are made with numpy from a seed, or with the port's own builders
(`build_kd_index`, `trim_index`, `_candidate_tiles`, `fused_payload_table`,
`auto_cell_size`) on the card. The comparisons are the kernel against its
plain version on the same card tensors: bit for bit, but for the moments
kernels, whose counts are bit for bit and whose sums are held to
tolerances stated at each test.

The fixtures, the fixture lists and the copies of the kernels' shapes are
`torch_fixtures.py`'s, which the CPU tests share.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import icpx_torch.kernels.blocknn as tb
from icpx_torch import interop
from icpx_torch.io.loaders import synthetic_surface
from icpx_torch.kernels import blocknn_cuda, nn_cuda, sort_cuda
from icpx_torch.kernels.blocknn_cuda import fold6_prepare, fold6_reference, moments6_reference
from icpx_torch.kernels.knn import nearest_neighbor_reference
from icpx_torch.kernels.sort_cuda import sort_segments_reference
from icpx_torch.kernels.voxel import auto_cell_size
from torch_fixtures import (CSRC_SHAPE, F4_SHAPE, F6_FIXTURE_SHAPES, F6_FIXTURES, F6_SHAPE,
                            F7_FIXTURES, F7_SHAPE, M6_FIXTURE_SHAPES, M6_FIXTURES, M6_SHAPE,
                            MF_SHAPE, RADIUS_U, SCREEN_FIXTURES, SORT_SHAPE, _cov_tol,
                            _fused4_tie_case, _nn_inputs, _slot_weights_fixture, _sort_keys,
                            _table_view, _tie_fixture, duplicate_fixture, screen_fixture)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# ---- inputs built on the card by the port's own index builders -------------------------


def _moments_case(device):
    """A 1M-style self query at test size: the KD index of a 12,000-point
    surface cloud in tiles of 128, each tile its own query tile, k_tiles =
    2, the registration's radius (auto_cell_size at scale 3)."""
    ti = tb.build_kd_index(torch.as_tensor(synthetic_surface(12000, seed=10), device=device),
                           tile_size=128)
    radius = float(auto_cell_size(ti.tiles.reshape(-1, 3), ti.order >= 0, scale=3.0))
    return ti, radius


def _fold_case(seed, device):
    """Refine-regime queries (near-aligned) against a target KD index, with
    frozen candidates and a fused [xyz || normal-like] payload table:
    (query index, target index, table (4096, 6), cand (Tq, 6))."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    q = (r[rng.permutation(4096)[:3000]] + rng.normal(0, 0.003, (3000, 3))).astype(np.float32)
    ti = tb.build_kd_index(torch.as_tensor(r, device=device), tile_size=128)
    tq = tb.trim_index(tb.build_kd_index(torch.as_tensor(q, device=device), tile_size=64), 3000,
                       multiple=4)
    aux = rng.normal(size=(4096, 3)).astype(np.float32)
    table = tb.fused_payload_table(ti, torch.as_tensor(aux, device=device))
    cand, _ = tb._candidate_tiles(tq.tiles, ti, 6)
    return tq, ti, table, cand


# ---- kernel #1: the brute 1-NN --------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize(
    "nq,nr,masked_frac", [(3456, 3456, 0.0), (1000, 70001, 0.5), (4099, 5000, 1.0)]
)
def test_cuda_kernel_matches_plain(cuda_device, nq, nr, masked_frac):
    q, r, mask = _nn_inputs(nq, nr, seed=nq, masked_frac=masked_frac)
    qc, rc, mc = (torch.as_tensor(x, device=cuda_device) for x in (q, r, mask))
    d_k, i_k = nn_cuda.nn_cuda(qc, rc, mc)
    d_p, i_p = nearest_neighbor_reference(qc, rc, ref_mask=mc)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)  # bit for bit
    if masked_frac == 1.0:
        assert (i_k == 0).all() and torch.isinf(d_k).all()
    for name in SCREEN_FIXTURES:
        q, r, mask = (torch.as_tensor(x, device=cuda_device) for x in screen_fixture(name))
        d_k, i_k = nn_cuda.nn_cuda(q, r, mask)
        d_p, i_p = nearest_neighbor_reference(q, r, ref_mask=mask)
        assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p), name
    qd, rd, expect = duplicate_fixture()
    _, i_d = nn_cuda.nn_cuda(torch.as_tensor(qd, device=cuda_device),
                             torch.as_tensor(rd, device=cuda_device))
    np.testing.assert_array_equal(_np(i_d), expect)


@pytest.mark.cuda
def test_cuda_library_shape_and_scratch_check(cuda_device):
    """The built library reports the shape the plan tests assume, and
    refuses a scratch smaller than its own layout."""
    assert nn_cuda.kernel_shape() == CSRC_SHAPE
    lib = nn_cuda.build()
    q = torch.zeros((10, 3), device=cuda_device)
    need = lib.icpx_nn_scratch_bytes(10, 10)
    scratch = torch.empty((need,), dtype=torch.uint8, device=cuda_device)
    d = torch.empty((10,), device=cuda_device)
    i = torch.empty((10,), dtype=torch.int32, device=cuda_device)
    rc = lib.icpx_nn_forward(q.data_ptr(), q.data_ptr(), None, 10, 10, scratch.data_ptr(),
                             need - 1, 1, d.data_ptr(), i.data_ptr(), q.device.index,
                             torch.cuda.current_stream(cuda_device).cuda_stream)
    assert rc != 0


# ---- kernel #8: the segmented sort ------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("c,m", [(3, 2), (64, 128), (4, 16384), (2, 65536), (64, 16384),
                                 (256, 4096), (1024, 1024), (4096, 256), (8192, 128),
                                 (16, 65536)])
def test_cuda_sort_matches_plain(cuda_device, c, m):
    """Every level shape of the 1M flagship's KD builds among them."""
    key, a, _, o = _sort_keys(c, m, seed=7)
    args = [torch.as_tensor(x, device=cuda_device) for x in (key, a, o)]
    xyz = torch.randn((c, m, 3), device=cuda_device)
    before = sort_cuda.LAUNCHES["sort"]
    got = sort_cuda.sort_cuda(args[0], [args[1], args[2], xyz])
    want = sort_segments_reference(args[0], [args[1], args[2], xyz])
    torch.cuda.synchronize()
    assert sort_cuda.LAUNCHES["sort"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                           w.view(torch.int32) if w.dtype == torch.float32 else w)


@pytest.mark.cuda
def test_cuda_sort_library_shape(cuda_device):
    """The built library reports the shape the plan tests assume."""
    assert sort_cuda.kernel_shape() == SORT_SHAPE


# ---- kernel #2: the radius moments ------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_moments6_matches_plain(cuda_device):
    ti, radius = _moments_case(cuda_device)
    cand, q_cent = tb._candidate_tiles(ti.tiles, ti, 2)
    r2 = torch.tensor(radius * radius, device=cuda_device)
    before = blocknn_cuda.LAUNCHES["moments6"]
    out_k = blocknn_cuda.moments6_cuda(ti.tiles, ti.tiles, cand.to(torch.int32), q_cent, r2.reshape(1))
    out_p = moments6_reference(ti.tiles, ti.tiles, cand, q_cent, r2)
    torch.cuda.synchronize()
    assert blocknn_cuda.LAUNCHES["moments6"] == before + 1
    assert torch.equal(out_k[0], out_p[0])  # the same d2 bits: the same counts
    assert torch.isfinite(out_k).all()
    torch.testing.assert_close(out_k[1:4], out_p[1:4], rtol=0, atol=1e-5)
    k_np, p_np = _np(out_k).astype(np.float64), _np(out_p)
    tol = _cov_tol(p_np[1:4].T, p_np[4:], _np(q_cent), ti.tile_size)
    assert (np.abs(k_np[4:] - p_np[4:]) <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", M6_FIXTURES)
@pytest.mark.parametrize("tq,sq,s,k", list(M6_FIXTURE_SHAPES.values()), ids=list(M6_FIXTURE_SHAPES))
def test_cuda_moments6_fixtures_match_plain(cuda_device, name, tq, sq, s, k):
    """The kernel on each moments6 fixture at each of chip_smoke's shapes
    (every kind of plan: k = 8, a tile over two blocks, Sq not a multiple of
    4, S padded to a mask word; rows on and within an ulp of the radius,
    exact ties, sentinel rows, pad, missing and far queries, a wide band):
    counts equal to moments6_reference's on every row, rows that count
    nothing equal outright, means within 1e-5, covariances within
    `_cov_tol`."""
    query, tiles, cand, q_cent, r2 = chip_smoke.moments6_fixture(name, tq, sq, s, k,
                                                                 n_tiles=max(12, k + 2),
                                                                 device=cuda_device)
    before = blocknn_cuda.LAUNCHES["moments6"]
    out_k = blocknn_cuda.moments6_cuda(query, tiles, cand.to(torch.int32), q_cent, r2.reshape(1))
    out_p = moments6_reference(query, tiles, cand, q_cent, r2)
    torch.cuda.synchronize()
    assert blocknn_cuda.LAUNCHES["moments6"] == before + 1
    assert torch.equal(out_k[0], out_p[0])
    none = out_p[0] == 0
    assert torch.equal(out_k[:, none], out_p[:, none])
    torch.testing.assert_close(out_k[1:4], out_p[1:4], rtol=0, atol=1e-5)
    k_np, p_np = _np(out_k).astype(np.float64), _np(out_p)
    tol = _cov_tol(p_np[1:4].T, p_np[4:], _np(q_cent), sq)
    assert (np.abs(k_np[4:] - p_np[4:]) <= tol).all()


@pytest.mark.cuda
def test_cuda_moments6_library_shape(cuda_device):
    """The built library reports the shape the plan and emulation tests
    assume."""
    assert blocknn_cuda.moments6_shape() == M6_SHAPE


# ---- kernel #3: the frozen-candidate fold -------------------------------------------------------


@pytest.mark.cuda
def test_cuda_fold6_matches_plain(cuda_device):
    tq, ti, table, cand = _fold_case(12, cuda_device)
    ops = fold6_prepare(cand, ti, table)
    d_k, pl_k = blocknn_cuda.fold6_cuda(tq.tiles, ops)
    d_p, pl_p = fold6_reference(tq.tiles, ops)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_p) and torch.equal(pl_k, pl_p)  # bit for bit
    query, payload, fields = _tie_fixture()
    index = interop.tile_index_from_numpy(fields, device=cuda_device)
    ops = fold6_prepare(torch.tensor([[0, 1, 2, 3]], device=cuda_device), index,
                        torch.as_tensor(payload, device=cuda_device))
    _, pl = blocknn_cuda.fold6_cuda(torch.as_tensor(query, device=cuda_device), ops)
    assert float(pl[0, 0]) == 9 and float(pl[1, 0]) == 18


@pytest.mark.cuda
def test_cuda_fold6_library_shape(cuda_device):
    """The built library reports the shape the plan and emulation tests
    assume."""
    assert blocknn_cuda.fold6_shape() == F6_SHAPE


@pytest.mark.cuda
@pytest.mark.parametrize("name", F6_FIXTURES)
@pytest.mark.parametrize("tq,sq,s,k", list(F6_FIXTURE_SHAPES.values()), ids=list(F6_FIXTURE_SHAPES))
def test_cuda_fold6_fixtures_match_plain(cuda_device, name, tq, sq, s, k):
    """The kernel on each screen fixture at each of chip_smoke's shapes
    (among them a tile over two blocks with S over two stages, and whole
    blocks), d2 bits and payload equal to fold6_reference's."""
    query, index, cand, payload = chip_smoke.fold6_fixture(name, tq, sq, s, k, n_tiles=max(12, k + 2),
                                                           device=cuda_device)
    ops = fold6_prepare(cand, index, payload)
    before = blocknn_cuda.LAUNCHES["fold6"]
    d_k, pl_k = blocknn_cuda.fold6_cuda(query, ops)
    d_p, pl_p = fold6_reference(query, ops)
    torch.cuda.synchronize()
    assert blocknn_cuda.LAUNCHES["fold6"] == before + 1
    assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32)) and torch.equal(pl_k, pl_p)


# ---- kernel #4: the bf16-scored fold -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [("fold case", None)] + [
    (name, shape) for shape in chip_smoke.FOLD7_FIXTURE_SHAPES for name in F7_FIXTURES])
def test_cuda_fold7_matches_plain(cuda_device, name, shape):
    """The kernel on the fold case of seed 18 and on each fold7 fixture at
    each of chip_smoke's shapes, which reach every kind of plan (S over
    stages, k x S above 3,072, Sq not a multiple of 4, a block not full, a
    tile over two blocks, k capping a block; ties, all-sentinel tiles, pad
    queries, subnormal products): d2 bits and payload equal to
    fold7_reference's."""
    if shape is None:
        tq, index, payload, cand = _fold_case(18, cuda_device)
        query = tq.tiles
        q_cent = tb._candidate_tiles(query, index, 6)[1]
    else:
        query, index, cand, q_cent, payload = chip_smoke.fold7_fixture(
            name, *shape, n_tiles=max(12, shape[3] + 2), device=cuda_device)
    ops = blocknn_cuda.fold7_prepare(cand, q_cent, index, payload)
    before = blocknn_cuda.LAUNCHES["fold7"]
    d_k, pl_k = blocknn_cuda.fold7_cuda(query, ops)
    d_p, pl_p = blocknn_cuda.fold7_reference(query, ops)
    torch.cuda.synchronize()
    assert blocknn_cuda.LAUNCHES["fold7"] == before + 1
    assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32)) and torch.equal(pl_k, pl_p)


@pytest.mark.cuda
def test_cuda_fold7_library_shape(cuda_device):
    """The built library reports the shape the plan and emulation tests
    assume."""
    assert blocknn_cuda.fold7_shape() == F7_SHAPE


# ---- kernel #5: payload selection ---------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_select_matches_plain(cuda_device):
    tq, ti, pl, cand_t = _fold_case(17, cuda_device)
    _, pos = tb.block_nn(tq.tiles, ti, return_pos=True, cand_tiles=cand_t)
    pos = pos.reshape(tq.n_tiles, tq.tile_size)
    out_k = blocknn_cuda.select_cuda(pos, cand_t.to(torch.int32), pl, ti.tile_size)
    out_p = blocknn_cuda.select_reference(pos, cand_t, pl, ti.tile_size)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p) and torch.equal(out_k, pl[pos.reshape(-1).long()])
    dup = torch.tensor([[1, 1, 2, 3]], dtype=torch.int32, device=cuda_device)
    p4 = torch.tensor([[9, 3, 17, 30]], dtype=torch.int32, device=cuda_device)
    torch.testing.assert_close(blocknn_cuda.select_cuda(p4, dup, pl, ti.tile_size),
                               blocknn_cuda.select_reference(p4, dup, pl, ti.tile_size),
                               rtol=0, atol=0)
    # every chunk width: D = 12 (float4), 7 (scalar), and a view 4 bytes off
    # 16-byte alignment (scalar)
    for d, offset, width in ((12, 0, 4), (7, 0, 1), (12, 1, 1)):
        wide = _table_view(pl.shape[0], d, offset, cuda_device)
        assert blocknn_cuda.select_width(wide) == width
        for pp, c in ((pos, cand_t.to(torch.int32)), (p4, torch.cat([dup, dup[:, :2]], 1))):
            got = blocknn_cuda.select_cuda(pp, c, wide, ti.tile_size)
            assert torch.equal(got, blocknn_cuda.select_reference(pp, c, wide, ti.tile_size)), (d, offset)


# ---- kernel #6: the fused union fold ------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_fused4_matches_plain(cuda_device):
    """Query tiles of 32 (k 12) and the flagship's 64 (k 6), groups of 4,
    unions of 32 slots and of 8 (overflowing), and the tie fixtures."""
    rng = np.random.default_rng(20)
    r = rng.uniform(-1, 1, (8000, 3)).astype(np.float32)
    q = rng.uniform(-1, 1, (8000, 3)).astype(np.float32)
    ti = tb.build_kd_index(torch.as_tensor(r, device=cuda_device), tile_size=128)
    for sq, k in ((32, 12), (64, 6)):
        qt = tb.build_kd_index(torch.as_tensor(q, device=cuda_device), tile_size=sq).tiles
        cand, _ = tb._candidate_tiles(qt, ti, k)
        for u_max in (32, 8):  # 8: overflowing unions
            unions = blocknn_cuda.group_unions(cand, 4, u_max)
            d_k, pos_k = blocknn_cuda.fused4_cuda(qt, ti.tiles, unions, 4)
            d_p, pos_p = blocknn_cuda.fused4_reference(qt, ti.tiles, unions, 4)
            torch.cuda.synchronize()
            assert torch.equal(d_k, d_p) and torch.equal(pos_k, pos_p)  # bit for bit
    for name in ("lanes and slots", "all sentinel"):
        query, tiles, unions, group, _ = _fused4_tie_case(name)
        args = (torch.as_tensor(query, device=cuda_device), torch.as_tensor(tiles, device=cuda_device),
                unions.to(cuda_device), group)
        d_k, pos_k = blocknn_cuda.fused4_cuda(*args)
        d_p, pos_p = blocknn_cuda.fused4_reference(*args)
        assert torch.equal(d_k, d_p) and torch.equal(pos_k, pos_p), name


@pytest.mark.cuda
def test_cuda_fused4_library_shape(cuda_device):
    """The built library reports the shape the plan tests assume."""
    assert blocknn_cuda.fused4_shape() == F4_SHAPE


# ---- kernel #7: the union radius moments ----------------------------------------------------------


@pytest.mark.cuda
def test_cuda_moments_fused_matches_plain(cuda_device):
    """Unions of 32, 8 (overflowing) and the kernel's largest, 128; the
    slot-weights fixture; and a union above the largest refused."""
    r = np.random.default_rng(0).uniform(-1, 1, (8000, 3)).astype(np.float32)
    ti = tb.build_kd_index(torch.as_tensor(r, device=cuda_device), tile_size=128)
    cand, _ = tb._candidate_tiles(ti.tiles, ti, 8)
    q_cent = blocknn_cuda.group_centroids(ti.tiles, 4)
    r2 = torch.tensor([RADIUS_U * RADIUS_U], dtype=torch.float32, device=cuda_device)
    for u_max in (32, 8, 128):
        unions = blocknn_cuda.group_unions(cand, 4, u_max)
        before = blocknn_cuda.LAUNCHES["moments_fused"]
        out_k = blocknn_cuda.moments_fused_cuda(ti.tiles, ti.tiles, unions.to(torch.int32), q_cent, r2, 4)
        out_p = blocknn_cuda.moments_fused_reference(ti.tiles, ti.tiles, unions, q_cent, r2[0], 4)
        torch.cuda.synchronize()
        assert blocknn_cuda.LAUNCHES["moments_fused"] == before + 1
        assert torch.equal(out_k[0], out_p[0]), u_max  # the same verdicts: the same counts
        torch.testing.assert_close(out_k[1:], out_p[1:], rtol=1e-5, atol=1e-4)
    query, tiles, unions = _slot_weights_fixture()
    qt = torch.as_tensor(query, device=cuda_device)
    fq_cent = blocknn_cuda.group_centroids(qt, 4)
    args = (qt, torch.as_tensor(tiles, device=cuda_device), unions.to(cuda_device, torch.int32), fq_cent,
            torch.tensor([0.6], device=cuda_device), 4)
    assert torch.equal(blocknn_cuda.moments_fused_cuda(*args)[0],
                       blocknn_cuda.moments_fused_reference(*args[:4], args[4][0], 4)[0])
    wide = blocknn_cuda.group_unions(cand, 4, 129).to(torch.int32)
    with pytest.raises(ValueError, match="exceed the kernel's 128"):
        blocknn_cuda.moments_fused_cuda(ti.tiles, ti.tiles, wide, q_cent, r2, 4)


@pytest.mark.cuda
def test_cuda_moments_fused_library_shape(cuda_device):
    """The built library reports the shape the plan tests assume."""
    assert blocknn_cuda.moments_fused_shape() == MF_SHAPE


# ---- the refine-stride mid phase's shapes (kernels #3-#5) --------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [2, 4])
def test_cuda_mid_phase_folds_match_plain(cuda_device, stride):
    """fold6, fold7 and select on every stride-th row of the fold case's
    query tiles (Sq 32 and 16) against the same frozen candidates, fold7
    centred on the full tiles' centroids as the mid phase runs it: d2 bits
    and payload equal to the plain versions', select's also to the row
    gather."""
    tq, ti, table, cand = _fold_case(19, cuda_device)
    q_cent = tb._candidate_tiles(tq.tiles, ti, 6)[1]
    qm = tq.tiles[:, ::stride].contiguous()
    for run, plain, ops in (
            (blocknn_cuda.fold6_cuda, fold6_reference, fold6_prepare(cand, ti, table)),
            (blocknn_cuda.fold7_cuda, blocknn_cuda.fold7_reference,
             blocknn_cuda.fold7_prepare(cand, q_cent, ti, table))):
        d_k, pl_k = run(qm, ops)
        d_p, pl_p = plain(qm, ops)
        torch.cuda.synchronize()
        assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32)) and torch.equal(pl_k, pl_p)
    _, pos = tb.block_nn(qm, ti, return_pos=True, cand_tiles=cand)
    pos = pos.reshape(qm.shape[0], qm.shape[1])
    out_k = blocknn_cuda.select_cuda(pos, cand.to(torch.int32), table, ti.tile_size)
    out_p = blocknn_cuda.select_reference(pos, cand, table, ti.tile_size)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p) and torch.equal(out_k, table[pos.reshape(-1).long()])


# ---- the rest of the registration layer, card against CPU --------------------------------------


def _index_to(index, device):
    return tb.TileIndex(**{f: getattr(index, f).to(device) for f in
                           ("tiles", "box_lo", "box_hi", "centroids", "order")})


@pytest.mark.cuda
@pytest.mark.parametrize("max_chunk", [32768, 5])
def test_cuda_feature_block_nn_matches_cpu(cuda_device, max_chunk):
    """`block_nn` and `block_nn_payload` with a feature channel (weight
    0.7) on the card against the same calls on the CPU, unchunked and in
    chunks of 5 query tiles: d2 within 1e-6 of the score's scale (the
    largest |q|^2 + w^2 f_q^2: the two devices round the expansion in
    different orders), winners equal but at near-ties, where their d2 agree
    within that."""
    rng = np.random.default_rng(31)
    r = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    f_r = (np.sin(3 * r[:, 0]) + r[:, 1]).astype(np.float32)
    pick = rng.permutation(4096)[:2048]
    q = (r[pick] + rng.normal(0, 0.01, (2048, 3))).astype(np.float32)
    ti = tb.build_kd_index(torch.as_tensor(r), tile_size=128)
    qi = tb.build_kd_index(torch.as_tensor(q), tile_size=64)
    order = qi.order.long()
    qf = torch.where(order >= 0, torch.as_tensor(f_r[pick])[order.clamp(min=0)], 0.0)
    qf = qf.reshape(qi.n_tiles, qi.tile_size)
    ft = tb.tile_payload(ti, torch.as_tensor(f_r)[:, None])[..., 0]
    pl = tb.tile_payload(ti, torch.as_tensor(rng.normal(size=(4096, 4)).astype(np.float32)))
    kw = dict(k_tiles=4, max_chunk=max_chunk, feat_weight=0.7)
    scale = (qi.tiles.reshape(-1, 3) ** 2).sum(1) + 0.49 * qf.reshape(-1) ** 2
    tol = 1e-6 * float(scale[qi.order >= 0].max())
    on = lambda x: x.to(cuda_device)  # noqa: E731
    for fn, extra in ((tb.block_nn, dict(return_pos=True)), (tb.block_nn_payload, {})):
        args = (qi.tiles, ti) + ((pl,) if fn is tb.block_nn_payload else ())
        d_c, w_c = fn(*args, query_feat=qf, feat_tiles=ft, **kw, **extra)
        d_g, w_g = fn(*(on(a) if torch.is_tensor(a) else _index_to(a, cuda_device) for a in args),
                      query_feat=on(qf), feat_tiles=on(ft), **kw, **extra)
        d_g, w_g = d_g.cpu(), w_g.cpu()
        assert torch.equal(torch.isfinite(d_g), torch.isfinite(d_c))
        fin = torch.isfinite(d_c)
        assert float((d_g[fin] - d_c[fin]).abs().max()) <= tol
        differ = (w_g != w_c) if w_c.ndim == 1 else (w_g != w_c).any(1)
        assert float(differ.float().mean()) < 1e-2
        assert bool(((d_g[differ] - d_c[differ]).abs() <= tol).all())


@pytest.mark.cuda
def test_cuda_voxel_nn_matches_cpu(cuda_device):
    """The voxel grid and its 27-cell NN on the card against the CPU: the
    same table, and on every query (all valid) the same index and d2
    bits."""
    from icpx_torch.kernels.voxel import build_voxel_grid, voxel_nn

    r = torch.as_tensor(synthetic_surface(20000, seed=0))
    q = torch.as_tensor(synthetic_surface(5000, seed=1))
    cell = auto_cell_size(r)
    g_c = build_voxel_grid(r, cell)
    g_g = build_voxel_grid(r.to(cuda_device), cell.to(cuda_device))
    assert torch.equal(g_g.table.cpu(), g_c.table)
    d_c, i_c = voxel_nn(q, g_c)
    d_g, i_g = voxel_nn(q.to(cuda_device), g_g)
    assert torch.equal(i_g.cpu(), i_c)
    assert torch.equal(d_g.cpu().view(torch.int32), d_c.view(torch.int32))


@pytest.mark.cuda
def test_cuda_horn_planar_is_a_proper_rotation(cuda_device):
    """Coplanar points (a rank-2 cross-covariance): cuSOLVER's singular
    vectors may differ in sign from LAPACK's, and the det fix keeps R
    proper; R and t within 1e-5 of the CPU's."""
    from icpx_torch.registration.horn import horn_align

    rng = np.random.default_rng(7)
    src = rng.normal(size=(50, 3)).astype(np.float32) * np.float32([1.0, 1.0, 0.0])
    a = 1.2
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    R = R @ np.array([[1, 0, 0], [0, np.cos(0.4), -np.sin(0.4)], [0, np.sin(0.4), np.cos(0.4)]],
                     np.float32)
    dst = src @ R.T + np.float32([0.3, -0.2, 0.5])
    est_c = horn_align(torch.as_tensor(src), torch.as_tensor(dst))
    est_g = horn_align(torch.as_tensor(src, device=cuda_device), torch.as_tensor(dst, device=cuda_device))
    assert est_g.R.device.type == "cuda"
    assert abs(float(torch.linalg.det(est_g.R.double())) - 1.0) < 1e-4
    torch.testing.assert_close(est_g.R.cpu(), est_c.R, rtol=0, atol=1e-5)
    torch.testing.assert_close(est_g.t.cpu(), est_c.t, rtol=0, atol=1e-5)
    torch.testing.assert_close(est_g.R.cpu(), torch.as_tensor(R), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_horn_numpy_input_lands_on_the_card(cuda_device):
    """numpy arrays, as the reference's callers pass them, go to the first
    CUDA device unless a device is given, and give the CPU's result."""
    from icpx_torch.registration.horn import horn_align, umeyama_align
    from icpx_torch.registration.icp import ICPConfig, register_xyz

    rng = np.random.default_rng(8)
    src = rng.normal(size=(200, 3)).astype(np.float32)
    dst = (2.0 * src + np.float32([0.1, 0.2, -0.3])).astype(np.float32)
    est = horn_align(src, 0.5 * dst)
    est_s, s = umeyama_align(src, dst)
    assert est.R.device == est_s.R.device == s.device == torch.device("cuda", 0)
    est_c = horn_align(src, 0.5 * dst, device="cpu")
    torch.testing.assert_close(est.R.cpu(), est_c.R, rtol=0, atol=1e-5)
    torch.testing.assert_close(est.t.cpu(), est_c.t, rtol=0, atol=1e-5)
    assert abs(float(s) - 2.0) < 1e-4
    res = register_xyz(src, src, ICPConfig(max_iters=1))
    assert res.transform.R.device == torch.device("cuda", 0)


# ---- odometry on the card -------------------------------------------------------------------


def _transform_gap(a, b):
    """Largest (rotation, translation) gap between two batched SE3s in
    float64 on the host (the angle from the skew part of Ra^T Rb)."""
    Ra, Rb = a.R.detach().cpu().double(), b.R.detach().cpu().double()
    M = Ra.transpose(-1, -2) @ Rb
    w = torch.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0],
                     M[..., 1, 0] - M[..., 0, 1]], -1) / 2.0
    dt = (a.t.detach().cpu().double() - b.t.detach().cpu().double()).norm(dim=-1)
    return float(torch.arcsin(w.norm(dim=-1).clamp(max=1.0)).max()), float(dt.max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 8192])
def test_cuda_compiled_odometry_matches_cpu(cuda_device, n):
    """`run_odometry_compiled` on the card (the nn kernel at 2,048 points,
    the KD builds' sort kernel at 8,192) against the port on the CPU on the
    same scans and normals: keyframe flags and sources equal, poses within
    the CPU parity tests' tolerance (1e-3 brute, 1e-4 block)."""
    from icpx_torch.odometry.compiled import run_odometry_compiled
    from icpx_torch.registration.icp import ICPConfig
    from torch_fixtures import odometry_frames

    frames, _ = odometry_frames(n, 8, device="cpu")
    fx = [torch.stack([getattr(f, a) for f in frames]) for a in ("xyz", "mask", "normals")]
    cfg = ICPConfig(objective="symmetric", max_iters=12, diff_threshold=0.0, rmse_change_tol=1e-6,
                    robust="huber", max_corr_dist=2.0)
    cpu = run_odometry_compiled(*fx, cfg, keyframe_trans=1.0, keyframe_rot=0.2)
    card = run_odometry_compiled(*(x.to(cuda_device) for x in fx), cfg, keyframe_trans=1.0,
                                 keyframe_rot=0.2)
    assert card.poses.t.device.type == "cuda"
    assert torch.equal(card.is_keyframe.cpu(), cpu.is_keyframe)
    assert torch.equal(card.edge_src.cpu(), cpu.edge_src)
    tol = 1e-4 if cfg.resolve_nn(n) == "block" else 1e-3
    d_rot, d_t = _transform_gap(card.poses, cpu.poses)
    assert d_rot < tol and d_t < tol, (d_rot, d_t)


@pytest.mark.cuda
def test_cuda_insert_scan_matches_cpu(cuda_device):
    """`insert_scan` on the card equals the CPU's bit for bit on identity
    poses (the same cells, the same chained stable sorts)."""
    from icpx_torch.cloud import PointCloud
    from icpx_torch.geometry.se3 import SE3
    from icpx_torch.kernels.normals import estimate_normals
    from icpx_torch.odometry.mapping import VoxelMap, insert_scan

    maps = {d: VoxelMap.create(2048, 0.05, device=d) for d in ("cpu", cuda_device)}
    for k in range(3):
        scan = estimate_normals(PointCloud.create(synthetic_surface(1024, seed=k), device="cpu"), k=8)
        for d in maps:
            maps[d] = insert_scan(maps[d], scan.to(d), SE3.identity(device=d))
    a = interop.voxel_map_to_numpy(maps["cpu"])
    b = interop.voxel_map_to_numpy(maps[cuda_device])
    for f in ("xyz", "normals", "mask", "age", "counter"):
        assert np.array_equal(a[f], b[f]), f


@pytest.mark.cuda
def test_cuda_odometry_entry_points_land_on_the_card(cuda_device, tmp_path):
    """Without a device argument the odometry layer's entry points put
    their tensors on the first CUDA device."""
    from icpx_torch.odometry import kitti
    from icpx_torch.odometry.mapping import VoxelMap
    from icpx_torch.utils.checkpoint import OdometryCheckpoint

    first = torch.device("cuda", 0)
    world = kitti.make_world(n_points=5000, extent=10.0, seed=0)
    traj = kitti.make_trajectory(2)
    assert traj[0].R.device == first
    scans = kitti.simulate_scans(world, traj, points_per_scan=256)
    assert scans[0].xyz.device == first
    kitti.write_kitti_sequence(tmp_path / "v", scans, traj)
    assert kitti.load_kitti_sequence(tmp_path / "v")[0].xyz.device == first
    assert kitti.load_kitti_poses(tmp_path / "poses.txt")[0].t.device == first
    assert VoxelMap.create(128, 0.1).xyz.device == first
    ck = OdometryCheckpoint(frame_index=0, poses_R=np.eye(3, dtype=np.float32)[None],
                            poses_t=np.zeros((1, 3), np.float32), keyframe_index=0, edges=[])
    assert ck.poses()[0].R.device == first


@pytest.mark.cuda
def test_cuda_io_entry_points_land_on_the_card(cuda_device, tmp_path):
    """Without a device argument the IO layer's entry points put their
    tensors on the first CUDA device, for every file format: `load_cloud`
    (.pcd ascii / binary / binary_compressed, .ply, .xyz, .bin),
    `load_bunny`, `prefetch_kitti` and `load_checkpoint`; the native reader
    served every read."""
    from icpx_torch.cloud import PointCloud
    from icpx_torch.geometry.se3 import SE3
    from icpx_torch.io import load_cloud, native, prefetch_kitti, save_cloud
    from icpx_torch.io.loaders import load_bunny
    from icpx_torch.io.pcd import write_pcd
    from icpx_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    first = torch.device("cuda", 0)
    xyz = synthetic_surface(300, seed=3)
    cloud = PointCloud.create(xyz, device="cpu")
    files = {"a.pcd": {}, "b.pcd": {"binary": True}, "c.ply": {"binary": True}, "d.xyz": {}}
    for name, kw in files.items():
        save_cloud(tmp_path / name, cloud, **kw)
    write_pcd(tmp_path / "e.pcd", xyz, compressed=True)
    np.concatenate([xyz, xyz[:, :1]], axis=1).tofile(tmp_path / "000000.bin")
    native.reset_counts()
    for name in [*files, "e.pcd", "000000.bin"]:
        got = load_cloud(tmp_path / name)
        assert got.xyz.device == first, name
        assert np.array_equal(_np(got.xyz[got.mask]), xyz), name
    assert not any(native.FALLBACKS.values()), native.FALLBACKS
    assert load_bunny().xyz.device == first
    scan = next(iter(prefetch_kitti(tmp_path, capacity=384)))
    assert scan.xyz.device == first and np.array_equal(_np(scan.xyz[scan.mask]), xyz)
    save_checkpoint(tmp_path / "ck.npz", {"pose": SE3.identity(device=first), "n": torch.ones(3)})
    back = load_checkpoint(tmp_path / "ck.npz", {"pose": SE3.identity(device="cpu"), "n": torch.ones(3)})
    assert back["pose"].R.device == first and back["n"].device == first


@pytest.mark.cuda
def test_cuda_cli_register_matches_the_cpu(cuda_device, tmp_path, capsys):
    """`icpx_torch.cli register` on the card (the default device) prints the
    CPU run's transform to 1e-4 on the golden cat pair, through files."""
    from icpx_torch import cli
    from icpx_torch.io.loaders import reference_data_dir

    data = reference_data_dir()
    argv = ["register", str(data / "cat.pcd"), str(data / "cat_out.pcd"), "--max-iters", "20",
            "--max-corr-dist", "50", "--robust", "huber"]
    outs = []
    for extra in ([], ["--device", "cpu"]):
        capsys.readouterr()
        assert cli.main(extra + argv) == 0
        lines = capsys.readouterr().out.splitlines()
        i = lines.index("transform:")
        outs.append(np.array([[float(v) for v in ln.split()] for ln in lines[i + 1:i + 5]]))
    assert np.abs(outs[0] - outs[1]).max() <= 1e-4, outs

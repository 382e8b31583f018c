"""Port parity: brute-force NN of `icpx_torch` against `icpx`.

The port's plain 1-NN (`nearest_neighbor_reference`, what its CUDA kernel
is held to) against the Pallas kernel in interpret mode and the JAX
off-TPU scan; `knn` top-k against JAX `knn`. Tolerances: d2 rtol 1e-5 plus
atol 1e-6 * max|q|^2 (the JAX side scores by the expansion
|q|^2 + |r|^2 - 2 q.r, whose fp32 cancellation error scales with |q|^2);
indices must agree wherever the best and second-best JAX distances differ
by more than 1e-4 relative (elsewhere rounding may legitimately pick
either).

The CUDA kernel's screen is held on the CPU: its margin (`screen_margin`)
bounds the expansion error of every pair of six fixtures, and a numpy
emulation of the kernel's algorithm (screen, resolve, far rows in the direct
form, splits by rank among the non-empty tiles, the key combine) equals the
plain version bit for bit; `far_rows`, `path_counts` and `plan` are held to
hand-counted cases. The kernel itself is held bit for bit to the plain
version on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icpx.kernels.knn import _nearest_neighbor_jnp
from icpx.kernels.knn import knn as j_knn
from icpx.kernels.knn_pallas import nn_pallas
from icpx_torch.kernels import nn_cuda
from icpx_torch.kernels.knn import knn, nearest_neighbor, nearest_neighbor_reference
from icpx_torch.utils import profiling
from icpx_torch.cloud import PAD_COORD
from torch_fixtures import (CSRC_SHAPE, FAR_FIXTURES, SCREEN_FIXTURES, duplicate_fixture,
                            far_fixture, screen_fixture)
from torch_fixtures import _nn_inputs as _inputs
from torch_parity import to_np

GAP = 1e-4


def _separated(q, r, mask, k=1):
    """Rows whose k-th and (k+1)-th JAX distances differ by > GAP relative."""
    d, _ = j_knn(jnp.asarray(q), jnp.asarray(r), k + 1, ref_mask=jnp.asarray(mask))
    d = np.asarray(d)
    return (d[:, k] - d[:, k - 1]) > GAP * d[:, k]


def _check(d_t, i_t, d_j, i_j, q, sep):
    scale = float((q.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(to_np(d_t), np.asarray(d_j), rtol=1e-5, atol=1e-6 * scale)
    i_t, i_j = to_np(i_t), np.asarray(i_j)
    assert sep.mean() > 0.9  # the index check covers almost every row
    np.testing.assert_array_equal(i_t[sep], i_j[sep])


def _plain(q, r, mask, **kw):
    return nearest_neighbor_reference(
        torch.as_tensor(q), torch.as_tensor(r), ref_mask=torch.as_tensor(mask), **kw
    )


@pytest.mark.parametrize(
    "nq,nr,masked_frac",
    [(700, 1500, 0.0), (333, 1031, 0.3)],
)
def test_plain_nn_matches_pallas_interpret(nq, nr, masked_frac):
    q, r, mask = _inputs(nq, nr, seed=nq, masked_frac=masked_frac)
    d_j, i_j = nn_pallas(
        jnp.asarray(q), jnp.asarray(r), ref_mask=jnp.asarray(mask), interpret=True
    )
    d_t, i_t = _plain(q, r, mask)
    _check(d_t, i_t, d_j, i_j, q, _separated(q, r, mask))


@pytest.mark.parametrize(
    "nq,nr,masked_frac,tiles",
    [
        (1000, 2000, 0.0, (2048, 4096)),
        (513, 777, 0.0, (128, 256)),  # not tile multiples, several tiles
        (600, 4099, 0.5, (256, 1024)),  # half the refs masked
        (64, 130, 0.97, (32, 64)),  # a few valid refs only
    ],
)
def test_plain_nn_matches_jnp_scan(nq, nr, masked_frac, tiles):
    q, r, mask = _inputs(nq, nr, seed=nr, masked_frac=masked_frac)
    d_j, i_j = _nearest_neighbor_jnp(jnp.asarray(q), jnp.asarray(r), ref_mask=jnp.asarray(mask))
    d_t, i_t = _plain(q, r, mask, tile_q=tiles[0], tile_r=tiles[1])
    _check(d_t, i_t, d_j, i_j, q, _separated(q, r, mask))


def test_all_masked_refs_give_inf_and_index_zero():
    q, r, _ = _inputs(50, 300, seed=7)
    mask = np.zeros(300, bool)
    d_j, i_j = _nearest_neighbor_jnp(jnp.asarray(q), jnp.asarray(r), ref_mask=jnp.asarray(mask))
    d_t, i_t = _plain(q, r, mask, tile_q=16, tile_r=128)
    assert np.isinf(np.asarray(d_j)).all() and np.isinf(to_np(d_t)).all()
    np.testing.assert_array_equal(to_np(i_t), np.asarray(i_j))
    assert (to_np(i_t) == 0).all()


def test_duplicate_points_lowest_index_wins():
    q, r, expect = duplicate_fixture()
    mask = np.ones(len(r), bool)
    d_t, i_t = _plain(q, r, mask, tile_q=3, tile_r=5)  # ties straddle tiles
    np.testing.assert_array_equal(to_np(i_t), expect)
    _, i_j = _nearest_neighbor_jnp(jnp.asarray(q), jnp.asarray(r))
    np.testing.assert_array_equal(to_np(i_t), np.asarray(i_j))
    # masking the first copy hands the win to the next one
    mask[expect[0]] = False
    _, i_m = _plain(q, r, mask)
    assert int(i_m[0]) > int(expect[0]) and np.array_equal(r[int(i_m[0])], q[0])


@pytest.mark.parametrize("k,masked_frac", [(1, 0.0), (8, 0.0), (10, 0.4)])
def test_knn_matches_jax(k, masked_frac):
    q, r, mask = _inputs(500, 1300, seed=k, masked_frac=masked_frac)
    d_j, i_j = j_knn(jnp.asarray(q), jnp.asarray(r), k, ref_mask=jnp.asarray(mask))
    d_t, i_t = knn(torch.as_tensor(q), torch.as_tensor(r), k,
                   ref_mask=torch.as_tensor(mask), tile_q=128, tile_r=512)
    scale = float((q.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(to_np(d_t), np.asarray(d_j), rtol=1e-5, atol=1e-6 * scale)
    sep = _separated(q, r, mask, k=k)
    assert sep.mean() > 0.9
    got, want = np.sort(to_np(i_t)[sep], 1), np.sort(np.asarray(i_j)[sep], 1)
    np.testing.assert_array_equal(got, want)


def test_knn_duplicates_and_short_rows_match_jax():
    """Exact ties resolve to the lower index, and rows with fewer than k
    valid refs fill with (inf, 0), as lax.top_k does."""
    q, r, _ = duplicate_fixture()
    mask = np.ones(len(r), bool)
    mask[-3:] = False
    for k in (3, 12):
        d_j, i_j = j_knn(jnp.asarray(q), jnp.asarray(r), k, ref_mask=jnp.asarray(mask))
        d_t, i_t = knn(torch.as_tensor(q), torch.as_tensor(r), k,
                       ref_mask=torch.as_tensor(mask), tile_q=4, tile_r=5)
        np.testing.assert_array_equal(to_np(d_t), np.asarray(d_j))
        np.testing.assert_array_equal(to_np(i_t), np.asarray(i_j))
    with pytest.raises(ValueError):
        knn(torch.as_tensor(q), torch.as_tensor(r), len(r) + 1)


def test_cpu_dispatch_uses_plain_version_and_kernel_refuses_cpu():
    q, r, mask = _inputs(100, 300, seed=3, masked_frac=0.2)
    before = profiling.LAUNCHES["nn"]
    d, i = nearest_neighbor(torch.as_tensor(q), torch.as_tensor(r), ref_mask=torch.as_tensor(mask))
    d_p, i_p = _plain(q, r, mask, tile_q=2048, tile_r=4096)
    assert torch.equal(d, d_p) and torch.equal(i, i_p) and i.dtype == torch.int32
    assert profiling.LAUNCHES["nn"] == before
    with pytest.raises(ValueError):
        nn_cuda.nn_cuda(torch.as_tensor(q), torch.as_tensor(r))


# ---- the kernel's screen: margin, emulation, plan ------------------------------------


def _sqnorm(x):
    """((x^2 + y^2) + z^2) in float32, every step rounded, as the kernel."""
    return (x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2]


@pytest.mark.parametrize("name", SCREEN_FIXTURES)
def test_screen_margin_bounds_the_expansion(name):
    """For every valid pair, the fp32 expansion score with every product
    rounded (s = ax rx + (ay ry + (az rz + rr)), a = -2q) plus the exact
    |q|^2 is within delta_q / 2 of the fp32 direct-form d2."""
    q, r, mask = (torch.as_tensor(x) for x in screen_fixture(name))
    r = r[mask]
    rr = _sqnorm(r)
    delta = nn_cuda.screen_margin(_sqnorm(q), rr.max())
    a = -2.0 * q
    worst = 0.0
    for q0 in range(0, len(q), 250):
        qs, a_s = q[q0:q0 + 250], a[q0:q0 + 250]
        s = a_s[:, None, 0] * r[None, :, 0] + (
            a_s[:, None, 1] * r[None, :, 1] + (a_s[:, None, 2] * r[None, :, 2] + rr[None]))
        dx, dy, dz = (qs[:, None, i] - r[None, :, i] for i in range(3))
        d2 = dx * dx + dy * dy + dz * dz
        qq = (qs.double() ** 2).sum(1, keepdim=True)
        err = (s.double() + qq - d2.double()).abs()
        ratio = err / (delta[q0:q0 + 250, None].double() / 2)
        worst = max(worst, float(ratio.max()))
    assert worst <= 1.0, f"an expansion error reaches {worst:.3f} x delta_q / 2"


def emulate_nn(q, r, mask, splits, tile=64, group=8, pieces=3):
    """The kernel's algorithm in float32 numpy: pack (masked and padded rows
    (NaN, NaN, NaN, +inf)); find the non-empty tiles and the far rows
    (`nn_cuda.far_rows`); per split of the non-empty tiles by rank, screen
    the near rows by groups, and where a group's least score (an fminf fold,
    which passes NaN over) passes the query's threshold, lower the
    threshold to that score + delta_q and mark the group; at the tile's end
    rescore the marked groups in ascending order in the direct form, row by
    row where the row's own score is not above the threshold (strict '<',
    rr = inf skipped), lowering the threshold to the new best's score +
    delta_q. Far rows get threshold NaN there (no group passes) and are
    scored in `pieces` pieces of ranks in the direct form alone: a group
    whose fminf-folded least d is below the best gives its lowest row with
    that d. Every split and piece folds its (bits(d2) << 32 | index) keys
    with a minimum. The screen's FMA is taken as the float64 sum of an exact
    product, rounded once to float32 (a double rounding may move it by an
    ulp, which the margin covers)."""
    nq, nr = len(q), len(r)
    tiles = max(1, -(-nr // tile))
    n_pad = tiles * tile
    rows = np.full((n_pad, 3), np.nan, np.float32)
    rr = np.full(n_pad, np.inf, np.float32)
    valid = np.zeros(n_pad, bool)
    valid[:nr] = mask
    rows[valid] = r[mask]
    rr[valid] = _sqnorm(rows[valid])
    nonempty = [t for t in range(tiles) if valid[t * tile:(t + 1) * tile].any()]
    init = np.uint64(0x7F800000) << np.uint64(32)
    keys = np.full(nq, init, np.uint64)
    n_ne = len(nonempty)

    def fold(best_d, best_i, who):
        found = best_d != np.inf
        key = (best_d.view(np.uint32).astype(np.uint64) << np.uint64(32)) | best_i.astype(np.uint64)
        keys[who] = np.where(found, np.minimum(keys[who], key), keys[who])

    def least(x):  # fminf over a group from +inf: NaN never wins
        return np.fmin(np.float32(np.inf), np.fmin.reduce(x, axis=1))

    def fma(x, y, z):
        return (x * y + z).astype(np.float32).astype(np.float64)

    if n_ne:
        rr_max = rr[valid].max()
        delta = nn_cuda.screen_margin(torch.as_tensor(_sqnorm(q)), torch.tensor(rr_max)).numpy()
        far = nn_cuda.far_rows(torch.as_tensor(q), torch.tensor(rr_max)).numpy()
        a64 = (np.float32(-2.0) * q).astype(np.float64)
        for y in range(splits):
            best_d = np.full(nq, np.inf, np.float32)
            best_i = np.zeros(nq, np.int64)
            thr = np.where(far, np.float32(np.nan), np.float32(np.inf)).astype(np.float32)
            for t in nonempty[y * n_ne // splits:(y + 1) * n_ne // splits]:
                gr = rows[t * tile:(t + 1) * tile].astype(np.float64)
                grr = rr[t * tile:(t + 1) * tile]
                s = fma(a64[:, None, 0], gr[None, :, 0], fma(a64[:, None, 1], gr[None, :, 1], fma(
                    a64[:, None, 2], gr[None, :, 2], grr[None].astype(np.float64))))
                s = s.astype(np.float32)
                marked = np.zeros((nq, tile // group), bool)
                for gi in range(tile // group):
                    gmin = least(s[:, gi * group:(gi + 1) * group])
                    passing = gmin <= thr
                    thr = np.where(passing, np.minimum(thr, gmin + delta), thr)
                    marked[:, gi] = passing
                for gi in range(tile // group):
                    for j in range(gi * group, (gi + 1) * group):
                        cand = np.flatnonzero(marked[:, gi])
                        if grr[j] == np.inf or not cand.size:
                            continue
                        cand = cand[~(s[cand, j] > thr[cand])]
                        dx, dy, dz = (q[cand, i] - rows[t * tile + j, i] for i in range(3))
                        d = (dx * dx + dy * dy) + dz * dz
                        better = d < best_d[cand]
                        win = cand[better]
                        best_d[win] = d[better]
                        best_i[win] = t * tile + j
                        thr[win] = np.minimum(thr[win], s[win, j] + delta[win])
            fold(best_d, best_i, slice(None))
        fq = q[far]
        per = -(-n_ne // pieces)
        for c in range(0, n_ne, per):
            best_d = np.full(len(fq), np.inf, np.float32)
            best_i = np.zeros(len(fq), np.int64)
            for t in nonempty[c:c + per]:
                for g0 in range(t * tile, (t + 1) * tile, group):
                    g = rows[g0:g0 + group]
                    dx, dy, dz = (fq[:, None, i] - g[None, :, i] for i in range(3))
                    d = (dx * dx + dy * dy) + dz * dz
                    gmin = least(d)
                    better = gmin < best_d
                    best_i[better] = g0 + (d[better] == gmin[better, None]).argmax(1)
                    best_d[better] = gmin[better]
            fold(best_d, best_i, far)
    d2 = (keys >> np.uint64(32)).astype(np.uint32).view(np.float32)
    return d2, (keys & np.uint64(0xFFFFFFFF)).astype(np.int32)


@pytest.mark.parametrize("splits", [1, 3, 7])
@pytest.mark.parametrize("name", SCREEN_FIXTURES + ["all masked"])
def test_emulated_screen_equals_reference_bit_for_bit(name, splits):
    """Screen, resolve and the packed-key split combine give the plain
    version's d2 and index bit for bit (ragged last tiles everywhere: no
    fixture's reference count is a multiple of the tile)."""
    q, r, mask = screen_fixture(name)
    d_e, i_e = emulate_nn(q, r, mask, splits)
    d_p, i_p = _plain(q, r, mask)
    np.testing.assert_array_equal(d_e.view(np.int32), to_np(d_p).view(np.int32))
    np.testing.assert_array_equal(i_e, to_np(i_p))
    if name == "all masked":
        assert np.isinf(d_e).all() and (i_e == 0).all()


@pytest.mark.parametrize("splits", [1, 3, 7])
@pytest.mark.parametrize("name", FAR_FIXTURES)
def test_emulated_far_rows_and_empty_tiles_equal_reference(name, splits):
    """Far rows in the direct form alone, in pieces, and splits cut by rank
    among the non-empty tiles give the plain version's d2 and index bit for
    bit, pad rows included."""
    q, r, mask = far_fixture(name)
    d_e, i_e = emulate_nn(q, r, mask, splits)
    d_p, i_p = _plain(q, r, mask)
    np.testing.assert_array_equal(d_e.view(np.int32), to_np(d_p).view(np.int32))
    np.testing.assert_array_equal(i_e, to_np(i_p))


@pytest.mark.parametrize("nq,nr,sms,per_sm,want", [
    (65536, 65536, 132, 2, (64, 4, 264)),  # the 65k pair: 256 near items in a wave of 264
    (16384, 65536, 132, 2, (16, 16, 264)),  # its every 4th source row
    (3456, 3456, 132, 2, (4, 14, 112)),  # the cat pair: a split a tile, two blocks an item
    (10**6, 1000, 132, 2, (977, 1, 264)),  # more query blocks than a wave
    (65536, 65536, 132, 4, (64, 8, 528)),  # 4 blocks an SM
    (5, 0, 132, 2, (1, 1, 2)),  # no reference rows
])
def test_plan_fills_one_wave(nq, nr, sms, per_sm, want):
    q_blocks, splits, grid = nn_cuda.plan(nq, nr, sms, per_sm, CSRC_SHAPE)
    assert (q_blocks, splits, grid) == want
    tiles = max(1, -(-nr // CSRC_SHAPE.tile_r))
    assert splits <= tiles and grid == min(sms * per_sm, 2 * q_blocks * splits)


def test_far_rows_are_the_rows_every_group_passes():
    """PAD_COORD rows are far and rows within the references' range (the
    origin among them) are not; a far row's delta_q covers the widest spread
    R (R + 4 |q|) of its screen scores, and the smallest far |q| sits where
    delta_q crosses it (2^-19 (Q + R)^2 = R (R + 4 Q): Q ~ 2^21 R)."""
    q, r, mask = far_fixture("scan layout")
    rr = _sqnorm(torch.as_tensor(r[mask]))
    far = nn_cuda.far_rows(torch.as_tensor(q), rr.max()).numpy()
    np.testing.assert_array_equal(far, np.abs(q).max(1) >= PAD_COORD)
    assert not bool(nn_cuda.far_rows(torch.zeros((1, 3)), rr.max())[0])
    big_r = float(torch.sqrt(rr.max()))
    scale = np.float32([1.0, 0.0, 0.0])
    qs = torch.as_tensor(np.stack([scale * (2.0 ** 21) * big_r * f for f in (0.9, 1.1)]))
    assert nn_cuda.far_rows(qs, rr.max()).tolist() == [False, True]
    qq = _sqnorm(qs)
    delta = nn_cuda.screen_margin(qq, rr.max())
    spread = big_r * (big_r + 4.0 * torch.sqrt(qq))
    assert bool(delta[1] >= spread[1]) and bool(delta[0] < spread[0])


@pytest.mark.parametrize("name,want", [
    ("scan layout", (500, 4 * 3)),  # 4 of 16 tiles empty, 3 query blocks
    ("pad one in 7", (300, 0)), ("one far row", (1, 0)), ("all far", (1500, 0)),
    ("none far", (0, 0)), ("masked tail", (0, 14 * 2)), ("masked interleaved", (0, 0)),
    ("all masked", (0, 3 * 2)),  # no valid reference: no far row, every tile empty
    ("nq ragged", (9, 1 * 2)), ("nr below a tile", (50, 0)),
])
def test_path_counts(name, want):
    """What one kernel call adds to `profiling.nn_counters`: far rows (none
    without a valid reference), and each empty tile once a query block."""
    q, r, mask = (torch.as_tensor(x) for x in far_fixture(name))
    assert nn_cuda.path_counts(q, r, mask, CSRC_SHAPE) == want
    assert nn_cuda.path_counts(q, r, None, CSRC_SHAPE)[1] == 0


def test_nn_counters_read_zero_before_a_call():
    assert profiling.nn_counters("cuda:7") == {"far_rows": 0, "empty_tiles": 0}


def test_nn_counters_are_not_made_inside_a_graph_capture(monkeypatch):
    """The counters' zero fill would be captured and rerun at each replay:
    a first call inside a capture is refused, before anything is made."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="before any CUDA graph capture"):
        profiling.nn_counter_tensor("cuda:7")
    assert profiling.nn_counters("cuda:7") == {"far_rows": 0, "empty_tiles": 0}

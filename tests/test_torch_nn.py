"""Port parity: brute-force NN of `icpx_torch` against `icpx`.

The port's plain 1-NN (`nearest_neighbor_reference`, what its CUDA kernel
is held to) against the Pallas kernel in interpret mode and the JAX
off-TPU scan; `knn` top-k against JAX `knn`. Tolerances: d2 rtol 1e-5 plus
atol 1e-6 * max|q|^2 (the JAX side scores by the expansion
|q|^2 + |r|^2 - 2 q.r, whose fp32 cancellation error scales with |q|^2);
indices must agree wherever the best and second-best JAX distances differ
by more than 1e-4 relative (elsewhere rounding may legitimately pick
either).
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
from torch_parity import to_np

GAP = 1e-4


def _inputs(nq, nr, seed, masked_frac=0.0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.0, 1.0, size=(nq, 3)).astype(np.float32)
    r = rng.uniform(-1.0, 1.0, size=(nr, 3)).astype(np.float32)
    mask = rng.uniform(size=nr) >= masked_frac
    return q, r, mask


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


def duplicate_fixture():
    """Refs with exact duplicates at several indices; queries sit exactly on
    some of them. Coordinates are small integers, so every squared distance
    is exact in fp32 under either scoring formula."""
    base = np.array([[0, 0, 0], [3, 1, 2], [-2, 4, 1], [5, -3, 0]], np.float32)
    ref = np.concatenate([base[[1, 2]], base, base[[0, 1]], base], axis=0)
    query = np.concatenate([base, base + np.float32([0, 0, 1])], axis=0)
    # expected: the first occurrence of the exact match / nearest copy
    d = ((query[:, None, :] - ref[None]) ** 2).sum(-1)
    expect = d.argmin(1)  # numpy: first index among ties
    return query, ref, expect


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
    before = nn_cuda.LAUNCHES
    d, i = nearest_neighbor(torch.as_tensor(q), torch.as_tensor(r), ref_mask=torch.as_tensor(mask))
    d_p, i_p = _plain(q, r, mask, tile_q=2048, tile_r=4096)
    assert torch.equal(d, d_p) and torch.equal(i, i_p) and i.dtype == torch.int32
    assert nn_cuda.LAUNCHES == before
    with pytest.raises(ValueError):
        nn_cuda.nn_cuda(torch.as_tensor(q), torch.as_tensor(r))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "nq,nr,masked_frac", [(3456, 3456, 0.0), (1000, 70001, 0.5), (4099, 5000, 1.0)]
)
def test_cuda_kernel_matches_plain(cuda_device, nq, nr, masked_frac):
    q, r, mask = _inputs(nq, nr, seed=nq, masked_frac=masked_frac)
    qc, rc, mc = (torch.as_tensor(x, device=cuda_device) for x in (q, r, mask))
    d_k, i_k = nn_cuda.nn_cuda(qc, rc, mc)
    d_p, i_p = nearest_neighbor_reference(qc, rc, ref_mask=mc)
    torch.cuda.synchronize()
    fin = torch.isfinite(d_p)
    assert torch.equal(fin, torch.isfinite(d_k))
    scale = float((q.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(to_np(d_k[fin]), to_np(d_p[fin]), rtol=1e-5, atol=1e-6 * scale)
    if masked_frac < 1.0:
        sep = _separated(q, r, mask)
        np.testing.assert_array_equal(to_np(i_k)[sep], to_np(i_p)[sep])
    else:
        assert (i_k == 0).all()
    qd, rd, expect = duplicate_fixture()
    _, i_d = nn_cuda.nn_cuda(torch.as_tensor(qd, device=cuda_device),
                             torch.as_tensor(rd, device=cuda_device))
    np.testing.assert_array_equal(to_np(i_d), expect)

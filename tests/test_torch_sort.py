"""Port parity: the segmented stable sort (kernel #8) of `icpx_torch`
against `icpx`, and the KD builds that run through it.

The plain version (`sort_segments_reference`, what the sort wrapper runs on
a CPU tensor) is held bit for bit against the Pallas `sort_segments` in
interpret mode at the reference's own test shapes, and against a stable
`lax.sort` at m = 64 and 128, below the Pallas kernel's m >= 256 floor:
the KD build's last level sorts segments of 2 * tile_size. Keys are
duplicate-heavy (stability is the hard part), with PAD_COORD tails and
signed zeros (equal under both sorts). The KD builds of both packages must
agree bit for bit at tiles 64 and 128 on a 16k cloud, whose last levels
sort m = 128 and 256.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icpx.kernels.blocknn as jb
from icpx.cloud import PAD_COORD
from icpx.kernels.sort_pallas import sort_segments as j_sort_segments
import icpx_torch.kernels.blocknn as tb
from icpx_torch.kernels import sort_cuda
from icpx_torch.kernels.sort_cuda import sort_segments, sort_segments_reference
from icpx_torch.utils import profiling
from torch_fixtures import SORT_SHAPE
from torch_fixtures import _sort_keys as _keys
from torch_parity import to_np


def _assert_bits_equal(got, want):
    for g, w in zip(got, want):
        g, w = to_np(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))  # -0.0 != +0.0 here


@pytest.mark.parametrize("c,m", [(4, 1024), (2, 2048)])
def test_plain_sort_matches_pallas_interpret(c, m):
    key, a, b, o = _keys(c, m, seed=m)
    want = j_sort_segments(jnp.asarray(key), (jnp.asarray(a), jnp.asarray(b), jnp.asarray(o)),
                           interpret=True)
    before = dict(profiling.LAUNCHES)
    got = sort_segments(torch.as_tensor(key), tuple(torch.as_tensor(x) for x in (a, b, o)))
    assert profiling.LAUNCHES == before  # CPU tensors: the plain version ran
    _assert_bits_equal(got, want)
    sk = to_np(got[0])
    assert (sk[0][-(m // 3):] == PAD_COORD).all()  # sentinels sink to the tail


@pytest.mark.parametrize("c,m", [(8, 128), (16, 64), (3, 2)])
def test_plain_sort_matches_stable_lax_sort(c, m):
    """Below the Pallas kernel's m >= 256: against `lax.sort` itself, with an
    (m, 3) row payload as the KD build passes its coordinates."""
    key, a, _, o = _keys(c, m, seed=c * m)
    xyz = np.random.default_rng(c).normal(size=(c, m, 3)).astype(np.float32)
    want = jax.lax.sort((jnp.asarray(key), jnp.asarray(a), jnp.asarray(o),
                         *(jnp.asarray(xyz[..., i]) for i in range(3))),
                        dimension=1, num_keys=1, is_stable=True)
    got = sort_segments_reference(torch.as_tensor(key),
                                  (torch.as_tensor(a), torch.as_tensor(o), torch.as_tensor(xyz)))
    _assert_bits_equal(got[:3], want[:3])
    np.testing.assert_array_equal(to_np(got[3]), np.stack([np.asarray(w) for w in want[3:]], -1))


def test_sort_rejects_bad_shapes():
    key = torch.zeros((2, 96))
    with pytest.raises(ValueError, match="power of two"):
        sort_segments(key)
    with pytest.raises(ValueError, match="does not start with"):
        sort_segments(torch.zeros((2, 64)), (torch.zeros((2, 32)),))
    with pytest.raises(ValueError, match="CUDA"):
        sort_cuda.sort_cuda(torch.zeros((2, 64)), ())


@pytest.mark.parametrize("s", [64, 128])
def test_kd_index_through_the_sort_matches_jax(s, monkeypatch):
    """A 16k cloud's KD build, bit for bit; every median level goes through
    the sort wrapper (counted here), down to segments of 2 * s."""
    x = np.random.default_rng(s).uniform(-1, 1, (16384, 3)).astype(np.float32)
    m = np.random.default_rng(s + 1).uniform(size=16384) >= 0.1
    calls = []

    def counting(key, payloads=()):
        calls.append(tuple(key.shape))
        return sort_segments(key, payloads)

    monkeypatch.setattr(tb, "sort_segments", counting)
    ji = jb.build_kd_index(jnp.asarray(x), jnp.asarray(m), tile_size=s)
    ti = tb.build_kd_index(torch.as_tensor(x), torch.as_tensor(m), tile_size=s)
    np.testing.assert_array_equal(to_np(ti.tiles), np.asarray(ji.tiles))
    np.testing.assert_array_equal(to_np(ti.order), np.asarray(ji.order))
    np.testing.assert_array_equal(to_np(ti.box_lo), np.asarray(ji.box_lo))
    np.testing.assert_array_equal(to_np(ti.box_hi), np.asarray(ji.box_hi))
    assert calls and calls[-1] == (16384 // (2 * s), 2 * s)
    assert all(c * m_ == 16384 for c, m_ in calls)


@pytest.mark.parametrize("c,m,want", [
    (64, 16384, ("pair", 128, 1, 0)),  # the first KD level at 1M: a cluster pair a segment
    (256, 4096, ("block", 128, 1, 0)),
    (1024, 1024, ("block", 128, 1, 0)),
    (4096, 256, ("block", 128, 1, 0)),
    (8192, 128, ("block", 128, 1, 0)),  # the source's last level (tiles of 64)
    (16, 65536, ("chunked", 128, 10, 1 << 20)),  # 4 block passes, 6 device-memory stages
    (3, 2, ("block", 1, 1, 0)),
])
def test_sort_plan_of_the_kernel_shape(c, m, want):
    plan = sort_cuda.plan(c, m, SORT_SHAPE)
    assert (plan["path"], plan["blocks"], plan["launches"], plan["work"]) == want


def _pack(key):
    """csrc/sort.cu's pack: the float bits made unsigned-ordered (-0 as +0),
    high word; the segment-local position, low word."""
    c, m = key.shape
    b = np.where(key == 0, np.float32(0), key).view(np.uint32).astype(np.uint64)
    b = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    return ((b << np.uint64(32)) | np.arange(m, dtype=np.uint64)[None, :]).reshape(-1)


def _cas(a, b, asc):
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    return np.where(asc, lo, hi), np.where(asc, hi, lo)


def _block_pass(v, base, m, k_lo, k_hi, j_cap, e_n, t_n):
    """The kernel's stages on blocks v (blocks, t_n, e_n) in layout A
    (v[b, t, e] is element base[b] + t * e_n + e), 32-lane warps; two blocks
    with j_cap = e_n * t_n are a cluster pair."""
    t = np.arange(t_n)[None, :, None]
    a0 = base[:, None, None] + t * e_n  # each thread's element 0
    k = k_lo
    while k <= k_hi:
        whole = k >= m
        j = min(k >> 1, j_cap)
        if j >= e_n * t_n:  # the pair: rank 0 keeps the min, rank 1 the max
            v = np.stack([np.minimum(v[0], v[1]), np.maximum(v[0], v[1])])
            j >>= 1
        if j >= t_n:  # to layout B: vb[b, t, e] is element e * t_n + t
            vb = v.reshape(len(v), e_n, t_n).transpose(0, 2, 1).copy()
            h = e_n >> 1
            while h >= 1:
                if t_n * h <= j:
                    for e in range(e_n):
                        if not e & h:
                            low = base[:, None] + np.arange(t_n)[None, :] + e * t_n
                            vb[:, :, e], vb[:, :, e + h] = _cas(vb[:, :, e], vb[:, :, e + h],
                                                                whole | ((low & k) == 0))
                h >>= 1
            v = vb.transpose(0, 2, 1).reshape(len(v), t_n, e_n).copy()
            j = t_n >> 1
        while j >= e_n:  # shuffles: element e of thread t ^ (j / e_n), same warp
            lanes = j // e_n
            assert lanes < 32
            other = v[:, np.arange(t_n) ^ lanes, :]
            keep_min = ((t & lanes) == 0) == (whole | ((a0 & k) == 0))
            v = np.where(keep_min, np.minimum(v, other), np.maximum(v, other))
            j >>= 1
        h = e_n >> 1
        while h >= 1:
            if h <= j:
                for e in range(e_n):
                    if not e & h:
                        v[..., e], v[..., e + h] = _cas(v[..., e], v[..., e + h],
                                                        whole | (((a0[..., 0] + e) & k) == 0))
            h >>= 1
        k <<= 1
    return v


def emulate_sort(key, e_n, t_n):
    """csrc/sort.cu's passes over the packed keys of a (c, m) key, for a
    block of t_n threads of e_n keys (t_n / 32 = e_n): whole segments in a
    block, a cluster pair at m = 2 blocks, else the chunked path. Returns
    the sorted packed keys (c * m,)."""
    c, m = key.shape
    n_b = e_n * t_n
    total = c * m
    x = _pack(key)
    blocks = -(-total // n_b)
    x = np.concatenate([x, np.full(blocks * n_b - total, ~np.uint64(0), np.uint64)])
    base = np.arange(blocks) * n_b
    if m <= 2 * n_b:
        step = 2 if m == 2 * n_b else 1
        for b in range(0, blocks, step):
            sl = slice(b * n_b, (b + step) * n_b)
            v = _block_pass(x[sl].reshape(step, t_n, e_n), base[b:b + step], m, 2, m, n_b, e_n, t_n)
            x[sl] = v.reshape(-1)
        return x[:total]
    x = _block_pass(x.reshape(blocks, t_n, e_n), base, m, 2, n_b, n_b // 2, e_n, t_n).reshape(-1)
    idx = np.arange(total)
    k = 2 * n_b
    while k <= m:
        j = k >> 1
        while j >= n_b:  # the device-memory stage: a thread a pair
            low = idx[(idx & j) == 0]
            x[low], x[low + j] = _cas(x[low], x[low + j], ((low & (m - 1)) & k) == 0)
            j >>= 1
        x = _block_pass(x.reshape(blocks, t_n, e_n), base, m, k, k, n_b // 2, e_n, t_n).reshape(-1)
        k <<= 1
    return x


@pytest.mark.parametrize("e_n,t_n,c,m", [
    (16, 512, 2, 16384),  # the kernel's shape: a cluster pair
    (16, 512, 3, 4096),  # whole segments, a ragged last block
    (16, 512, 2, 65536),  # the chunked path
    (4, 128, 3, 256),  # a block of 512: short segments, several a block
    (4, 128, 2, 1024),  # a cluster pair
    (4, 128, 1, 4096),  # the chunked path, three merge sizes past a block
    (4, 128, 5, 2), (4, 128, 3, 1),
])
def test_emulated_sort_network_equals_stable_sort(e_n, t_n, c, m):
    """The kernel's stage schedule and its three layouts (in-thread,
    shuffles, the transposed block) sort the packed keys of duplicate-heavy
    keys with signed zeros and sentinel tails into the stable order, on
    every path, at the kernel's shape and at one scaled down to blocks of
    512."""
    key = _keys(c, m, seed=m + c)[0]
    got = emulate_sort(key, e_n, t_n).reshape(c, m)
    stable = np.argsort(np.where(key == 0, np.float32(0), key), axis=1, kind="stable")
    want = np.take_along_axis(_pack(key).reshape(c, m), stable, axis=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal((got & 0xFFFFFFFF).astype(np.int64), stable)

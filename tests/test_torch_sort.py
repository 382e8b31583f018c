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
from torch_parity import to_np


def _keys(c, m, seed):
    """Duplicate-heavy keys with a PAD_COORD tail in every other segment
    and signed zeros scattered through them; payloads a, b (f32), o (i32)."""
    rng = np.random.default_rng(seed)
    key = (rng.integers(-m // 16, m // 16, size=(c, m)) * 0.5).astype(np.float32)
    zeros = rng.uniform(size=(c, m)) < 0.05
    key[zeros] = np.where(rng.uniform(size=int(zeros.sum())) < 0.5, -0.0, 0.0)
    key[::2, ::3] = PAD_COORD
    a = rng.normal(size=(c, m)).astype(np.float32)
    b = rng.normal(size=(c, m)).astype(np.float32)
    o = rng.permutation(c * m).reshape(c, m).astype(np.int32)
    return key, a, b, o


def _assert_bits_equal(got, want):
    for g, w in zip(got, want):
        g, w = to_np(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))  # -0.0 != +0.0 here


@pytest.mark.parametrize("c,m", [(4, 1024), (2, 4096)])
def test_plain_sort_matches_pallas_interpret(c, m):
    key, a, b, o = _keys(c, m, seed=m)
    want = j_sort_segments(jnp.asarray(key), (jnp.asarray(a), jnp.asarray(b), jnp.asarray(o)),
                           interpret=True)
    before = dict(sort_cuda.LAUNCHES)
    got = sort_segments(torch.as_tensor(key), tuple(torch.as_tensor(x) for x in (a, b, o)))
    assert sort_cuda.LAUNCHES == before  # CPU tensors: the plain version ran
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c,m", [(3, 2), (64, 128), (4, 16384), (2, 65536)])
def test_cuda_sort_matches_plain(cuda_device, c, m):
    key, a, _, o = _keys(c, m, seed=7)
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

"""Port parity: `horn_align` and `umeyama_align` against `icpx`, on the
cases of tests/test_horn.py (exact, noisy, weighted, batched, planar,
scaled), inputs made with numpy from a seed. Tolerance: R, t and s within
1e-5 of the JAX package's on every case, and the JAX tests' own GT gates.
"""

import numpy as np
import pytest
import torch

from icpx.registration.horn import horn_align as j_horn
from icpx.registration.horn import umeyama_align as j_umeyama
from icpx_torch.registration.horn import horn_align, umeyama_align
from torch_parity import rotation, to_np


def _case(name):
    """(src, dst, weights or None, R_gt, t_gt, scale) in float32 numpy."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "batched":
        R = np.stack([rotation(rng, 2.0) for _ in range(4)])
        t = rng.uniform(-1, 1, (4, 3)).astype(np.float32)
        src = rng.normal(size=(4, 64, 3)).astype(np.float32)
        dst = np.einsum("bij,bnj->bni", R, src) + t[:, None, :]
        return src, dst.astype(np.float32), None, R, t, 1.0
    R = rotation(rng, 3.0)
    t = rng.uniform(-5, 5, 3).astype(np.float32)
    n = {"noisy": 2000, "weighted": 100, "scaled": 300}.get(name, 200)
    src = rng.normal(size=(n, 3)).astype(np.float32)
    if name == "planar":
        src[:, 2] = 0.0
    s = 2.5 if name == "scaled" else 1.0
    dst = (s * src @ R.T + t).astype(np.float32)
    w = None
    if name == "noisy":
        dst = dst + 0.01 * rng.normal(size=dst.shape).astype(np.float32)
    elif name == "weighted":
        dst[:10] += 50.0  # corrupt 10 pairs, weight them out
        w = np.ones(n, np.float32)
        w[:10] = 0.0
    return src, dst, w, R, t, s


CASES = ("exact", "noisy", "weighted", "batched", "planar", "scaled")


@pytest.mark.parametrize("name", CASES)
def test_horn_matches_jax(name):
    src, dst, w, R_gt, t_gt, scale = _case(name)
    tw = None if w is None else torch.as_tensor(w)
    if name == "scaled":
        est, s = umeyama_align(torch.as_tensor(src), torch.as_tensor(dst), tw)
        j_est, j_s = j_umeyama(src, dst, w)
        np.testing.assert_allclose(to_np(s), np.asarray(j_s), atol=1e-5)
        assert abs(float(s) - scale) < 1e-3
    else:
        est = horn_align(torch.as_tensor(src), torch.as_tensor(dst), tw)
        j_est = j_horn(src, dst, w)
    R, t = to_np(est.R), to_np(est.t)
    np.testing.assert_allclose(R, np.asarray(j_est.R), atol=1e-5)
    np.testing.assert_allclose(t, np.asarray(j_est.t), atol=1e-5)
    # the JAX tests' gates against the ground truth
    gate = {"noisy": 2e-3, "batched": 1e-3}.get(name, 1e-4 if name != "scaled" else 1e-3)
    np.testing.assert_allclose(R, R_gt, atol=10 * gate)
    if name == "planar":  # a proper rotation despite rank-2 cross-covariance
        assert abs(float(np.linalg.det(R)) - 1.0) < 1e-4
        np.testing.assert_allclose(src @ R.T + t, dst, atol=1e-4)


def test_umeyama_unit_scale_matches_horn():
    """Without a scale in the data, Umeyama gives s = 1 and Horn's R, t."""
    src, dst, _, _, _, _ = _case("exact")
    est, s = umeyama_align(torch.as_tensor(src), torch.as_tensor(dst))
    h = horn_align(torch.as_tensor(src), torch.as_tensor(dst))
    assert abs(float(s) - 1.0) < 1e-5
    np.testing.assert_allclose(to_np(est.R), to_np(h.R), atol=1e-5)


def test_numpy_input_lands_where_asked():
    """numpy arrays, as the reference's callers pass them, land on `device`
    (the card when it is not given, see test_entry_points_default_to_the_card)
    and give what the same CPU tensors give."""
    src, dst, w, _, _, _ = _case("weighted")
    est = horn_align(src, dst, w, device="cpu")
    ref = horn_align(torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(w))
    assert est.R.device == est.t.device == torch.device("cpu")
    assert torch.equal(est.R, ref.R) and torch.equal(est.t, ref.t)
    est_s, s = umeyama_align(src, dst, w, device="cpu")
    assert s.device == torch.device("cpu") and torch.equal(est_s.R, ref.R)

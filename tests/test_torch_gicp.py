"""Port parity: GICP (generalized ICP, plane-to-plane) in `icpx_torch`
against `icpx`.

Units: `inv3x3`, `build_normal_equations_gicp` and `gicp_cov_rot` on the
same random inputs (rtol 1e-4 on the 6x6 system, as the other objectives'
unit tests; 1e-5 on the inverse and the rotated covariances).

Covariances (`estimate_covariances`): the regularised C = V diag(eps, 1, 1)
V^T depends only on the smallest-eigenvalue direction n (C = I - (1 - eps)
n n^T), so two solvers agree wherever n is well separated from the other
two directions. Brute (kNN, k = 15) at 3,000 points: every row within 1e-4
but a near-isotropic few (>= 99.9% of rows). Block (radius moments off a
KD index, 40,000 points): rows with fewer than 3 neighbours in the radius
get the identity and are compared apart (the same rows on >= 99.9%); the
others within 1e-4 on >= 99.5% (radius-border flips change a neighbourhood
by one point).

`register()`: on tests/test_additions.py::test_gicp_converges's pair
(2,500 points, the brute path) the transform within 1e-5 and the same
iteration count; on the 16,384-point block pair under every payload mode
("auto", "gather", "infold", and "vmem", "vmem7", "select": the plain
fold6, fold7 and select on the CPU, a 12-wide payload) and block_fused
"on" (the JAX fused4 in interpret mode) the transform within 1e-5 of the
JAX package's, both within 5e-3 of the GT, iteration counts within 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icpx.cloud import PointCloud as JCloud
from icpx.geometry.se3 import SE3 as JSE3
from icpx.geometry.transforms import make_rigid_perturbation as j_perturb
from icpx.io.loaders import synthetic_surface
from icpx.kernels import blocknn_pallas
from icpx.kernels.normals import estimate_covariances as j_estimate_covariances
from icpx.registration import linearize as jlin
from icpx.registration.icp import ICPConfig as JConfig
from icpx.registration.icp import gicp_cov_rot as j_gicp_cov_rot
from icpx.registration.icp import register as j_register
from icpx_torch.geometry.se3 import SE3
from icpx_torch.kernels.normals import estimate_covariances
from icpx_torch.utils import profiling
from icpx_torch.registration import linearize as tlin
from icpx_torch.registration.icp import gicp_cov_rot, register
from torch_parity import clouds, to_np, torch_cloud, torch_config, torch_se3


def _spd(rng, n):
    """Random GICP-like covariances: I - (1 - eps) n n^T in random frames."""
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (np.eye(3, dtype=np.float32) - (1 - 1e-3) * v[:, :, None] * v[:, None, :]).astype(np.float32)


def test_inv3x3_matches_jax():
    rng = np.random.default_rng(0)
    M = np.concatenate([
        _spd(rng, 200) + _spd(rng, 200),  # what GICP inverts: C_q + C_p
        rng.normal(size=(200, 3, 3)).astype(np.float32),
        np.zeros((1, 3, 3), np.float32),  # det 0: replaced by 1e-12
    ])
    got = to_np(tlin.inv3x3(torch.as_tensor(M)))
    want = np.asarray(jlin.inv3x3(jnp.asarray(M)))
    # each entry within 1e-5 of its own size plus 1e-5 of its matrix's largest
    tol = 1e-5 * np.abs(want) + 1e-5 * np.abs(want).max(axis=(1, 2), keepdims=True)
    assert (np.abs(got - want) <= tol).all(), float(np.max(np.abs(got - want) / tol))
    eye = np.einsum("nij,njk->nik", M[:200].astype(np.float64), got[:200])
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-3)


def test_gicp_normal_equations_match_jax():
    rng = np.random.default_rng(1)
    n = 500
    p = rng.normal(size=(n, 3)).astype(np.float32)
    q = (p + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    cp, cq = _spd(rng, n), _spd(rng, n)
    w = rng.uniform(0, 1, n).astype(np.float32)
    w[::7] = 0.0
    p_bar = (p * w[:, None]).sum(0) / w.sum()
    ne_j = jlin.build_normal_equations_gicp(*(jnp.asarray(a) for a in (p, q, cp, cq, w, p_bar)))
    ne_t = tlin.build_normal_equations_gicp(*(torch.as_tensor(a) for a in (p, q, cp, cq, w, p_bar)))
    for f in ne_j._fields:
        want = np.asarray(getattr(ne_j, f))
        np.testing.assert_allclose(to_np(getattr(ne_t, f)), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=f)


def test_gicp_cov_rot_matches_jax():
    rng = np.random.default_rng(2)
    aux = _spd(rng, 300).reshape(300, 9)
    jT = j_perturb(angle=0.7, translation=(1.0, -2.0, 0.5))
    got = to_np(gicp_cov_rot(torch_se3(jT), torch.as_tensor(aux)))
    np.testing.assert_allclose(got, np.asarray(j_gicp_cov_rot(jT, jnp.asarray(aux))), atol=1e-5)
    # R C R^T of a symmetric C stays symmetric, with C's eigenvalues
    C = got.reshape(-1, 3, 3)
    np.testing.assert_allclose(C, C.transpose(0, 2, 1), atol=1e-6)
    np.testing.assert_allclose(np.linalg.eigvalsh(C), np.linalg.eigvalsh(aux.reshape(-1, 3, 3)), atol=1e-5)


def _cov_agreement(jc, tc, k, method):
    want = j_estimate_covariances(jc, k=k, method=method)
    got = estimate_covariances(tc, k=k, method=method)
    cj, ct = np.asarray(want.covs), to_np(got.covs)
    valid = np.asarray(jc.mask)
    eye = np.eye(3, dtype=np.float32)
    assert (ct[~valid] == eye).all()  # pad rows: the identity
    id_j = (cj == eye).all((1, 2)) & valid
    id_t = (ct == eye).all((1, 2)) & valid
    err = np.abs(ct - cj).max((1, 2))
    both = valid & ~id_j & ~id_t
    # normals filled from the same directions (unoriented: up to sign)
    dots = np.abs((np.asarray(want.normals) * to_np(got.normals)).sum(1))[both]
    return id_j, id_t, err[both], dots, valid


def test_brute_covariances_match_jax():
    """The coordinates are whole multiples of 2^-10 (|x| <= 1), so every
    squared distance of the kNN's expansion ||q||^2 + ||r||^2 - 2 q.r is
    exact in fp32, whatever order or fusion the matrix product takes.
    Both packages then rank the same neighbours (ties to the lower index),
    and the result no longer depends on which CPU kernel path each one's
    BLAS picks: with the surface's raw coordinates, a run now and then had
    one package's distances round differently, and 5% of the rows took
    another 15th neighbour (errors up to ~7e-4)."""
    xyz = synthetic_surface(3000, seed=5)
    jc, tc = clouds((np.round(xyz * 1024.0) / 1024.0).astype(np.float32))
    id_j, id_t, err, dots, valid = _cov_agreement(jc, tc, 15, "brute")
    assert not id_j.any() and not id_t.any()  # k = 15 neighbours everywhere
    assert (err <= 1e-4).mean() >= 0.999 and err.max() < 1e-2, float(np.sort(err)[-5:].min())
    assert (dots > 1 - 1e-4).mean() >= 0.999


def test_block_covariances_match_jax():
    jc, tc = clouds(synthetic_surface(40000, seed=6))
    id_j, id_t, err, dots, valid = _cov_agreement(jc, tc, 15, "block")
    assert (id_j == id_t)[valid].mean() >= 0.999
    assert (err <= 1e-4).mean() >= 0.995, float((err <= 1e-4).mean())
    assert (dots > 1 - 1e-4).mean() >= 0.995


def test_block_covariances_through_the_fused_moments():
    """`_block_radius_cov(..., fused=True)` takes the reference's fused
    branch (the union-moments kernel's plain version on the CPU): the same
    covariances as the JAX package with its fused branch switched on and
    the Pallas kernel in interpret mode, and only where the tile count
    divides by 4."""
    import functools

    from icpx.kernels import blocknn_pallas
    from icpx.kernels.normals import _block_radius_cov as j_cov
    from icpx_torch.kernels.normals import _block_radius_cov

    x = synthetic_surface(12000, seed=8)
    jc, tc = clouds(x)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocknn_pallas, "use_fused_default", lambda: True)
        mp.setattr(blocknn_pallas, "block_radius_moments_fused",
                   functools.partial(blocknn_pallas.block_radius_moments_fused, interpret=True))
        cnt_j, cov_j = (np.asarray(a) for a in j_cov(jc.xyz, jc.mask, 15))
    before = dict(profiling.LAUNCHES)
    cnt_t, cov_t = (to_np(a) for a in _block_radius_cov(tc.xyz, tc.mask, 15, fused=True))
    cnt_x, _ = _block_radius_cov(tc.xyz, tc.mask, 15, fused=False)
    assert profiling.LAUNCHES == before
    valid = np.asarray(jc.mask)
    same = (cnt_t == cnt_j)[valid]
    assert same.mean() >= 0.999
    assert (cnt_t >= to_np(cnt_x))[valid].mean() >= 0.999  # the union: a superset
    assert (cnt_t > to_np(cnt_x))[valid].any()  # padded slots counted again
    err = np.abs(cov_t - cov_j).max((1, 2))[valid][same]
    scale = np.abs(cov_j).max((1, 2))[valid][same]
    assert (err <= 1e-3 * scale + 1e-9).mean() >= 0.999


def _brute_pair():
    """tests/test_additions.py::test_gicp_converges's construction."""
    xyz = synthetic_surface(2500, seed=4)
    src = JCloud.create(xyz)
    axis = np.array([0.1, -0.2, 0.97])
    axis = axis / np.linalg.norm(axis)
    gt = JSE3.from_axis_angle(jnp.asarray(axis, jnp.float32), 0.2,
                              jnp.asarray([0.1, -0.05, 0.03], jnp.float32))
    tgt = JCloud.create(np.asarray(gt.apply(src.xyz))[:2500][np.random.default_rng(7).permutation(2500)])
    return src, tgt, gt


def test_gicp_register_brute_matches_jax():
    src, tgt, gt = _brute_pair()
    jcfg = JConfig(objective="gicp", max_iters=20, diff_threshold=1e-5)
    jres = j_register(src, tgt, jcfg)
    cfg = torch_config(jcfg)
    assert cfg.resolve_nn(tgt.capacity) == "brute"
    res = register(torch_cloud(src), torch_cloud(tgt), cfg)
    assert res.iters == int(jres.iters)
    np.testing.assert_allclose(to_np(res.transform.R), np.asarray(jres.transform.R), atol=1e-5)
    np.testing.assert_allclose(to_np(res.transform.t), np.asarray(jres.transform.t), atol=1e-5)
    rot, t = (float(x) for x in res.transform.distance_to(torch_se3(gt)))
    assert rot < 3e-3 and t < 3e-3


N = 16384
MODES = ("gather", "vmem", "infold", "select", "vmem7", "fused")


@pytest.fixture(scope="module")
def block_pair():
    """The 16,384-point block pair of tests/test_torch_block_registration.py
    and one JAX GICP registration under each mode (the Pallas kernels in
    interpret mode: the JAX fused4 wrapper does not switch to it off the
    TPU, so it is given interpret=True); "auto" resolves to "gather" off
    the TPU."""
    xyz = synthetic_surface(N, seed=3)
    src = JCloud.create(xyz, capacity=N)
    gt = j_perturb(angle=0.15, translation=(0.1, -0.05, 0.02))
    perm = np.random.default_rng(0).permutation(N)
    tgt = JCloud.create(np.asarray(gt.apply(src.xyz))[:N][perm], capacity=N).replace(mask=src.mask[perm])
    # covariances once, handed to both packages (they are held apart above)
    src = j_estimate_covariances(src, k=15)
    tgt = j_estimate_covariances(tgt, k=15)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocknn_pallas, "block_nn_fused4",
                   functools.partial(blocknn_pallas.block_nn_fused4, interpret=True))
        for mode in MODES:
            res = j_register(src, tgt, _cfg(mode))
            jax.block_until_ready(res.transform.R)
            runs[mode] = res
    return src, tgt, gt, runs


def _cfg(mode):
    """"fused" is `block_fused="on"`, at a fixed 3 refine iterations: its
    converged rmse moves by ~3e-6 an iteration on this pair (near-tie
    winners), above rmse_change_tol, so where the stop rule fires would
    compare rounding. The others are payload modes."""
    kw = dict(block_fused="on", max_iters=3, rmse_change_tol=0.0) if mode == "fused" else dict(
        payload_mode=mode, max_iters=8, rmse_change_tol=1e-6)
    return JConfig(objective="gicp", diff_threshold=0.0, **kw)


@pytest.mark.parametrize("mode", ("auto",) + MODES)
def test_gicp_register_block_matches_jax(block_pair, mode):
    src, tgt, gt, runs = block_pair
    jres = runs["gather" if mode == "auto" else mode]
    cfg = torch_config(_cfg(mode))
    assert cfg.resolve_nn(N) == "block"
    assert cfg.resolve_fused() == (mode == "fused")
    assert cfg.resolve_payload(N, torch.device("cpu")) == ("gather" if mode in ("auto", "fused") else mode)
    before = dict(profiling.LAUNCHES)
    res = register(torch_cloud(src), torch_cloud(tgt), cfg)
    assert profiling.LAUNCHES == before  # the CPU runs the plain versions
    np.testing.assert_allclose(to_np(res.transform.R), np.asarray(jres.transform.R), atol=1e-5)
    np.testing.assert_allclose(to_np(res.transform.t), np.asarray(jres.transform.t), atol=1e-5)
    rot, t = (float(x) for x in res.transform.distance_to(torch_se3(gt)))
    j_rot, j_t = (float(x) for x in jres.transform.distance_to(gt))
    assert rot < 5e-3 and t < 5e-3 and j_rot < 5e-3 and j_t < 5e-3
    assert abs(res.iters - int(jres.iters)) <= 1 and res.iters > 2
    assert torch.isfinite(res.final_rmse)


def test_gicp_needs_covariances_and_carries_them():
    """Covariances given up front are used as they are (pad rows the
    identity); `register()` estimates them for a cloud that has none."""
    jc, tc = clouds(synthetic_surface(500, seed=9))
    est = estimate_covariances(tc, k=15)
    assert est.covs.shape == (tc.capacity, 3, 3) and est.normals is not None
    from icpx_torch.cloud import PointCloud

    pc = PointCloud.create(synthetic_surface(500, seed=9), covs=to_np(est.covs)[:500], device="cpu")
    assert torch.equal(pc.covs, est.covs)
    from icpx_torch import interop

    back = interop.cloud_from_numpy(**interop.cloud_to_numpy(est), device="cpu")  # both ways
    assert torch.equal(back.covs, est.covs) and torch.equal(back.normals, est.normals)
    res = register(est, est, torch_config(JConfig(objective="gicp")))
    assert float(res.transform.t.norm()) < 1e-3
    with pytest.raises(ValueError, match="covs"):
        PointCloud.create(synthetic_surface(10, seed=1), covs=np.zeros((9, 3, 3)), device="cpu")
    assert isinstance(res.transform, SE3)

"""Port parity: the coarse-to-fine pyramid (`morton_stratified_subsample`,
`register_pyramid`) and NDT (`ndt_cells`, `register_ndt` in "p2d" and
"d2d"), against `icpx`.

Tolerances: the subsample bit-equal; each pyramid level's transform within
1e-4 (tests/test_pyramid.py's 4,000-point pair at 0.9 rad); cell means
within 1e-5 and covariances within `torch_fixtures._cov_tol` (1e-4 of a
cell's trace) but for near-isotropic cells, whose eigenvectors the closed
form resolves differently at fp32 rounding, held apart by their
eigenvalues (within 1e-4 of the trace) and their trace; `register_ndt`'s
transform within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from icpx.cloud import PointCloud as JCloud
from icpx.geometry.se3 import SE3 as JSE3
from icpx.geometry.transforms import make_rigid_perturbation as j_perturb
from icpx.io.loaders import synthetic_surface
from icpx.registration.icp import ICPConfig as JConfig
from icpx.registration.ndt import ndt_cells as j_ndt_cells
from icpx.registration.ndt import register_ndt as j_register_ndt
from icpx.registration.pyramid import PyramidConfig as JPyramidConfig
from icpx.registration.pyramid import morton_stratified_subsample as j_subsample
from icpx.registration.pyramid import register_pyramid as j_register_pyramid
from icpx_torch.registration.ndt import ndt_cells, register_ndt
from icpx_torch.registration.pyramid import morton_stratified_subsample, register_pyramid
from torch_parity import to_np, torch_cloud, torch_pyramid_config

FIELDS = ("xyz", "mask", "normals", "covs", "feats")


def _pyramid_pair(n=4000, angle=0.9, trans=(0.8, -0.5, 0.3), seed=0):
    """tests/test_pyramid.py's pair."""
    src = JCloud.create(synthetic_surface(n, seed=seed))
    axis = np.array([0.2, -0.1, 0.97])
    axis /= np.linalg.norm(axis)
    gt = JSE3.from_axis_angle(jnp.asarray(axis, jnp.float32), angle, jnp.asarray(trans, jnp.float32))
    perm = np.random.default_rng(seed + 1).permutation(n)
    tgt = JCloud.create(np.asarray(gt.apply(src.xyz))[:n][perm])
    return src, tgt, gt


@pytest.mark.parametrize("stride", [1, 4, 16])
def test_subsample_matches_jax(stride):
    """Every field, features and identity pad covariances included."""
    rng = np.random.default_rng(stride)
    n = 1000
    xyz = synthetic_surface(n, seed=2)
    jc = JCloud.create(xyz, rng.normal(size=(n, 3)).astype(np.float32),
                       feats=rng.uniform(size=(n, 2)).astype(np.float32), feat_names=("a", "b"))
    c = rng.normal(size=(jc.capacity, 3, 3)).astype(np.float32)
    jc = jc.replace(covs=jnp.asarray(c), mask=jc.mask.at[::7].set(False))
    sub_t = morton_stratified_subsample(torch_cloud(jc), stride)
    sub_j = j_subsample(jc, stride)
    for f in FIELDS:
        np.testing.assert_array_equal(to_np(getattr(sub_t, f)), np.asarray(getattr(sub_j, f)),
                                      err_msg=f)
    assert sub_t.feat_names == sub_j.feat_names


def test_register_pyramid_matches_jax():
    src, tgt, gt = _pyramid_pair()
    jcfg = JPyramidConfig(levels=3, subsample=4,
                          base=JConfig(objective="symmetric", max_iters=15, diff_threshold=1e-5,
                                       robust="tukey"))
    jres, jlevels = j_register_pyramid(src, tgt, jcfg)
    cfg = torch_pyramid_config(jcfg)
    assert cfg == torch_pyramid_config(jcfg) and cfg.base.robust == "tukey"
    res, levels = register_pyramid(torch_cloud(src), torch_cloud(tgt), cfg)
    assert len(levels) == len(jlevels) == 3 and res is levels[-1]
    for lvl, (r, jr) in enumerate(zip(levels, jlevels)):
        np.testing.assert_allclose(to_np(r.transform.R), np.asarray(jr.transform.R), atol=1e-4,
                                   err_msg=f"level {lvl}")
        np.testing.assert_allclose(to_np(r.transform.t), np.asarray(jr.transform.t), atol=1e-4,
                                   err_msg=f"level {lvl}")
    rot, t = (float(x) for x in jres.transform.distance_to(gt))
    assert rot < 5e-3 and t < 5e-3


def _ndt_pair(n=10000):
    """tests/test_registration.py's NDT pair."""
    src = JCloud.create(synthetic_surface(n, seed=3))
    gt = j_perturb(angle=0.12, translation=(0.08, -0.04, 0.02))
    tgt_np = np.asarray(gt.apply(src.xyz))[:n]
    tgt = JCloud.create(tgt_np[np.random.default_rng(4).permutation(n)])
    return src, tgt, gt


def test_ndt_cells_match_jax():
    _, tgt, _ = _ndt_pair()
    cj = j_ndt_cells(tgt, cell_size=64)
    ct = ndt_cells(torch_cloud(tgt), cell_size=64)
    mask = np.asarray(cj.mask)
    np.testing.assert_array_equal(to_np(ct.mask), mask)
    assert mask.sum() >= 10000 // 64 - 2
    np.testing.assert_allclose(to_np(ct.xyz)[mask], np.asarray(cj.xyz)[mask], atol=1e-5)
    assert (to_np(ct.xyz)[~mask] == np.asarray(cj.xyz)[~mask]).all()  # the sentinel
    cov_t, cov_j = to_np(ct.covs).astype(np.float64), np.asarray(cj.covs, np.float64)
    eig_t, eig_j = np.linalg.eigvalsh(cov_t), np.linalg.eigvalsh(cov_j)
    trace = np.trace(cov_j, axis1=1, axis2=2)
    tol = 1e-4 * trace
    # near-isotropic cells: two regularised eigenvalues within 1e-3 of the trace
    iso = (np.diff(eig_j, axis=1) < 1e-3 * trace[:, None]).any(1) & mask
    plain = mask & ~iso
    err = np.abs(cov_t - cov_j).max((1, 2))
    assert (err[plain] <= tol[plain]).all(), (err / tol)[plain].max()
    assert (np.abs(eig_t - eig_j)[iso] <= tol[iso, None]).all()
    assert plain.sum() > 0.5 * mask.sum()
    assert (eig_t[mask] > 0).all()  # SPD after the clamp


@pytest.mark.parametrize("mode", ["p2d", "d2d"])
def test_register_ndt_matches_jax(mode):
    src, tgt, gt = _ndt_pair()
    jres = j_register_ndt(src, tgt, cell_size=64, mode=mode)
    res = register_ndt(torch_cloud(src), torch_cloud(tgt), cell_size=64, mode=mode)
    np.testing.assert_allclose(to_np(res.transform.R), np.asarray(jres.transform.R), atol=1e-4)
    np.testing.assert_allclose(to_np(res.transform.t), np.asarray(jres.transform.t), atol=1e-4)
    if mode == "p2d":  # the reference's own gate (cell-quantisation accuracy)
        rot, t = (float(x) for x in jres.transform.distance_to(gt))
        assert rot < 5e-3 and t < 2e-2
    with pytest.raises(ValueError, match="p2d"):
        register_ndt(torch_cloud(src), torch_cloud(tgt), mode="icp")


def ndt_point_cov_run(n, point_cov, packages=("jax", "torch")):
    """NDT "p2d" on `chip_smoke._gt_pair`'s construction at n points (a
    synthetic surface and its image under 0.2 rad about z and (0.12, -0.06,
    0.03), shuffled by default_rng(1)), cells of 64, chip_smoke's config,
    the source's covariance point_cov * I: {package: (iters, rot, t)}, both
    on the CPU."""
    from icpx_torch.registration.icp import ICPConfig

    xyz = synthetic_surface(n, seed=0)
    gt = j_perturb(axis=(0.0, 0.0, 1.0), angle=0.2, translation=(0.12, -0.06, 0.03))
    perm = np.random.default_rng(1).permutation(n)
    src = JCloud.create(xyz, capacity=n)
    tgt = JCloud.create(np.asarray(gt.apply(src.xyz))[perm], capacity=n).replace(mask=src.mask[perm])
    kw = dict(max_iters=30, diff_threshold=0.0, rmse_change_tol=1e-6, robust="huber")
    out = {}
    if "jax" in packages:
        res = j_register_ndt(src, tgt, JConfig(**kw), cell_size=64, mode="p2d", point_cov=point_cov)
        out["jax"] = (int(res.iters), *(float(x) for x in res.transform.distance_to(gt)))
    if "torch" in packages:
        res = register_ndt(torch_cloud(src), torch_cloud(tgt), ICPConfig(**kw), cell_size=64,
                           mode="p2d", point_cov=point_cov)
        est = JSE3(R=jnp.asarray(to_np(res.transform.R)), t=jnp.asarray(to_np(res.transform.t)))
        out["torch"] = (res.iters, *(float(x) for x in est.distance_to(gt)))
    return out


if __name__ == "__main__":
    # python tests/test_torch_pyramid_ndt.py N POINT_COV [jax|torch]: how NDT
    # p2d's error grows with the cloud's density at a fixed point_cov, in
    # both packages (chip_smoke.py's NDT_POINT_COV)
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    n, cov = int(sys.argv[1]), float(sys.argv[2])
    which = tuple(sys.argv[3:]) or ("jax", "torch")
    for pkg, (iters, rot, t) in ndt_point_cov_run(n, cov, which).items():
        print(f"{pkg:5s} n={n} point_cov={cov:g}: iters={iters} rot={rot:.4e} t={t:.4e}", flush=True)

"""Port parity: `register_batch` (brute NN, normals given) against `icpx`,
on tests/test_additions.py's three 768-point pairs, plus `register_xyz`,
`result_struct` and the batched result's layout.

Tolerances: each pair's R and t within 1e-5 of the reference's vmapped
run, the same iteration count, and within 1e-6 of the port's `register()`
on that pair alone with the same normals.
"""

import jax.numpy as jnp
import numpy as np
import torch

from icpx.cloud import PointCloud as JCloud
from icpx.geometry.se3 import SE3 as JSE3
from icpx.io.loaders import synthetic_surface
from icpx.kernels.normals import estimate_normals as j_normals
from icpx.registration.icp import ICPConfig as JConfig
from icpx.registration.icp import register_batch as j_register_batch
from icpx.registration.icp import register_xyz as j_register_xyz
from icpx_torch import interop
from icpx_torch.geometry.se3 import SE3
from icpx_torch.registration.icp import (ICPResult, register, register_batch, register_xyz,
                                         result_struct)
from torch_parity import to_np, torch_cloud, torch_config


def _pairs(b=3, n=768):
    srcs, tgts, gts = [], [], []
    for i in range(b):
        s = j_normals(JCloud.create(synthetic_surface(n, seed=30 + i), capacity=n), k=8)
        gt = JSE3.from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]), 0.1 + 0.05 * i,
                                  jnp.asarray([0.05, -0.02 * i, 0.0]))
        perm = np.random.default_rng(i).permutation(n)
        t = j_normals(JCloud.create(np.asarray(gt.apply(s.xyz))[:n][perm], capacity=n), k=8)
        srcs.append(s)
        tgts.append(t)
        gts.append(gt)
    return srcs, tgts, gts


def _stack(clouds, field):
    return np.stack([np.asarray(getattr(c, field)) for c in clouds])


def test_register_batch_matches_jax_and_single_pairs():
    srcs, tgts, gts = _pairs()
    cfg = JConfig(max_iters=10, diff_threshold=1e-5, k_normals=8, tile_q=256, tile_r=256)
    fields = [(srcs, "xyz"), (srcs, "mask"), (srcs, "normals"),
              (tgts, "xyz"), (tgts, "mask"), (tgts, "normals")]
    jres = j_register_batch(*(jnp.asarray(_stack(c, f)) for c, f in fields), cfg)
    tcfg = torch_config(cfg)
    res = register_batch(*(torch.as_tensor(_stack(c, f)) for c, f in fields), tcfg)
    assert isinstance(res, ICPResult)
    assert tuple(res.transform.R.shape) == (3, 3, 3) and tuple(res.diff_history.shape) == (3, 10)
    assert res.iters.dtype == torch.int32 and tuple(res.final_rmse.shape) == (3,)
    np.testing.assert_array_equal(to_np(res.iters), np.asarray(jres.iters))
    np.testing.assert_allclose(to_np(res.transform.R), np.asarray(jres.transform.R), atol=1e-5)
    np.testing.assert_allclose(to_np(res.transform.t), np.asarray(jres.transform.t), atol=1e-5)
    np.testing.assert_array_equal(np.isnan(to_np(res.rmse_history)), np.isnan(np.asarray(jres.rmse_history)))
    for i, gt in enumerate(gts):
        est = SE3(R=res.transform.R[i], t=res.transform.t[i])
        rot, t = (float(x) for x in est.distance_to(SE3(R=torch.as_tensor(np.asarray(gt.R)),
                                                         t=torch.as_tensor(np.asarray(gt.t)))))
        assert rot < 5e-3 and t < 5e-3, i
        alone = register(torch_cloud(srcs[i]), torch_cloud(tgts[i]), tcfg)
        assert alone.iters == int(res.iters[i])
        np.testing.assert_allclose(to_np(alone.transform.R), to_np(res.transform.R[i]), atol=1e-6)
        np.testing.assert_allclose(to_np(alone.transform.t), to_np(res.transform.t[i]), atol=1e-6)
    host = interop.result_to_numpy(res)
    assert host["R"].shape == (3, 3, 3) and host["iters"].shape == (3,)


def test_register_batch_with_init():
    """A batched initial guess is taken pair by pair: starting at the GT,
    each pair stays there."""
    srcs, tgts, gts = _pairs(b=2)
    cfg = JConfig(max_iters=4, diff_threshold=1e-5, k_normals=8, tile_q=256, tile_r=256)
    fields = [(srcs, "xyz"), (srcs, "mask"), (srcs, "normals"),
              (tgts, "xyz"), (tgts, "mask"), (tgts, "normals")]
    init_np = (np.stack([np.asarray(g.R) for g in gts]), np.stack([np.asarray(g.t) for g in gts]))
    jres = j_register_batch(*(jnp.asarray(_stack(c, f)) for c, f in fields), cfg,
                            JSE3(R=jnp.asarray(init_np[0]), t=jnp.asarray(init_np[1])))
    res = register_batch(*(torch.as_tensor(_stack(c, f)) for c, f in fields), torch_config(cfg),
                         SE3(R=torch.as_tensor(init_np[0]), t=torch.as_tensor(init_np[1])))
    np.testing.assert_allclose(to_np(res.transform.R), np.asarray(jres.transform.R), atol=1e-5)
    np.testing.assert_allclose(to_np(res.transform.t), np.asarray(jres.transform.t), atol=1e-5)
    np.testing.assert_allclose(to_np(res.transform.t), init_np[1], atol=5e-3)


def test_register_xyz_matches_jax():
    """Raw (n, 3) arrays, padded by `register_xyz` itself (n not a multiple
    of 128), on the brute path."""
    srcs, tgts, _ = _pairs(b=1, n=700)
    s, t = np.asarray(srcs[0].xyz)[:700], np.asarray(tgts[0].xyz)[:700]
    cfg = JConfig(max_iters=8, diff_threshold=1e-5, k_normals=8, tile_q=256, tile_r=256)
    jres = j_register_xyz(s, t, cfg)
    res = register_xyz(s, t, torch_config(cfg), device="cpu")
    np.testing.assert_allclose(to_np(res.transform.R), np.asarray(jres.transform.R), atol=1e-5)
    np.testing.assert_allclose(to_np(res.transform.t), np.asarray(jres.transform.t), atol=1e-5)
    assert res.iters == int(jres.iters)


def test_result_struct_is_all_zero():
    r = result_struct()
    assert r.iters == 0 and r.converged == 0 and r.final_rmse == 0
    assert r.transform.R == 0 and r.transform.t == 0

"""Port parity: `register()` on the block-NN path, against `icpx`, plus the
block path's resolution rules, the options it refuses, the refine-stride
mid phase, `register_batch_block`, the default device of the entry points,
and a run with JAX and `icpx` blocked.

The slice as a whole: a 16,384-point `synthetic_surface` pair (the
construction of tests/test_blocknn.py::test_register_payload_modes_
equivalent), normals estimated inside the registration. Each payload mode
of the port ("vmem", "vmem7", "select": the kernels' plain versions on the
CPU; "gather", "infold": plain torch) and `block_fused="on"` runs against
the same mode of the JAX package (its Pallas kernels in interpret mode).
Tolerances: both recover the GT to 5e-3; final R within 1e-5; iteration
counts within 1; final rmse within 5e-6 for "vmem" (the two folds score by
different fp32 forms, so near-tie matches differ at the converged noise
floor: the port's direct form reaches ~1e-7, the JAX expansion ~4e-6);
below 2e-3 on both for "vmem7" (its bf16 score puts a noise floor of
~(tile extent)^2 * 2^-9 under the reported distances, as
tests/test_blocknn.py allows); below 1e-5 on both for the others.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from icpx.cloud import PointCloud as JCloud
from icpx.kernels import blocknn_pallas
from icpx.geometry.transforms import make_rigid_perturbation as j_perturb
from icpx.io.loaders import synthetic_surface
from icpx.registration.icp import ICPConfig as JConfig
from icpx.registration.icp import register as j_register
from icpx_torch import interop
from icpx_torch.cloud import PointCloud
from icpx_torch.geometry.se3 import SE3
from icpx_torch.geometry.transforms import make_rigid_perturbation
from icpx_torch.io.loaders import load_bunny, load_cat_pair, load_cloud, reference_data_dir
from icpx_torch.io.prefetch import prefetch_kitti
from icpx_torch.odometry import kitti
from icpx_torch.odometry.mapping import VoxelMap
from icpx_torch.registration.horn import horn_align, umeyama_align
from icpx_torch.registration.icp import ICPConfig, _effective_payload_mode, register, register_xyz
from icpx_torch.utils import profiling
from icpx_torch.utils.checkpoint import OdometryCheckpoint, load_checkpoint, save_checkpoint
from torch_parity import to_np, torch_cloud, torch_config, torch_se3

ROOT = Path(__file__).resolve().parent.parent
N = 16384
# the mid phase's pair: the smallest the block path takes by itself
# (block_auto_threshold), as the JAX runs' compiles and interpret-mode
# folds dominate these tests' time
N_SMALL = 8192
CPU = torch.device("cpu")
CUDA = torch.device("cuda")  # a device name only: nothing here allocates on it


def _pair(n=N):
    xyz = synthetic_surface(n, seed=3)
    src = JCloud.create(xyz, capacity=n)
    gt = j_perturb(angle=0.15, translation=(0.1, -0.05, 0.02))
    tgt_np = np.asarray(gt.apply(src.xyz))[:n]
    perm = np.random.default_rng(0).permutation(n)
    tgt = JCloud.create(tgt_np[perm], capacity=n).replace(mask=src.mask[perm])
    return src, tgt, gt


MODES = ("vmem", "gather", "infold", "select", "vmem7", "fused")


def _cfg(mode):
    """"fused" is `block_fused="on"`; the others are payload modes."""
    kw = dict(block_fused="on") if mode == "fused" else dict(payload_mode=mode)
    return JConfig(max_iters=8, diff_threshold=0.0, rmse_change_tol=1e-6, **kw)


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX registration per mode, shared by the tests below. The JAX
    fused4 wrapper does not switch to interpret mode off the TPU (unlike
    the other block kernels' wrappers), so it is given interpret=True here;
    `register` imports it at trace time, which picks the patch up."""
    src, tgt, gt = _pair()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocknn_pallas, "block_nn_fused4",
                   functools.partial(blocknn_pallas.block_nn_fused4, interpret=True))
        for mode in MODES:
            res = j_register(src, tgt, _cfg(mode))
            jax.block_until_ready(res.transform.R)
            out[mode] = res
    return src, tgt, gt, out


@pytest.mark.parametrize("mode", MODES)
def test_block_register_matches_jax(jax_runs, mode):
    src, tgt, gt, runs = jax_runs
    jres = runs[mode]
    # "gather" goes through payload_mode="auto": on the CPU it resolves as
    # the JAX package does off the TPU
    cfg = torch_config(_cfg("auto" if mode == "gather" else mode))
    assert cfg.resolve_nn(N) == "block"
    assert cfg.resolve_fused() == (mode == "fused")
    assert cfg.resolve_payload(N, CPU) == ("gather" if mode == "fused" else mode)
    before = dict(profiling.LAUNCHES)
    res = register(torch_cloud(src), torch_cloud(tgt), cfg)
    assert profiling.LAUNCHES == before  # the CPU runs the plain versions
    rot, t = (float(x) for x in res.transform.distance_to(torch_se3(gt)))
    j_rot, j_t = (float(x) for x in jres.transform.distance_to(gt))
    assert rot < 5e-3 and t < 5e-3 and j_rot < 5e-3 and j_t < 5e-3
    np.testing.assert_allclose(to_np(res.transform.R), np.asarray(jres.transform.R), atol=1e-5)
    assert abs(res.iters - int(jres.iters)) <= 1
    assert res.iters > 2  # the coarse phase's 2 iterations are counted
    if mode == "vmem":
        assert abs(float(res.final_rmse) - float(jres.final_rmse)) < 5e-6
    elif mode == "vmem7":
        assert float(res.final_rmse) < 2e-3 and float(jres.final_rmse) < 2e-3
    else:
        assert float(res.final_rmse) < 1e-5 and float(jres.final_rmse) < 1e-5
    assert torch.isfinite(res.final_rmse) and bool(res.converged)


def test_block_register_with_given_normals_and_weights():
    """Normals given up front skip the in-registration estimate; a source
    weight rides into the sorted order. Same GT gate."""
    src, tgt, gt = _pair()
    jn = JCloud.create(np.asarray(src.xyz)[:N], capacity=N)
    from icpx.kernels.normals import estimate_normals as j_normals

    s_n = j_normals(jn, k=10, method="block")
    t_n = j_normals(tgt, k=10, method="block")
    w = np.random.default_rng(2).uniform(0.5, 1.0, N).astype(np.float32)
    res = register(torch_cloud(s_n), torch_cloud(t_n), torch_config(_cfg("gather")),
                   src_weight=torch.as_tensor(w))
    rot, t = (float(x) for x in res.transform.distance_to(torch_se3(gt)))
    assert rot < 5e-3 and t < 5e-3


def test_resolution_rules():
    cfg = ICPConfig()
    assert cfg.resolve_nn(8191) == "brute" and cfg.resolve_nn(8192) == "block"
    # payload: the fold kernel on the card at every size, the JAX package's
    # off-TPU rule on the CPU; explicit modes win everywhere
    assert cfg.resolve_payload(16384, CUDA) == "vmem"
    assert cfg.resolve_payload(16384, CPU) == "gather"
    assert cfg.resolve_payload(2 * 1024 * 1024, CPU) == "infold"
    assert ICPConfig(payload_mode="gather").resolve_payload(16384, CUDA) == "gather"
    assert ICPConfig(payload_mode="vmem").resolve_payload(16384, CPU) == "vmem"
    # moments: the kernel on the card, XLA-style plain torch on the CPU
    assert cfg.resolve_moments(1 << 20, CUDA) == "vmem"
    assert cfg.resolve_moments(1 << 20, CPU) == "xla"
    assert ICPConfig(moments_mode="xla").resolve_moments(1 << 20, CUDA) == "xla"
    assert ICPConfig(moments_mode="vmem").resolve_moments(1 << 20, CPU) == "vmem"
    # the fold engages only with a frozen candidate list and the 3D metric
    eff = lambda c, n, dev, **kw: _effective_payload_mode(  # noqa: E731
        c, n, dev, **{"use_feat": False, "fused": False, "will_freeze": True, **kw})
    assert eff(cfg, 16384, CUDA) == "vmem"
    assert eff(cfg, 16384, CUDA, will_freeze=False) == "gather"
    assert eff(cfg, 4 * 1024 * 1024, CUDA, will_freeze=False) == "infold"
    assert eff(cfg, 16384, CUDA, fused=True) == "gather"
    assert eff(cfg, 16384, CUDA, use_feat=True) == "gather"
    assert eff(cfg, 16384, CPU) == "gather"
    assert eff(ICPConfig(payload_mode="vmem"), 16384, CPU) == "vmem"
    # the rest, as in the reference
    assert cfg.resolve_score_prec() == "highest"
    assert ICPConfig(score_precision="bf16").resolve_score_prec() == "bf16"
    assert cfg.resolve_q_tile(1 << 20) == 64 and cfg.resolve_q_tile(2 * 1024 * 1024) == 128
    assert cfg.resolve_refine_stride(1 << 20, 1 << 20) == 1
    assert not cfg.resolve_fused() and ICPConfig(block_fused="on").resolve_fused()
    assert cfg.resolve_payload_prec() == "high"
    assert ICPConfig(payload_prec="bf16").resolve_payload_prec() == "bf16"
    # the fused fold freezes nothing: "vmem7" falls back like "vmem"
    assert eff(ICPConfig(payload_mode="vmem7"), 16384, CUDA, fused=True) == "gather"
    assert eff(ICPConfig(payload_mode="vmem7"), 16384, CUDA) == "vmem7"
    assert eff(ICPConfig(payload_mode="select"), 16384, CUDA, will_freeze=False) == "select"
    for jc in (JConfig(), JConfig(payload_mode="gather", score_precision="high")):
        tc = torch_config(jc)
        assert tc.resolve_q_tile(1 << 20) == jc.resolve_q_tile(1 << 20)
        assert tc.resolve_payload(1 << 20, CPU) == jc.resolve_payload(1 << 20)
        assert tc.resolve_moments(1 << 20, CPU) == jc.resolve_moments(1 << 20)
        assert tc.resolve_payload_prec() == jc.resolve_payload_prec()


@pytest.mark.parametrize("mode,wrapper,phases", [
    ("vmem", "block_fold_fused_pre", "refine"),
    ("vmem7", "block_fold7_pre", "refine"),
    ("select", "payload_select_fused", "refine"),
    ("fused", "block_nn_fused4", "both"),
    ("infold", "block_nn_payload", "both"),
])
def test_block_modes_route_through_their_wrappers(mode, wrapper, phases, monkeypatch):
    """Each mode's wrapper runs once an iteration in the phases it serves
    (the refine phase's frozen candidates, or both phases), and no other
    correspondence wrapper runs beside it except the coarse phase's plain
    `block_nn` (with the row gather) where the mode needs frozen
    candidates."""
    from icpx_torch.registration import icp

    names = ("block_fold_fused_pre", "block_fold7_pre", "payload_select_fused",
             "block_nn_fused4", "block_nn_payload", "block_nn")
    calls = {n: 0 for n in names}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for n in names:
        monkeypatch.setattr(icp, n, counting(n, getattr(icp, n)))
    src, tgt, gt = _pair()
    res = register(torch_cloud(src), torch_cloud(tgt), torch_config(_cfg(mode)))
    rot, t = (float(x) for x in res.transform.distance_to(torch_se3(gt)))
    assert rot < 5e-3 and t < 5e-3
    refine = int(torch.isfinite(res.rmse_history).sum())
    coarse = res.iters - refine
    assert coarse == 2 and refine >= 1
    want = refine if phases == "refine" else res.iters
    assert calls[wrapper] == want, calls
    # select rides on the plain fold's positions in every iteration
    plain = res.iters if mode == "select" else (coarse if phases == "refine" else 0)
    assert calls["block_nn"] == plain, calls
    others = set(names) - {wrapper, "block_nn"}
    assert not any(calls[n] for n in others), calls


@pytest.mark.parametrize("change,error,where", [
    (dict(feat_nn="intensity", feat_nn_weight=1.0, nn_method="brute"), ValueError,
     "needs the block NN path"),
    (dict(feat_nn="intensity", feat_nn_weight=1.0), KeyError, "no payload features"),
    (dict(refine_stride=-1), ValueError, "refine_stride must be >= 0"),
])
def test_unported_block_options_raise(change, error, where):
    """The block options that once raised as unported (feat_nn, the
    refine-stride mid phase) now run; what still raises is what the
    reference refuses: feat_nn off the block path or without the named
    channel, and a negative refine_stride."""
    src, tgt, _ = _pair()
    with pytest.raises(error, match=where):
        cfg = dataclasses.replace(ICPConfig(nn_method="block"), **change)
        register(torch_cloud(src), torch_cloud(tgt), cfg)


def _mid_cfg(mode):
    """`_cfg` with the refine-stride mid phase: up to 6 iterations on every
    other row of each 64-row query tile (Sq 32), then up to 2 at full
    resolution. One coarse iteration leaves the mid phase real work, and
    the stop is a diff threshold (0.1, the mid phase's 0.05) that each
    phase's diff sums cross by orders of magnitude, so both packages stop
    at the same iteration: the RMSE test would compare noise, as the pair
    converges to an RMSE of ~2e-6 that moves by ~1e-6 an iteration."""
    return dataclasses.replace(_cfg(mode), refine_stride=2, coarse_iters=1, diff_threshold=0.1,
                               rmse_change_tol=0.0)


@pytest.mark.parametrize("mode", ("gather", "vmem"))
def test_refine_stride_mid_phase_matches_jax(mode):
    """refine_stride=2 on the 8k pair under "gather" and "vmem" (the plain
    fold6 here, the Pallas fold in interpret mode in the reference): pose
    within 1e-5, the same iteration count, NaN at the same places of the
    merged histories and the same `converged`."""
    src, tgt, gt = _pair(N_SMALL)
    jcfg = _mid_cfg(mode)
    jres = j_register(src, tgt, jcfg)
    res = register(torch_cloud(src), torch_cloud(tgt), torch_config(jcfg))
    np.testing.assert_allclose(to_np(res.transform.R), np.asarray(jres.transform.R), atol=1e-5)
    np.testing.assert_allclose(to_np(res.transform.t), np.asarray(jres.transform.t), atol=1e-5)
    assert res.iters == int(jres.iters)
    for h in ("diff_history", "rmse_history"):
        np.testing.assert_array_equal(np.isnan(to_np(getattr(res, h))),
                                      np.isnan(np.asarray(getattr(jres, h))), err_msg=h)
    assert bool(res.converged) == bool(jres.converged)
    # the mid phase ran: more refine entries than the tail's 2
    assert int(torch.isfinite(res.rmse_history).sum()) > jcfg.refine_full_iters
    rot, t = (float(x) for x in res.transform.distance_to(torch_se3(gt)))
    assert rot < 5e-3 and t < 5e-3


@pytest.mark.parametrize("mode,wrapper", [("vmem", "block_fold_fused_pre"),
                                          ("vmem7", "block_fold7_pre"),
                                          ("select", "payload_select_fused")])
def test_mid_phase_routes_through_its_wrapper(mode, wrapper, monkeypatch):
    """Under the mid phase each frozen-candidate mode's wrapper runs once an
    iteration of the mid phase and of the tail, on query tiles of Sq 32 and
    then 64."""
    from icpx_torch.registration import icp

    rows = []
    real = getattr(icp, wrapper)

    def counting(*a, **kw):
        rows.append(a[0].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(icp, wrapper, counting)
    src, tgt, gt = _pair(N_SMALL)
    res = register(torch_cloud(src), torch_cloud(tgt), torch_config(_mid_cfg(mode)))
    refine = int(torch.isfinite(res.rmse_history).sum())
    assert len(rows) == refine == res.iters - 1
    mid = rows.count(32)
    assert mid >= 1 and rows == [32] * mid + [64] * (refine - mid) and 1 <= refine - mid <= 2
    rot, t = (float(x) for x in res.transform.distance_to(torch_se3(gt)))
    assert rot < 5e-3 and t < 5e-3


def test_register_batch_block_matches_jax():
    """`register_batch_block` on two 16k pairs (the second its own GT): pose
    within 1e-5 of the reference's vmapped run, pair by pair, each pair's
    GT gate, and the brute path refused."""
    from icpx.geometry.se3 import SE3 as JSE3
    from icpx.registration.icp import register_batch_block as j_batch_block
    from icpx_torch.registration.icp import register_batch_block

    src, tgt, gt = _pair()
    src2, tgt2, gt2 = _pair_seeded(5, 0.1, (-0.05, 0.08, 0.0))
    stack = lambda f: np.stack([np.asarray(f(c)) for c in (src, src2)])  # noqa: E731
    stack_t = lambda f: np.stack([np.asarray(f(c)) for c in (tgt, tgt2)])  # noqa: E731
    cfg = JConfig(max_iters=6, diff_threshold=0.0, rmse_change_tol=1e-6, payload_mode="gather")
    jres = j_batch_block(jnp_(stack(lambda c: c.xyz)), jnp_(stack(lambda c: c.mask)),
                         jnp_(stack_t(lambda c: c.xyz)), jnp_(stack_t(lambda c: c.mask)), cfg)
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    res = register_batch_block(t(stack(lambda c: c.xyz)), t(stack(lambda c: c.mask)),
                               t(stack_t(lambda c: c.xyz)), t(stack_t(lambda c: c.mask)),
                               torch_config(cfg))
    assert tuple(res.transform.R.shape) == (2, 3, 3) and tuple(res.iters.shape) == (2,)
    assert tuple(res.rmse_history.shape) == (2, cfg.max_iters)
    np.testing.assert_allclose(to_np(res.transform.R), np.asarray(jres.transform.R), atol=1e-5)
    np.testing.assert_allclose(to_np(res.transform.t), np.asarray(jres.transform.t), atol=1e-5)
    for i, g in enumerate((gt, gt2)):
        est = JSE3(R=jres.transform.R[i], t=jres.transform.t[i])
        assert all(float(x) < 5e-3 for x in est.distance_to(g))
        assert abs(int(res.iters[i]) - int(jres.iters[i])) <= 1
    with pytest.raises(ValueError, match="block NN path"):
        register_batch_block(t(stack(lambda c: c.xyz)), t(stack(lambda c: c.mask)),
                             t(stack_t(lambda c: c.xyz)), t(stack_t(lambda c: c.mask)),
                             ICPConfig(nn_method="brute"))


def jnp_(a):
    return jax.numpy.asarray(a)


def _pair_seeded(seed, angle, translation, n=N):
    xyz = synthetic_surface(n, seed=seed)
    src = JCloud.create(xyz, capacity=n)
    gt = j_perturb(angle=angle, translation=translation)
    tgt_np = np.asarray(gt.apply(src.xyz))[:n]
    perm = np.random.default_rng(seed).permutation(n)
    tgt = JCloud.create(tgt_np[perm], capacity=n).replace(mask=src.mask[perm])
    return src, tgt, gt


def _entry_points():
    cat = reference_data_dir() / "cat.pcd"
    pts = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    return {
        "PointCloud.create": lambda: PointCloud.create(np.zeros((5, 3), np.float32)),
        "load_cloud": lambda: load_cloud(cat),
        "load_cat_pair": lambda: load_cat_pair(),
        "SE3.identity": lambda: SE3.identity(),
        "make_rigid_perturbation": lambda: make_rigid_perturbation(),
        "cloud_from_numpy": lambda: interop.cloud_from_numpy(np.zeros((4, 3)), np.ones(4, bool)),
        "se3_from_numpy": lambda: interop.se3_from_numpy(np.eye(3), np.zeros(3)),
        "horn_align": lambda: horn_align(pts, pts + 1.0),
        "umeyama_align": lambda: umeyama_align(pts, 2.0 * pts),
        "register_xyz": lambda: register_xyz(pts, pts, ICPConfig(max_iters=1)).transform,
        "make_trajectory": lambda: kitti.make_trajectory(2)[0],
        "simulate_scans": lambda: kitti.simulate_scans(
            kitti.make_world(2000, 10.0), kitti.make_trajectory(1, device="cpu"),
            points_per_scan=64)[0],
        "load_kitti_sequence": lambda: kitti.load_kitti_sequence(_kitti_dir())[0],
        "load_kitti_poses": lambda: kitti.load_kitti_poses(_kitti_dir().parent / "poses.txt")[0],
        "VoxelMap.create": lambda: VoxelMap.create(64, 0.1),
        "OdometryCheckpoint.poses": lambda: OdometryCheckpoint(
            frame_index=0, poses_R=np.eye(3, dtype=np.float32)[None],
            poses_t=np.zeros((1, 3), np.float32), keyframe_index=0, edges=[]).poses()[0],
        "pose_graph_from_numpy": lambda: interop.pose_graph_from_numpy(SimpleNamespace(
            poses=SimpleNamespace(R=np.eye(3)[None], t=np.zeros((1, 3))), edge_i=[0], edge_j=[0],
            edge_meas=SimpleNamespace(R=np.eye(3)[None], t=np.zeros((1, 3))),
            edge_weight=[1.0])).poses,
        "load_bunny": lambda: load_bunny(),
        "prefetch_kitti": lambda: next(iter(prefetch_kitti(_kitti_dir(), capacity=128))),
        "load_checkpoint": lambda: load_checkpoint(_checkpoint_file(), SE3.identity(device="cpu")),
    }


def _checkpoint_file():
    """A `save_checkpoint` file of one SE3, in a fresh temporary directory."""
    path = Path(tempfile.mkdtemp()) / "se3.npz"
    save_checkpoint(path, SE3.identity(device="cpu"))
    return path


def _kitti_dir():
    """A one-scan KITTI sequence written from CPU tensors, in a fresh
    temporary directory: (velodyne dir; poses.txt beside it)."""
    root = Path(tempfile.mkdtemp()) / "velodyne"
    traj = kitti.make_trajectory(1, device="cpu")
    scan = PointCloud.create(np.zeros((4, 3), np.float32), device="cpu")
    kitti.write_kitti_sequence(root, [scan], traj)
    return root


@pytest.mark.parametrize("name", list(_entry_points()))
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Without a device argument every entry point puts its tensors on the
    first CUDA device. Where there is none, that is torch's own error, not
    a quiet fall back to the CPU."""
    make = _entry_points()[name]
    if torch.cuda.is_available():
        out = make()
        first = out[0] if isinstance(out, tuple) else out
        assert next(iter(vars(first).values())).device == torch.device("cuda", 0)
        return
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        make()


def test_create_follows_a_given_tensor_and_device():
    x = torch.zeros((5, 3))
    assert PointCloud.create(x).device == CPU  # a CPU tensor stays on the CPU
    assert PointCloud.create(np.zeros((5, 3)), device="cpu").device == CPU


def test_block_path_runs_with_jax_and_icpx_blocked():
    """The port alone: with every `jax*` and `icpx*` module blocked in
    sys.modules, import the port and run a block-path registration and a
    block-path compiled odometry (8,192-point scans) on the CPU."""
    code = """
import sys
for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "icpx", "flax")]:
    del sys.modules[name]
for name in ("jax", "jaxlib", "icpx", "flax"):
    sys.modules[name] = None  # any import of them now raises ImportError
import numpy as np, torch
torch.set_num_threads(2)
from icpx_torch import ICPConfig, PointCloud, register
from icpx_torch.geometry.transforms import make_rigid_perturbation
from icpx_torch.io.loaders import synthetic_surface
src = PointCloud.create(synthetic_surface(8192, seed=0), device="cpu")
gt = make_rigid_perturbation(angle=0.1, translation=(0.05, 0.0, 0.02), device="cpu")
tgt = PointCloud.create(gt.apply(src.xyz)[torch.randperm(8192)], device="cpu")
res = register(src, tgt, ICPConfig(max_iters=6, diff_threshold=0.0, rmse_change_tol=1e-6))
rot, t = (float(v) for v in res.transform.distance_to(gt))
assert rot < 5e-3 and t < 5e-3, (rot, t)
from icpx_torch.kernels.normals import estimate_normals
from icpx_torch.odometry import ate_rmse, run_odometry_compiled
from icpx_torch.odometry.kitti import make_trajectory, make_world, simulate_scans
gt = make_trajectory(4, speed=0.6, turn=0.04, device="cpu")
scans = [estimate_normals(f, k=10) for f in simulate_scans(
    make_world(60000, 30.0), gt, max_range=18.0, points_per_scan=8192, seed=1, device="cpu")]
odo = run_odometry_compiled(*(torch.stack([getattr(f, a) for f in scans])
                              for a in ("xyz", "mask", "normals")), ICPConfig(
    objective="symmetric", max_iters=6, diff_threshold=0.0, rmse_change_tol=1e-6, robust="huber",
    max_corr_dist=2.0))
poses = [type(gt[0])(R=odo.poses.R[i], t=odo.poses.t[i]) for i in range(4)]
ate = ate_rmse(poses, [gt[0].inverse() @ g for g in gt], align=False)
assert ate < 0.5, ate  # bench.py's odometry gate
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "icpx") and sys.modules[m]]
print("ok", res.iters)
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")

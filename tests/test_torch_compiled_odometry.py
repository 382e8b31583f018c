"""Port parity: whole-sequence odometry (`run_odometry_compiled`) against
`icpx`, on the reference tests' own fixtures: 2,048-point scans of
`make_world(60000, 30.0)` along `make_trajectory(speed=0.6, turn=0.04)`,
normals (or GICP covariances) from the JAX package handed to both.

Held: the keyframe flags and each step's source keyframe equal, the same
`edge_list()` structure, every keyframe decision far from its threshold
(`keyframe_margins`), and poses and measured edges within each case's
tolerance, in m and rad: 1e-4 on the block path. Two cases need more, for
a reason of the fixture, not of the port (ROADMAP queue 3): on the brute
path one frame's registration moves by 5.5e-4 m when the reference's own
initial pose moves by 1e-7 m (a correspondence crossing max_corr_dist or
the Huber scale), so brute is held to 1e-3; GICP's frame 4 moves by
1.5e-2 m in the reference itself when every input coordinate is scaled by
1 + 1e-7, so GICP is held to 5e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icpx.kernels.normals import estimate_covariances as j_covariances
from icpx.kernels.normals import estimate_normals as j_normals
from icpx.odometry.compiled import run_odometry_compiled as j_run
from icpx.odometry.kitti import make_trajectory, make_world, simulate_scans
from icpx.registration.icp import ICPConfig as JConfig
from icpx_torch.odometry import compiled
from icpx_torch.odometry.compiled import (resolve_odo_freeze, resolve_odo_q_tile,
                                          resolve_odo_refine_stride, run_odometry_compiled)
from icpx_torch.registration.icp import ICPConfig
from torch_fixtures import keyframe_margins
from torch_parity import to_np, torch_config

MARGIN_MIN = 1e-3  # fp32 rounding moves a decision's quantities by ~1e-7

BASE = dict(objective="symmetric", max_iters=12, diff_threshold=0.0, rmse_change_tol=1e-6,
            robust="huber", max_corr_dist=2.0)
BLOCK = dict(nn_method="block", block_tile=64, block_q_tile=32, block_k=6, coarse_iters=0)
# (frames, world seed, scan seed, config, run_odometry_compiled keywords)
CASES = {
    "brute": (10, 0, 1, dict(BASE), {}),
    "block": (6, 0, 1, dict(BASE, **BLOCK), {}),
    "block frozen": (6, 2, 3, dict(BASE, **BLOCK), dict(freeze_candidates=True)),
    "block stride 2": (6, 4, 5, dict(BASE, **BLOCK, refine_stride=2), {}),
    "gicp": (6, 0, 1, dict(BASE, objective="gicp", max_iters=10), {}),
}
POSE_TOL = {"brute": 1e-3, "gicp": 5e-3}  # else 1e-4 (the module docstring says why)


def _frames(n_frames, world_seed, scan_seed, gicp):
    world = make_world(n_points=60000, extent=30.0, seed=world_seed)
    gt = make_trajectory(n_frames, speed=0.6, turn=0.04)
    frames = simulate_scans(world, gt, max_range=18.0, points_per_scan=2048, noise=0.01,
                            seed=scan_seed)
    if gicp:
        frames = [j_covariances(f, k=15) for f in frames]
        aux = np.stack([np.asarray(f.covs).reshape(f.capacity, 9) for f in frames])
    else:
        frames = [j_normals(f, k=10) for f in frames]
        aux = np.stack([np.asarray(f.normals) for f in frames])
    return (np.stack([np.asarray(f.xyz) for f in frames]),
            np.stack([np.asarray(f.mask) for f in frames]), aux)


@pytest.fixture(scope="module")
def runs():
    """Each case run once by both packages: {case: (jax result, port result)}."""
    cache = {}

    def get(case):
        if case not in cache:
            n, ws, ss, cfg, kw = CASES[case]
            fx, fm, fn = _frames(n, ws, ss, cfg["objective"] == "gicp")
            jres = j_run(jnp.asarray(fx), jnp.asarray(fm), jnp.asarray(fn), JConfig(**cfg),
                         keyframe_trans=1.0, keyframe_rot=0.2, **kw)
            tres = run_odometry_compiled(torch.as_tensor(fx), torch.as_tensor(fm),
                                         torch.as_tensor(fn), ICPConfig(**cfg),
                                         keyframe_trans=1.0, keyframe_rot=0.2, **kw)
            cache[case] = (jres, tres)
        return cache[case]

    return get


def _angle_diff(Ra, Rb):
    """Rotation angle of Ra^T Rb from its skew part, in float64 (fp32
    arccos cannot resolve angles below ~5e-4 rad)."""
    M = np.einsum("...ji,...jk->...ik", np.asarray(Ra, np.float64), np.asarray(Rb, np.float64))
    w = np.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0],
                  M[..., 1, 0] - M[..., 0, 1]], -1)
    return np.arcsin(np.clip(0.5 * np.linalg.norm(w, axis=-1), 0.0, 1.0))


@pytest.mark.parametrize("case", list(CASES))
def test_compiled_odometry_matches_jax(case, runs):
    jres, tres = runs(case)
    np.testing.assert_array_equal(to_np(tres.is_keyframe), np.asarray(jres.is_keyframe))
    np.testing.assert_array_equal(to_np(tres.edge_src), np.asarray(jres.edge_src))
    assert int(tres.final_kf) == int(jres.final_kf)
    # no frame was dead-reckoned on either side, so the gate decided nothing
    assert np.isfinite(to_np(tres.rmse)).all() and np.isfinite(np.asarray(jres.rmse)).all()
    margins = keyframe_margins(np.asarray(jres.edge_rel.R)[1:], np.asarray(jres.edge_rel.t)[1:],
                               1.0, 0.2)
    worst = int(np.argmin(margins))
    assert margins[worst] > MARGIN_MIN, f"frame {worst + 1}: keyframe margin {margins[worst]:.2e}"
    for name in ("poses", "edge_rel"):
        tj, tt = getattr(jres, name), getattr(tres, name)
        dt = np.abs(np.asarray(tj.t) - to_np(tt.t)).max()
        dr = _angle_diff(np.asarray(tj.R), to_np(tt.R)).max()
        tol = POSE_TOL.get(case, 1e-4)
        assert dt < tol and dr < tol, (name, dt, dr)
    np.testing.assert_allclose(to_np(tres.rmse), np.asarray(jres.rmse), atol=1e-3)
    it = to_np(tres.iters)
    assert it[0] == 0 and (it[1:] >= 1).all()


@pytest.mark.parametrize("case", ["brute", "block stride 2"])
def test_edge_list_matches_jax(case, runs):
    jres, tres = runs(case)
    je, te = jres.edge_list(), tres.edge_list()
    assert [(i, j) for i, j, _ in te] == [(i, j) for i, j, _ in je]
    tol = POSE_TOL.get(case, 1e-4)
    for (_, _, a), (_, _, b) in zip(je, te):
        assert np.abs(np.asarray(a.t) - to_np(b.t)).max() < tol
        assert _angle_diff(np.asarray(a.R), to_np(b.R)) < tol


def test_brute_path_calls_nearest_neighbor_once_an_iteration(runs, monkeypatch):
    """The brute path's NN is `nearest_neighbor` (the nn kernel on the
    card): one call an ICP iteration of every frame, no other."""
    n, ws, ss, cfg, _ = CASES["brute"]
    fx, fm, fn = _frames(4, ws, ss, False)
    calls = []
    real = compiled.nearest_neighbor

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(compiled, "nearest_neighbor", counted)
    res = run_odometry_compiled(torch.as_tensor(fx), torch.as_tensor(fm), torch.as_tensor(fn),
                                ICPConfig(**cfg))
    assert len(calls) == int(res.iters.sum())


RESOLVER_CASES = [
    # (function, arguments, expected)
    ("q_tile", (ICPConfig(), 131072), 256),
    ("q_tile", (ICPConfig(), 65536), 256),
    ("q_tile", (ICPConfig(), 16384), 128),
    ("q_tile", (ICPConfig(), 8192), 128),
    ("q_tile", (ICPConfig(), 4096), ICPConfig().resolve_q_tile(4096)),
    ("q_tile", (ICPConfig(), 131072, 64), 64),
    ("q_tile", (ICPConfig(block_q_tile=32), 16384), 32),
    ("freeze", (8192,), False),
    ("freeze", (16384,), True),
    ("freeze", (8192, True), True),
    ("freeze", (131072, False), False),
    ("stride", (ICPConfig(), 131072), 4),
    ("stride", (ICPConfig(), 65536), 2),
    ("stride", (ICPConfig(), 32768), 1),
    ("stride", (ICPConfig(), 8192), 1),
    ("stride", (ICPConfig(), 131072, 2), 2),
    ("stride", (ICPConfig(refine_stride=2), 131072), 2),
    ("stride", (ICPConfig(refine_stride=1), 131072), 1),
]
_RESOLVERS = {"q_tile": resolve_odo_q_tile, "freeze": resolve_odo_freeze,
              "stride": resolve_odo_refine_stride}


@pytest.mark.parametrize("fn, args, want", RESOLVER_CASES,
                         ids=[f"{f}-{i}" for i, (f, _, _) in enumerate(RESOLVER_CASES)])
def test_odo_resolvers_contract(fn, args, want):
    """The reference's ladders and override order
    (tests/test_compiled_odometry.py::test_odo_resolvers_contract), and the
    port's resolvers agree with the JAX package's on every case."""
    from icpx.odometry import compiled as j_compiled

    assert _RESOLVERS[fn](*args) == want
    j_fn = {"q_tile": j_compiled.resolve_odo_q_tile, "freeze": j_compiled.resolve_odo_freeze,
            "stride": j_compiled.resolve_odo_refine_stride}[fn]
    j_args = tuple(JConfig(**{f.name: getattr(a, f.name) for f in dataclasses.fields(a)})
                   if isinstance(a, ICPConfig) else a for a in args)
    assert j_fn(*j_args) == want


def test_config_round_trip():
    """The compiled path's default config converts field for field."""
    cfg = JConfig(**BASE)
    assert torch_config(cfg) == ICPConfig(**BASE)

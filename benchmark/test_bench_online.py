"""The online cell's frozen copies (`reference_online.py`, `kdwork.py`)
equal the program's functions today: the KD build's tile order and level
sorts, the ladders and block defaults, SE(3) log and exp, and the
velocity blend."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import generators as gen  # noqa: E402
import kdwork  # noqa: E402
import reference as ref  # noqa: E402
import reference_online as ro  # noqa: E402


@pytest.mark.parametrize("n,points,s", [(4096, 4096, 64), (8192, 6000, 128), (65536, 65536, 256),
                                        (65536, 65536, 128), (200000, 65536, 128)])
def test_kd_order_and_level_sorts_equal_the_program(n, points, s):
    """The median-cut order, Morton phase included (200,000 rows), bit for
    bit on a LiDAR scan padded to n rows, and one (c, m) level sort for
    each of the program's."""
    from icpx_torch.cloud import PointCloud
    from icpx_torch.kernels.blocknn import build_kd_index, kd_level_sorts

    world = gen.make_world(300000, 50.0, seed=0, n_posts=300, ground_frac=0.5)
    R, t = gen.make_trajectory(2, speed=0.6, turn=0.02)
    scan = gen.simulate_scans(world, R, t, points_per_scan=points, seed=3)[1]
    cloud = PointCloud.create(scan, capacity=n, device="cpu")
    idx = build_kd_index(cloud.xyz, cloud.mask, tile_size=s)
    np.testing.assert_array_equal(ro.kd_order(cloud.xyz.numpy(), cloud.mask.numpy(), s),
                                  idx.order.numpy())
    sorts = kdwork.level_sorts(n, s)
    assert len(sorts) == kd_level_sorts(n, s)
    assert all(c * m == idx.order.shape[0] for c, m in sorts)


def test_defaults_and_ladders_equal_the_program():
    from icpx_torch.odometry.compiled import (resolve_odo_freeze, resolve_odo_q_tile,
                                              resolve_odo_refine_stride)
    from icpx_torch.registration.icp import ICPConfig

    cfg = ICPConfig()
    for k, v in ro.ICP_DEFAULTS.items():
        assert getattr(cfg, k) == v, k
    cases = [({}, {}), ({"block_q_tile": 32}, {}), ({"refine_stride": 2}, {}),
             ({}, {"q_tile": 64, "refine_stride": 3, "freeze_candidates": False}),
             ({"nn_method": "block"}, {"freeze_candidates": True})]
    for icp, odo in cases:
        c = ICPConfig(**icp)
        for n in (2048, 4096, 8192, 16384, 65536, 131072):
            block, q, stride, freeze = ro.ladders(n, icp, odo)
            assert block == (c.resolve_nn(n) == "block")
            assert q == resolve_odo_q_tile(c, n, odo.get("q_tile", 0))
            assert stride == resolve_odo_refine_stride(c, n, odo.get("refine_stride", 0))
            assert freeze == resolve_odo_freeze(n, odo.get("freeze_candidates"))


def test_se3_and_velocity_blend_equal_the_program():
    from icpx_torch.geometry.se3 import SE3
    from icpx_torch.odometry.frontend import blend_velocity

    rng = np.random.default_rng(5)
    for _ in range(20):
        xi_a, xi_b = rng.normal(0, [0.03] * 3 + [0.4] * 3), rng.normal(0, [0.03] * 3 + [0.4] * 3)
        A, B = ro.se3_exp(xi_a), ro.se3_exp(xi_b)
        np.testing.assert_allclose(ro.se3_log(A), xi_a, atol=1e-12)
        Ta = SE3.exp(torch.as_tensor(xi_a, dtype=torch.float64))
        np.testing.assert_allclose(Ta.R.numpy(), A[:3, :3], atol=1e-12)
        np.testing.assert_allclose(Ta.t.numpy(), A[:3, 3], atol=1e-12)
        Tb = SE3.exp(torch.as_tensor(xi_b, dtype=torch.float64))
        for s in (ro.Loop(velocity_damping=0.7), ro.Loop(), ro.Loop(adaptive_velocity=False)):
            got = ro.blend_velocity(A, B, s)
            want = blend_velocity(Ta, Tb, damping=s.velocity_damping, adaptive=s.adaptive_velocity,
                                  innovation_scale=s.innovation_scale,
                                  damping_min=s.velocity_damping_min)
            np.testing.assert_allclose(got[:3, :3], want.R.numpy(), atol=1e-7)
            np.testing.assert_allclose(got[:3, 3], want.t.numpy(), atol=1e-7)


def test_gate_and_keyframe_rules():
    st = ro.State(kf=0, init=ref.se3(np.eye(3), np.array([0.6, 0.0, 0.0])), warm=True, rejects=0)
    s = ro.Loop()
    near = ref.se3(np.eye(3), np.array([0.65, 0.0, 0.0]))
    far = ref.se3(np.eye(3), np.array([2.0, 0.0, 0.0]))
    assert not ro.gate(st, near, s) and ro.gate(st, far, s)
    assert not ro.gate(ro.State(0, st.init, warm=False, rejects=0), far, s)
    assert not ro.gate(ro.State(0, st.init, warm=True, rejects=2), far, s)
    assert ro.gate(st, np.full((4, 4), np.nan), s)
    assert ro.spawns(ref.se3(np.eye(3), np.array([1.2, 0.0, 0.0])), False, s)
    assert not ro.spawns(ref.se3(np.eye(3), np.array([1.2, 0.0, 0.0])), True, s)
    assert not ro.spawns(near, False, s)

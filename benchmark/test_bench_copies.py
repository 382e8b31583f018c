"""The benchmark's frozen copies equal the program's functions today."""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import generators as gen  # noqa: E402
import roofline  # noqa: E402


def test_synthetic_surface_equals_the_program():
    from icpx_torch.io.loaders import synthetic_surface

    for seed in (0, 7, gen.sub_seed(2**31 + 5, 1, 3)):
        np.testing.assert_array_equal(gen.synthetic_surface(3000, seed), synthetic_surface(3000, seed))


def test_world_and_trajectory_equal_the_program():
    from icpx_torch.odometry.kitti import make_trajectory, make_world

    np.testing.assert_array_equal(gen.make_world(30000, 50.0, seed=0, n_posts=300, ground_frac=0.5),
                                  make_world(30000, 50.0, seed=0, n_posts=300, ground_frac=0.5))
    R, t = gen.make_trajectory(7, speed=0.6, turn=0.02)
    poses = make_trajectory(7, speed=0.6, turn=0.02, device="cpu")
    np.testing.assert_array_equal(R, np.stack([p.R.numpy() for p in poses]))
    np.testing.assert_array_equal(t, np.stack([p.t.numpy() for p in poses]))


def test_scans_equal_the_program():
    from icpx_torch.odometry.kitti import make_trajectory, make_world, simulate_scans

    world = make_world(30000, 50.0, seed=0, n_posts=300, ground_frac=0.5)
    poses = make_trajectory(4, speed=0.6, turn=0.02, device="cpu")
    R, t = gen.make_trajectory(4, speed=0.6, turn=0.02)
    for budget in (1024, 8192):  # subsampled, and every return kept
        want = simulate_scans(world, poses, max_range=25.0, points_per_scan=budget, noise=0.01,
                              seed=11, device="cpu")
        got = gen.simulate_scans(world, R, t, max_range=25.0, points_per_scan=budget, noise=0.01,
                                 seed=11)
        for w, g in zip(want, got):
            assert int(w.num_valid()) == len(g)
            np.testing.assert_array_equal(w.to_numpy(), g)


def test_gt_pair_equals_the_program_construction():
    """bench.py's pair: the target is the source's image under the ground
    truth, shuffled. The program builds it in float32 on the device, the
    copy in float64 rounded once: equal to float32 rounding."""
    from icpx_torch.geometry.transforms import make_rigid_perturbation

    n = 4096
    src, tgt, perm, R, t = gen.gt_pair(n, 3, 1, axis=(0.0, 0.0, 1.0), angle=0.2,
                                       translation=(0.12, -0.06, 0.03))
    np.testing.assert_array_equal(perm, np.random.default_rng(1).permutation(n))
    gt = make_rigid_perturbation(angle=0.2, translation=(0.12, -0.06, 0.03), device="cpu")
    want = gt.apply(torch.as_tensor(src)).numpy()[perm]
    np.testing.assert_allclose(tgt, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(R, gt.R.double().numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(t, gt.t.double().numpy(), rtol=0, atol=1e-7)


def test_peaks_equal_the_program():
    from icpx_torch.utils.profiling import FP32_FLOPS, HBM_BYTES_PER_S

    assert roofline.HBM_BYTES_PER_S == HBM_BYTES_PER_S == 3.35e12
    assert roofline.FP32_FLOPS == FP32_FLOPS == 67e12


def test_nn_and_sort_work():
    """The formulas of the project's kernel checks: nn's bytes and
    operations at 65,536 x 65,536 with 56,848 valid references (its LiDAR
    bound of 0.3893 ms), and a level sort's bytes."""
    b, ops = roofline.nn_work(65536, 65536, 56848)
    assert b == (65536 * 2) * 12 + 65536 + 65536 * 8
    assert ops == 65536 * 56848 * 7 + 65536 * 64
    assert abs(roofline.bound_s(b, ops) * 1e3 - 0.3893) < 5e-5
    assert roofline.sort_bytes(128, 8192) == 128 * 8192 * 2 * 20
    assert roofline.bound_s(roofline.sort_bytes(128, 8192), 0.0) == 128 * 8192 * 40 / 3.35e12

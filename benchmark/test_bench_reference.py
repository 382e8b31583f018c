"""The plain reference against the program's plain path, on the CPU at
small sizes, and its independence from the program."""

import ast
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import generators as gen  # noqa: E402
import reference as ref  # noqa: E402


def test_reference_imports_nothing_of_the_program():
    tree = ast.parse((HERE / "reference.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert {m.split(".")[0] for m in names} <= {"__future__", "math", "contextlib", "dataclasses",
                                                 "typing", "numpy", "torch", "scipy"}


def test_smallest_eigenvector_equals_eigh():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(4000, 3, 3, generator=g, dtype=torch.float64)
    a = a @ a.transpose(1, 2)
    got = ref.smallest_eigenvector(a)
    want = torch.linalg.eigh(a)[1][..., 0]
    assert float((1.0 - (got * want).sum(-1).abs()).max()) < 1e-12


def _scan(n):
    world = gen.make_world(300000, 50.0, seed=0, n_posts=300, ground_frac=0.5)
    R, t = gen.make_trajectory(2, speed=0.6, turn=0.02)
    return gen.simulate_scans(world, R, t, max_range=25.0, points_per_scan=n, noise=0.01, seed=3)


def test_normals_equal_the_program_knn_path():
    from icpx_torch.cloud import PointCloud
    from icpx_torch.kernels.normals import estimate_normals

    s = _scan(2048)[0]
    got = ref.normals(s, np.ones(len(s), bool), 10, "cpu")
    want = estimate_normals(PointCloud.create(s, capacity=2048, device="cpu"), k=10).normals
    assert float((got * want.double()).sum(-1).min()) > 0.9999


def test_neighbour_radius_equals_the_program():
    from icpx_torch.kernels.voxel import auto_cell_size

    s = _scan(32768)[0]
    x = torch.as_tensor(s)
    want = float(auto_cell_size(x, torch.ones(len(s), dtype=torch.bool), scale=3.0))
    assert abs(ref.neighbour_radius(s, np.ones(len(s), bool), 10) - want) < 1e-5 * want


def test_gicp_pair_equals_the_program():
    """The flagship's GICP on a 2,048-point pair: the program's plain path
    and the reference both reach the ground truth, within 1e-6 of each
    other; leaving the covariances out (the control) misses by far more."""
    from icpx_torch.cloud import PointCloud
    from icpx_torch.registration.icp import ICPConfig, register

    n = 2048
    src, tgt, _, R, t = gen.gt_pair(n, 5, 6, axis=(0, 0, 1), angle=0.2, translation=(0.12, -0.06, 0.03))
    cfg = ICPConfig(objective="gicp", max_iters=10, diff_threshold=0.0, rmse_change_tol=1e-6)
    res = register(PointCloud.create(src, device="cpu"), PointCloud.create(tgt, device="cpu"), cfg)
    got = ref.se3(res.transform.R.double().numpy(), res.transform.t.double().numpy())
    v = np.ones(n, bool)
    cs, ct = ref.gicp_covariances(src, v, 15, "cpu"), ref.gicp_covariances(tgt, v, 15, "cpu")
    s = ref.Settings(objective="gicp", max_iters=10, rmse_change_tol=1e-6)
    want = ref.register(src, v, cs, tgt, v, ct, s, "cpu")
    assert max(ref.gap(got, want.T)) < 1e-6
    assert max(ref.gap(want.T, ref.se3(R, t))) < 1e-6
    assert abs(float(res.final_rmse) - want.rmse) < 1e-6
    eye = torch.eye(3, dtype=torch.float64).expand(n, 3, 3)
    control = ref.register(src, v, eye, tgt, v, eye, s, "cpu")
    assert min(ref.gap(control.T, want.T)) > 1e-3


def test_symmetric_pair_equals_the_program():
    """A LiDAR pair of 2,048-row scans through `register_batch` (brute NN,
    Huber on the MAD scale) against the reference with its own normals."""
    from icpx_torch.cloud import PointCloud
    from icpx_torch.kernels.normals import estimate_normals
    from icpx_torch.registration.icp import ICPConfig, register_batch

    a, b = _scan(2048)
    ca, cb = (estimate_normals(PointCloud.create(s, capacity=2048, device="cpu"), k=10) for s in (a, b))
    cfg = ICPConfig(objective="symmetric", max_iters=12, diff_threshold=0.0, rmse_change_tol=1e-6,
                    robust="huber", max_corr_dist=2.0)
    res = register_batch(cb.xyz[None], cb.mask[None], cb.normals[None], ca.xyz[None],
                         ca.mask[None], ca.normals[None], cfg)
    got = ref.se3(res.transform.R[0].double().numpy(), res.transform.t[0].double().numpy())
    v = np.ones(2048, bool)
    s = ref.Settings(objective="symmetric", max_iters=12, rmse_change_tol=1e-6, robust="huber",
                     max_corr_dist=2.0)
    want = ref.register(b, v, ref.normals(b, v, 10, "cpu"), a, v, ref.normals(a, v, 10, "cpu"), s, "cpu")
    rot, t = ref.gap(got, want.T)
    assert rot < 1e-4 and t < 2e-3
    assert abs(float(res.final_rmse[0]) - want.rmse) < 1e-4

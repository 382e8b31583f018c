"""Port parity: the closed-form 3x3 eigensolver and brute kNN-PCA normals
of `icpx_torch` against numpy and `icpx`.

The eigensolver cases are those of tests/test_eigh3.py, run on the port,
including the millimetre-scale covariances whose eigenvector cross
products (~1e-12) once sent every normal to the isotropic fallback.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icpx.kernels.eigh3 import smallest_eigenvector_3x3 as j_smallest
from icpx.kernels.normals import estimate_normals as j_estimate_normals
from icpx.io.loaders import synthetic_surface
from icpx_torch.kernels.eigh3 import eigh3x3, eigvalsh3x3, smallest_eigenvector_3x3
from icpx_torch.kernels.normals import BLOCK_THRESHOLD, estimate_normals, estimate_normals_xyz
from torch_parity import clouds, to_np


def _random_sym(rng, n):
    A = rng.normal(size=(n, 3, 3)).astype(np.float32)
    return (A + A.transpose(0, 2, 1)) / 2


def test_eigvals_match_numpy(rng):
    A = _random_sym(rng, 256)
    w = to_np(eigvalsh3x3(torch.as_tensor(A)))
    assert np.allclose(w, np.linalg.eigvalsh(A), atol=2e-4)


def test_eigvecs_are_eigvecs(rng):
    A = _random_sym(rng, 128)
    w, V = eigh3x3(torch.as_tensor(A))
    w, V = to_np(w), to_np(V)
    for i in range(3):
        Av = np.einsum("nij,nj->ni", A, V[:, :, i])
        assert np.allclose(Av, w[:, i : i + 1] * V[:, :, i], atol=5e-3)


def test_smallest_eigenvector_plane(rng):
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    pts[:, 2] = 0.001 * pts[:, 2]
    C = (pts - pts.mean(0)).T @ (pts - pts.mean(0)) / len(pts)
    v, _ = smallest_eigenvector_3x3(torch.as_tensor(C[None]))
    assert abs(abs(float(v[0, 2])) - 1.0) < 1e-3


def test_isotropic_degenerate():
    A = torch.as_tensor(np.eye(3, dtype=np.float32)[None] * 2.0)
    assert np.allclose(to_np(eigvalsh3x3(A)), 2.0, atol=1e-6)
    v, _ = smallest_eigenvector_3x3(A)
    assert torch.isfinite(v).all()
    assert abs(float(torch.linalg.vector_norm(v[0])) - 1.0) < 1e-5


def test_repeated_eigenvalues():
    A = torch.as_tensor(np.diag([1.0, 1.0, 5.0]).astype(np.float32)[None])
    w, V = eigh3x3(A)
    assert np.allclose(to_np(w)[0], [1.0, 1.0, 5.0], atol=2e-3)
    assert abs(abs(float(V[0, 2, 2])) - 1.0) < 1e-4


def test_small_scale_covariances_no_fallback():
    """Planar neighbourhoods at 1e-3 spacing: the solver must normalise the
    tiny cross products, not hit the isotropic fallback."""
    rng = np.random.default_rng(0)
    s = 1e-3
    normals = rng.normal(size=(256, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    covs = []
    for nrm in normals:
        a = np.array([1.0, 0.0, 0.0], np.float32)
        if abs(nrm[0]) > 0.9:
            a = np.array([0.0, 1.0, 0.0], np.float32)
        u = np.cross(nrm, a)
        u /= np.linalg.norm(u)
        v = np.cross(nrm, u)
        C = s * s * (np.outer(u, u) + np.outer(v, v)) + (0.01 * s) ** 2 * np.outer(nrm, nrm)
        covs.append(C.astype(np.float32))
    covs = np.stack(covs)
    vec = to_np(smallest_eigenvector_3x3(torch.as_tensor(covs))[0])
    np.testing.assert_allclose(np.linalg.norm(vec, axis=1), 1.0, atol=1e-4)
    assert np.abs(np.sum(vec * normals, axis=1)).min() > 0.999
    # and the same vectors as the JAX solver, up to sign
    jv = np.asarray(j_smallest(jnp.asarray(covs))[0])
    assert np.abs(np.sum(vec * jv, axis=1)).min() > 1 - 1e-4


@pytest.mark.parametrize("n,seed", [(2048, 0), (1500, 3)])
def test_brute_normals_match_jax(n, seed):
    """|n . n'| >= 1 - 1e-4 with the same orientation on every valid point."""
    jc, tc = clouds(synthetic_surface(n, seed=seed))
    jn = np.asarray(j_estimate_normals(jc, k=10, method="brute").normals)
    tn = to_np(estimate_normals(tc, k=10, method="brute").normals)
    valid = np.asarray(jc.mask)
    dots = np.sum(jn * tn, axis=1)[valid]
    assert dots.min() >= 1 - 1e-4, float(dots.min())
    assert (tn[~valid] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(tn[valid], axis=1), 1.0, atol=1e-5)


def test_normals_auto_resolves_like_jax_and_block_raises():
    """auto picks block radius PCA from BLOCK_THRESHOLD points, as the JAX
    package does (the block method itself is held to JAX in
    test_torch_blocknn.py); an unknown method raises."""
    xyz = torch.as_tensor(synthetic_surface(BLOCK_THRESHOLD, seed=2))
    n_auto, c_auto = estimate_normals_xyz(xyz, k=10)
    n_block, c_block = estimate_normals_xyz(xyz, k=10, method="block")
    assert torch.equal(n_auto, n_block) and torch.equal(c_auto, c_block)
    n_small, _ = estimate_normals_xyz(xyz[:100], k=3)
    assert torch.equal(n_small, estimate_normals_xyz(xyz[:100], k=3, method="brute")[0])
    with pytest.raises(ValueError):
        estimate_normals_xyz(xyz[:100], k=10, method="voxel")

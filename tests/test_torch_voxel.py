"""Port parity: the voxel-hash NN (`build_voxel_grid`, `voxel_nn`) against
`icpx`, on tests/test_voxel.py's cases.

Tolerances: the grid's table, origin and cell bit-equal; on valid query
rows the indices equal and d2 within 1e-6 relative; pad query rows (whose
cell coordinates overflow int32, converted differently by XLA and torch)
by tests/test_voxel.py::test_padded_cloud's rule: any hit is a real,
unmasked reference row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icpx.cloud import PointCloud as JCloud
from icpx.io.loaders import synthetic_surface
from icpx.kernels.voxel import auto_cell_size as j_cell
from icpx.kernels.voxel import build_voxel_grid as j_build
from icpx.kernels.voxel import voxel_nn as j_voxel_nn
from icpx_torch.kernels.voxel import build_voxel_grid, voxel_nn
from torch_parity import to_np


def _case(name):
    """(reference (N, 3), mask or None, queries (Nq, 3), cell, bucket)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "surface":
        r, q = synthetic_surface(20000, seed=0), synthetic_surface(5000, seed=1)
    elif name == "volume":
        r = rng.uniform(-1, 1, (30000, 3)).astype(np.float32)
        q = rng.uniform(-1, 1, (5000, 3)).astype(np.float32)
    elif name == "masked":
        r = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
        return r, np.arange(2000) < 1000, r[900:1600], None, 16
    elif name == "overflow":  # one huge cell: buckets overflow and drop rows
        r = rng.normal(size=(5000, 3)).astype(np.float32)
        return r, None, r[:300], np.float32(100.0), 4
    elif name == "far":
        r = synthetic_surface(1000, seed=0)
        q = np.concatenate([np.full((4, 3), 50.0, np.float32), r[:60] + 0.01], 0)
    else:
        raise KeyError(name)
    return r, None, q, None, 16


@pytest.mark.parametrize("name", ["surface", "volume", "masked", "overflow", "far"])
def test_voxel_nn_matches_jax(name):
    r, mask, q, cell, bucket = _case(name)
    if cell is None:
        cell = np.float32(j_cell(jnp.asarray(r), None if mask is None else jnp.asarray(mask)))
    jmask = None if mask is None else jnp.asarray(mask)
    jg = j_build(jnp.asarray(r), cell, jmask, bucket_size=bucket)
    tg = build_voxel_grid(torch.as_tensor(r), torch.tensor(cell),
                          None if mask is None else torch.as_tensor(mask), bucket_size=bucket)
    np.testing.assert_array_equal(to_np(tg.table), np.asarray(jg.table))
    np.testing.assert_array_equal(to_np(tg.origin), np.asarray(jg.origin))
    assert float(tg.inv_cell) == float(jg.inv_cell)
    d_t, i_t = voxel_nn(torch.as_tensor(q), tg)
    d_j, i_j = j_voxel_nn(jnp.asarray(q), jg)
    d_t, i_t, d_j, i_j = to_np(d_t), to_np(i_t), np.asarray(d_j), np.asarray(i_j)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(np.isfinite(d_t), np.isfinite(d_j))
    fin = np.isfinite(d_j)
    np.testing.assert_allclose(d_t[fin], d_j[fin], rtol=1e-6, atol=0)
    assert i_t.dtype == np.int32
    if mask is not None:
        assert (i_t[fin] < 1000).all()  # masked rows never enter the table


def test_padded_cloud_rule():
    """A padded cloud (900 points in 1,024 rows): the valid queries find
    themselves in both packages; the pad rows' hits, where there are any,
    are real rows."""
    jc = JCloud.create(synthetic_surface(900, seed=2))
    cell = j_cell(jc.xyz, jc.mask)
    jg = j_build(jc.xyz, cell, jc.mask)
    xyz, mask = torch.as_tensor(np.asarray(jc.xyz)), torch.as_tensor(np.asarray(jc.mask))
    tg = build_voxel_grid(xyz, torch.tensor(np.float32(cell)), mask)
    np.testing.assert_array_equal(to_np(tg.table), np.asarray(jg.table))
    d_t, i_t = voxel_nn(xyz, tg)
    d_j, i_j = j_voxel_nn(jc.xyz, jg)
    np.testing.assert_array_equal(to_np(i_t)[:900], np.asarray(i_j)[:900])
    np.testing.assert_array_equal(to_np(i_t)[:900], np.arange(900))
    assert np.allclose(to_np(d_t)[:900], 0.0, atol=1e-6)
    assert (to_np(i_t) < 900).all()  # a pad query's hit is never a pad row

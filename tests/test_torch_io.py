"""Port parity: PCD IO and the demo fixtures of `icpx_torch` against `icpx`."""

import numpy as np
import pytest

from icpx.io.loaders import load_cat_pair as j_load_cat_pair
from icpx.io.loaders import load_cloud as j_load_cloud
from icpx.io.loaders import synthetic_surface as j_synthetic_surface
from icpx.io.pcd import write_pcd as j_write_pcd
from icpx_torch.cloud import PointCloud
from icpx_torch.io.loaders import (
    has_reference_data,
    load_cat_pair,
    load_cloud,
    save_cloud,
    synthetic_cat,
    synthetic_surface,
)
from icpx_torch.io.pcd import read_pcd, write_pcd
from torch_parity import to_np


def test_load_cat_pair_equals_jax():
    assert has_reference_data()
    js, jt = j_load_cat_pair()
    ts, tt = load_cat_pair(device="cpu")
    for j, t in ((js, ts), (jt, tt)):
        np.testing.assert_array_equal(to_np(t.xyz), np.asarray(j.xyz))
        np.testing.assert_array_equal(to_np(t.mask), np.asarray(j.mask))
        # cat.pcd has no normals; cat_out.pcd's are all zero = "no normals"
        assert j.normals is None and t.normals is None
    assert ts.capacity == 3456 and int(ts.num_valid()) == 3400


def test_synthetic_generators_equal_jax():
    np.testing.assert_array_equal(synthetic_surface(777, seed=3), j_synthetic_surface(777, seed=3))
    np.testing.assert_array_equal(synthetic_cat(100), j_synthetic_surface(100, seed=0) * 100.0)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("with_normals", [False, True])
def test_save_load_roundtrip(tmp_path, binary, with_normals):
    rng = np.random.default_rng(4)
    xyz = rng.normal(size=(333, 3)).astype(np.float32) * 50
    nrm = None
    if with_normals:
        nrm = rng.normal(size=(333, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    cloud = PointCloud.create(xyz, normals=nrm, device="cpu")
    path = tmp_path / "c.pcd"
    save_cloud(path, cloud, binary=binary)
    back = load_cloud(path, device="cpu")
    np.testing.assert_array_equal(back.to_numpy(), xyz)  # shortest round-trip repr
    if with_normals:
        np.testing.assert_array_equal(back.normals_to_numpy(), nrm)
    else:
        assert back.normals is None
    # and the JAX package reads the port's file to the same bits
    np.testing.assert_array_equal(np.asarray(j_load_cloud(path).to_numpy()), xyz)


@pytest.mark.parametrize("binary", [False, True])
def test_reads_jax_written_pcd(tmp_path, binary):
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-9, 9, size=(200, 3)).astype(np.float32)
    lab = rng.integers(0, 9, 200).astype(np.uint32)
    path = tmp_path / "j.pcd"
    j_write_pcd(path, xyz, extra_fields={"label": lab}, binary=binary)
    rec = read_pcd(path)
    np.testing.assert_array_equal(rec["xyz"], np.asarray(j_load_cloud(path).to_numpy()))
    if binary:
        np.testing.assert_array_equal(rec["xyz"], xyz)
    np.testing.assert_array_equal(rec["label"], lab)


def test_error_paths_match_jax(tmp_path):
    missing = tmp_path / "nope.pcd"
    for load in (load_cloud, j_load_cloud):
        with pytest.raises(FileNotFoundError):
            load(missing)
    bad = tmp_path / "cloud.abc"
    bad.write_text("x")
    for load in (load_cloud, j_load_cloud):
        with pytest.raises(ValueError):
            load(bad)
    with pytest.raises(ValueError):
        save_cloud(tmp_path / "out.abc", PointCloud.create(np.zeros((3, 3), np.float32), device="cpu"))


def test_unported_formats_raise(tmp_path):
    for ext in (".ply", ".txt", ".xyz", ".bin"):
        p = tmp_path / f"c{ext}"
        p.write_bytes(b"0 0 0\n")
        with pytest.raises(NotImplementedError, match="step 2"):
            load_cloud(p, device="cpu")
    with pytest.raises(NotImplementedError, match="step 2"):
        write_pcd(tmp_path / "c.pcd", np.zeros((2, 3), np.float32), compressed=True)

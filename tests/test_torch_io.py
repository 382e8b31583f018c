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
from icpx_torch.io.pcd import read_pcd
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


@pytest.mark.parametrize("ext", [".ply", ".txt", ".xyz", ".bin", ".pcd"])
def test_formats_once_unported_equal_jax(tmp_path, ext):
    """The formats that raised NotImplementedError before the IO slice (and
    binary_compressed PCD): a file of each, written by the JAX package,
    loads in the port with the same xyz, normals and feature columns, and
    the port's save of it reads back in the JAX package to the same xyz."""
    from icpx.io.loaders import save_cloud as j_save_cloud
    from icpx.io.pcd import write_pcd as j_write_pcd
    from icpx.cloud import PointCloud as JCloud

    rng = np.random.default_rng(6)
    xyz = rng.normal(size=(150, 3)).astype(np.float32) * 20
    nrm = rng.normal(size=(150, 3)).astype(np.float32)
    refl = rng.uniform(0, 1, (150, 1)).astype(np.float32)
    p = tmp_path / f"c{ext}"
    if ext == ".bin":
        np.concatenate([xyz, refl], axis=1).tofile(p)
    elif ext == ".pcd":
        j_write_pcd(p, xyz, normals=nrm, extra_fields={"intensity": refl[:, 0]}, compressed=True)
    else:
        j_save_cloud(p, JCloud.create(xyz, normals=nrm if ext == ".ply" else None),
                     binary=ext == ".ply")
    got, ref = load_cloud(p, device="cpu"), j_load_cloud(p)
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(ref.to_numpy()))
    for a, b in ((got.normals_to_numpy(), ref.normals_to_numpy()),
                 (got.feats_to_numpy(), ref.feats_to_numpy())):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b))
    assert got.feat_names == ref.feat_names
    if ext != ".bin":  # .bin is read-only, as in the reference
        out = tmp_path / f"back{ext}"
        save_cloud(out, got, binary=True)
        np.testing.assert_array_equal(np.asarray(j_load_cloud(out).to_numpy()), got.to_numpy())

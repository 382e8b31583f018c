"""Port parity: the native IO binding, PCD (ascii, binary, LZF), PLY, XYZ,
KITTI .bin, payload feature columns and prefetching of `icpx_torch`
against `icpx`, on the same files."""

import numpy as np
import pytest

from icpx.io import loaders as j_loaders
from icpx.io import native as j_native
from icpx.io.pcd import _lzf_decompress_py as j_lzf_py
from icpx.io.pcd import read_pcd as j_read_pcd
from icpx.io.pcd import write_pcd as j_write_pcd
from icpx.io.ply import read_ply as j_read_ply
from icpx.io.ply import write_ply as j_write_ply
from icpx.io.prefetch import prefetch_kitti as j_prefetch_kitti
from icpx.io.xyz import read_xyz_txt as j_read_xyz
from icpx.io.xyz import write_xyz_txt as j_write_xyz
from icpx.odometry.kitti import load_kitti_scan as j_load_kitti_scan
from icpx_torch.cloud import PointCloud
from icpx_torch.io import loaders, native, pcd, ply, prefetch, xyz
from icpx_torch.odometry.kitti import load_kitti_scan
from torch_parity import to_np


@pytest.fixture(scope="module")
def lib():
    assert native.get_lib() is not None, "the native IO library did not build"
    assert j_native.get_lib() is not None
    return native.get_lib()


def _cloud_arrays(rng, n=257):
    xyz = (rng.normal(size=(n, 3)) * 37.0).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return xyz, nrm


def _loaded(cloud):
    """(xyz, normals, feats) of a cloud of either package, as numpy."""
    def host(x):
        return None if x is None else np.asarray(to_np(x))

    return host(cloud.to_numpy()), host(cloud.normals_to_numpy()), host(cloud.feats_to_numpy())


def _assert_same_cloud(a, b):
    for x, y in zip(_loaded(a), _loaded(b)):
        if x is None or y is None:
            assert x is None and y is None
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert a.feat_names == b.feat_names


# ---- the native binding ------------------------------------------------------------


def test_native_builds_outside_the_source_tree(lib):
    """The port's library lives in icpx_torch/_build, keyed on the source."""
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == "icpx_torch"
    assert lib.icpx_io_abi_version() == native.ABI_VERSION == 3


def test_native_entries_equal_jax_binding(lib):
    rng = np.random.default_rng(0)
    arr = (rng.normal(size=(300, 5)) * 10).astype(np.float32)
    text = "\n".join(" ".join(f"{v:.9g}" for v in row) for row in arr).encode()
    got = native.parse_float_table(text, 300, 5)
    np.testing.assert_array_equal(got, j_native.parse_float_table(text, 300, 5))
    np.testing.assert_array_equal(got, arr)
    cols = native.parse_float_columns(text, 300, 5, 1, 3)
    np.testing.assert_array_equal(cols, j_native.parse_float_columns(text, 300, 5, 1, 3))
    np.testing.assert_array_equal(cols, arr[:, 1:4])
    assert native.format_float_table(arr) == j_native.format_float_table(arr)
    raw = rng.integers(0, 7, 40000).astype(np.uint8).tobytes()  # compressible
    comp = native.lzf_compress(raw)
    assert comp == j_native.lzf_compress(raw) and len(comp) < len(raw)
    assert native.lzf_decompress(comp, len(raw)) == raw == j_native.lzf_decompress(comp, len(raw))
    rec = rng.normal(size=(99, 4)).astype(np.float32)
    np.testing.assert_array_equal(native.kitti_xyz(rec.tobytes()), j_native.kitti_xyz(rec.tobytes()))
    # refusals: a truncated table and a malformed row give None, not garbage
    assert native.parse_float_table(b"1 2 3", 2, 3) is None
    assert native.parse_float_table(b"1 2 3\n4 x 6\n", 2, 3) is None


def test_native_counts_calls_and_fallbacks(lib, monkeypatch):
    native.reset_counts()
    native.kitti_xyz(np.zeros((4, 4), np.float32).tobytes())
    assert native.CALLS["kitti_xyz"] == 1 and native.FALLBACKS["kitti_xyz"] == 0
    monkeypatch.setenv("ICPX_NO_NATIVE", "1")
    assert native.get_lib() is None
    assert native.kitti_xyz(b"\0" * 16) is None
    assert native.FALLBACKS["kitti_xyz"] == 1


@pytest.mark.parametrize("seed", [1, 2])
def test_lzf_written_by_either_read_by_both(lib, seed):
    rng = np.random.default_rng(seed)
    raw = np.repeat(rng.normal(size=5000).astype(np.float32), 3).tobytes()
    for comp in (native.lzf_compress(raw), j_native.lzf_compress(raw)):
        assert pcd._lzf_decompress_py(comp, len(raw)) == raw
        assert j_lzf_py(comp, len(raw)) == raw
        assert pcd._lzf_decompress(comp, len(raw)) == raw


# ---- PCD ----------------------------------------------------------------------------


PCD_KINDS = {"ascii": {}, "binary": {"binary": True}, "binary_compressed": {"compressed": True}}


@pytest.mark.parametrize("kind", list(PCD_KINDS))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pcd_written_by_either_read_by_both(lib, tmp_path, kind, writer):
    rng = np.random.default_rng(3)
    xyz, nrm = _cloud_arrays(rng)
    extra = {"intensity": rng.uniform(0, 1, len(xyz)).astype(np.float32),
             "label": rng.integers(0, 9, len(xyz)).astype(np.uint16)}
    path = tmp_path / f"{writer}.pcd"
    write = pcd.write_pcd if writer == "port" else j_write_pcd
    write(path, xyz, normals=nrm, extra_fields=extra, **PCD_KINDS[kind])
    # the same input gives the same bytes from either writer
    other = tmp_path / "other.pcd"
    (j_write_pcd if writer == "port" else pcd.write_pcd)(
        other, xyz, normals=nrm, extra_fields=extra, **PCD_KINDS[kind])
    if kind != "ascii":  # ascii with a uint16 column takes each package's formatter
        assert path.read_bytes() == other.read_bytes()
    rec, jrec = pcd.read_pcd(path), j_read_pcd(path)
    assert rec["_header"].data == kind
    for key in ("xyz", "normals", "intensity", "label"):
        np.testing.assert_array_equal(rec[key], jrec[key])
    np.testing.assert_array_equal(rec["xyz"], xyz)
    np.testing.assert_array_equal(rec["label"], extra["label"])
    _assert_same_cloud(loaders.load_cloud(path, device="cpu"), j_loaders.load_cloud(path))


def test_pcd_ascii_float_tables_byte_equal(lib, tmp_path):
    """An all-float32 ascii body goes through the native formatter in both
    packages: the same bytes, and back to the same bits."""
    rng = np.random.default_rng(4)
    xyz, nrm = _cloud_arrays(rng)
    pcd.write_pcd(tmp_path / "p.pcd", xyz, normals=nrm)
    j_write_pcd(tmp_path / "j.pcd", xyz, normals=nrm)
    assert (tmp_path / "p.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
    np.testing.assert_array_equal(pcd.read_pcd(tmp_path / "p.pcd")["xyz"], xyz)


def test_no_native_fallback_equals_native(lib, tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    pts, nrm = _cloud_arrays(rng)
    pcd.write_pcd(tmp_path / "a.pcd", pts, normals=nrm)
    pcd.write_pcd(tmp_path / "c.pcd", pts, normals=nrm, compressed=True)
    xyz_txt = tmp_path / "x.xyz"
    xyz_txt.write_text("x y z\n" + "".join(f"{a:.9g} {b:.9g} {c:.9g} 1\n" for a, b, c in pts))
    kitti = tmp_path / "k.bin"
    np.concatenate([pts, pts[:, :1]], axis=1).tofile(kitti)

    def read_all():
        return [pcd.read_pcd(tmp_path / "a.pcd")["normals"], pcd.read_pcd(tmp_path / "c.pcd")["normals"],
                xyz.read_xyz_txt(xyz_txt), load_kitti_scan(kitti)]

    native.reset_counts()
    with_native = read_all()
    assert native.CALLS["parse_float_table"] >= 1 and native.CALLS["lzf_decompress"] >= 1
    assert native.CALLS["parse_float_columns"] == 1 and native.CALLS["kitti_xyz"] == 1
    monkeypatch.setenv("ICPX_NO_NATIVE", "1")
    without = read_all()
    for a, b in zip(with_native, without):
        np.testing.assert_array_equal(a, b)
    assert native.FALLBACKS["kitti_xyz"] == 1 and native.FALLBACKS["lzf_decompress"] == 1
    # the ascii writer's Python formatter reads back to the same bits
    pcd.write_pcd(tmp_path / "py.pcd", pts, normals=nrm)
    # and a compressed write needs the library
    with pytest.raises(RuntimeError, match="native IO library"):
        pcd.write_pcd(tmp_path / "no.pcd", pts, compressed=True)
    monkeypatch.delenv("ICPX_NO_NATIVE")
    np.testing.assert_array_equal(pcd.read_pcd(tmp_path / "py.pcd")["xyz"], pts)


def test_wide_integer_ascii_takes_the_float64_path(lib, tmp_path):
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    rgba = (rng.integers(0, 2**32 - 1, 20, dtype=np.uint64)).astype(np.uint32)
    j_write_pcd(tmp_path / "w.pcd", pts, extra_fields={"rgba": rgba})
    rec, jrec = pcd.read_pcd(tmp_path / "w.pcd"), j_read_pcd(tmp_path / "w.pcd")
    np.testing.assert_array_equal(rec["rgba"], rgba)
    np.testing.assert_array_equal(rec["xyz"], jrec["xyz"])


# ---- the payload repair ---------------------------------------------------------------


@pytest.mark.parametrize("kind", list(PCD_KINDS))
def test_pcd_payload_fields_load_as_feats(lib, tmp_path, kind):
    """A PCD with an intensity column and a wide packed rgba column: both
    packages load the intensity as a feature column and skip the rgba (it
    would round in float32); the port used to drop both."""
    rng = np.random.default_rng(7)
    xyz, _ = _cloud_arrays(rng, 200)
    inten = rng.uniform(0, 255, 200).astype(np.float32)
    rgba = rng.integers(2**25, 2**32 - 1, 200, dtype=np.uint64).astype(np.uint32)
    path = tmp_path / "p.pcd"
    j_write_pcd(path, xyz, extra_fields={"intensity": inten, "rgba": rgba}, **PCD_KINDS[kind])
    got, ref = loaders.load_cloud(path, device="cpu"), j_loaders.load_cloud(path)
    assert got.feat_names == ref.feat_names == ("intensity",)
    np.testing.assert_array_equal(got.feats_to_numpy(), np.asarray(ref.feats_to_numpy()))
    np.testing.assert_array_equal(got.feats_to_numpy()[:, 0], inten)
    # save_cloud writes the column back, and both packages read it
    out = tmp_path / "back.pcd"
    loaders.save_cloud(out, got, binary=(kind != "ascii"))
    again, j_again = loaders.load_cloud(out, device="cpu"), j_loaders.load_cloud(out)
    assert again.feat_names == j_again.feat_names == ("intensity",)
    np.testing.assert_array_equal(again.feats_to_numpy()[:, 0], inten)
    np.testing.assert_array_equal(np.asarray(j_again.feats_to_numpy())[:, 0], inten)


def test_cat_out_fixture_payload_equals_jax():
    got = loaders.load_cloud(loaders.reference_data_dir() / "cat_out.pcd", device="cpu")
    ref = j_loaders.load_cloud(j_loaders.reference_data_dir() / "cat_out.pcd")
    assert got.feat_names == ref.feat_names == ("label", "curvature")
    np.testing.assert_array_equal(to_np(got.feats), np.asarray(ref.feats))


# ---- PLY and XYZ --------------------------------------------------------------------


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ply_written_by_either_read_by_both(tmp_path, binary, writer):
    rng = np.random.default_rng(8)
    xyz_a, nrm = _cloud_arrays(rng, 65)
    colors = rng.integers(0, 255, (65, 3)).astype(np.uint8)
    path, other = tmp_path / "a.ply", tmp_path / "b.ply"
    (ply.write_ply if writer == "port" else j_write_ply)(
        path, xyz_a, normals=nrm, colors=colors, binary=binary)
    (j_write_ply if writer == "port" else ply.write_ply)(
        other, xyz_a, normals=nrm, colors=colors, binary=binary)
    assert path.read_bytes() == other.read_bytes()
    rec, jrec = ply.read_ply(path), j_read_ply(path)
    for key in ("xyz", "normals", "red", "green", "blue"):
        np.testing.assert_array_equal(rec[key], jrec[key])
    np.testing.assert_array_equal(rec["xyz"], xyz_a)
    got, ref = loaders.load_cloud(path, device="cpu"), j_loaders.load_cloud(path)
    _assert_same_cloud(got, ref)
    assert got.feat_names == ("red", "green", "blue")


def test_ply_big_endian_and_leading_element(tmp_path):
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(6, 3)).astype(np.float32)
    big = tmp_path / "be.ply"
    big.write_bytes(b"ply\nformat binary_big_endian 1.0\nelement meta 2\nproperty short v\n"
                    b"element vertex 6\nproperty float x\nproperty float y\nproperty float z\n"
                    b"property float intensity\nend_header\n" + np.zeros(2, ">i2").tobytes()
                    + np.concatenate([pts, pts[:, :1]], 1).astype(">f4").tobytes())
    rec, jrec = ply.read_ply(big), j_read_ply(big)
    np.testing.assert_array_equal(rec["xyz"], pts)
    np.testing.assert_array_equal(rec["xyz"], jrec["xyz"])
    got = loaders.load_cloud(big, device="cpu")
    assert got.feat_names == ("intensity",)
    text = "".join(" ".join(f"{v:.5f}" for v in row) + "\n" for row in pts[:4])
    asc = tmp_path / "e.ply"
    asc.write_text("ply\nformat ascii 1.0\nelement meta 2\nproperty float value\n"
                   "element vertex 4\nproperty float x\nproperty float y\nproperty float z\n"
                   "end_header\n7.0\n8.0\n" + text)
    np.testing.assert_array_equal(ply.read_ply(asc)["xyz"], j_read_ply(asc)["xyz"])
    np.testing.assert_allclose(ply.read_ply(asc)["xyz"], pts[:4], atol=1e-4)
    lst = tmp_path / "l.ply"
    lst.write_text("ply\nformat ascii 1.0\nelement face 1\nproperty list uchar int v\n"
                   "element vertex 1\nproperty float x\nproperty float y\nproperty float z\n"
                   "end_header\n3 0 1 2\n0 0 0\n")
    for read in (ply.read_ply, j_read_ply):
        with pytest.raises(ValueError, match="list-typed"):
            read(lst)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_xyz_written_by_either_read_by_both(lib, tmp_path, writer):
    rng = np.random.default_rng(10)
    pts, _ = _cloud_arrays(rng, 101)
    path = tmp_path / "c.xyz"
    (xyz.write_xyz_txt if writer == "port" else j_write_xyz)(path, pts)
    np.testing.assert_array_equal(xyz.read_xyz_txt(path), j_read_xyz(path))
    if writer == "port":  # 9 significant digits: the same bits back
        np.testing.assert_array_equal(xyz.read_xyz_txt(path), pts)
    else:  # the reference's 8 digits round to within 1e-7 relative
        np.testing.assert_allclose(xyz.read_xyz_txt(path), pts, rtol=1e-7)
    _assert_same_cloud(loaders.load_cloud(path, device="cpu"), j_loaders.load_cloud(path))


def test_xyz_headers_comments_and_ragged_rows(lib, tmp_path):
    p = tmp_path / "h.txt"
    p.write_text("# comment\nx y z\n1 2 3\n\n4 5 6\n")
    np.testing.assert_array_equal(xyz.read_xyz_txt(p), j_read_xyz(p))
    assert xyz.read_xyz_txt(p).shape == (2, 3)
    bad = tmp_path / "r.txt"
    bad.write_text("1 2 3\n4 5\n6 7 8\n")
    for read in (xyz.read_xyz_txt, j_read_xyz):
        with pytest.raises(ValueError):
            read(bad)
    two = tmp_path / "two.txt"
    two.write_text("1 2\n3 4\n")
    with pytest.raises(ValueError, match=">= 3 columns"):
        xyz.read_xyz_txt(two)


def test_bunny_fixture_equals_jax():
    np.testing.assert_array_equal(loaders.load_bunny(device="cpu").to_numpy(),
                                  np.asarray(j_loaders.load_bunny().to_numpy()))
    za = loaders.reference_data_dir() / "za.txt"
    _assert_same_cloud(loaders.load_cloud(za, device="cpu"), j_loaders.load_cloud(za))


# ---- KITTI .bin, prefetch, errors ---------------------------------------------------


def test_kitti_bin_with_reflectance(lib, tmp_path):
    rng = np.random.default_rng(11)
    rec = rng.normal(size=(300, 4)).astype(np.float32)
    path = tmp_path / "000000.bin"
    rec.tofile(path)
    got, ref = loaders.load_cloud(path, device="cpu"), j_loaders.load_cloud(path)
    assert got.feat_names == ref.feat_names == ("reflectance",)
    _assert_same_cloud(got, ref)
    np.testing.assert_array_equal(got.feats_to_numpy()[:, 0], rec[:, 3])
    np.testing.assert_array_equal(load_kitti_scan(path), j_load_kitti_scan(path))


@pytest.mark.parametrize("with_intensity", [False, True])
def test_prefetch_kitti_order_equals_serial(lib, tmp_path, with_intensity):
    rng = np.random.default_rng(12)
    for k in range(7):
        rng.normal(size=(90 + 13 * k, 4)).astype(np.float32).tofile(tmp_path / f"{k:06d}.bin")
    pf = prefetch.prefetch_kitti(tmp_path, capacity=256, max_frames=6, depth=3,
                                 with_intensity=with_intensity, device="cpu")
    ref = list(j_prefetch_kitti(tmp_path, capacity=256, max_frames=6, depth=3,
                                with_intensity=with_intensity))
    got = list(pf)
    assert len(pf) == len(got) == len(ref) == 6
    for k, (a, b) in enumerate(zip(got, ref)):
        assert a.capacity == 256 and int(a.num_valid()) == 90 + 13 * k
        np.testing.assert_array_equal(to_np(a.xyz), np.asarray(b.xyz))
        np.testing.assert_array_equal(to_np(a.mask), np.asarray(b.mask))
        _assert_same_cloud(a, b)


def test_scan_prefetcher_keeps_order_under_uneven_loads(tmp_path):
    import threading
    import time

    seen, lock = [], threading.Lock()

    def loader(p):
        k = int(p.stem)
        time.sleep(0.02 * (5 - k % 5))  # later paths finish first
        with lock:
            seen.append(k)
        return PointCloud.create(np.full((3, 3), k, np.float32), device="cpu")

    pf = prefetch.ScanPrefetcher([tmp_path / f"{k}.bin" for k in range(8)], capacity=128,
                                 depth=4, loader=loader)
    out = [int(c.xyz[0, 0]) for c in pf]
    assert out == list(range(8)) and sorted(seen) == list(range(8))
    with pytest.raises(ValueError):
        prefetch.ScanPrefetcher([], capacity=128, depth=0)


def test_error_paths(tmp_path):
    with pytest.raises(FileNotFoundError):
        loaders.load_cloud(tmp_path / "missing.ply", device="cpu")
    bad = tmp_path / "c.obj"
    bad.write_text("v 0 0 0\n")
    with pytest.raises(ValueError, match="unsupported"):
        loaders.load_cloud(bad, device="cpu")
    cloud = PointCloud.create(np.zeros((3, 3), np.float32), device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        loaders.save_cloud(tmp_path / "c.bin", cloud)
    notply = tmp_path / "n.ply"
    notply.write_text("plx\n")
    with pytest.raises(ValueError, match="not a PLY"):
        loaders.load_cloud(notply, device="cpu")


def test_reference_data_dir_read_at_call_time(tmp_path, monkeypatch):
    monkeypatch.setenv("ICPX_DATA_DIR", str(tmp_path))
    assert loaders.reference_data_dir() == tmp_path
    assert loaders.REFERENCE_DATA_DIR == tmp_path
    assert not loaders.has_reference_data()
    monkeypatch.delenv("ICPX_DATA_DIR")
    assert loaders.has_reference_data()
    with pytest.raises(AttributeError):
        loaders.NO_SUCH_NAME  # noqa: B018

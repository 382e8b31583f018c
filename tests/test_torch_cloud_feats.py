"""Port parity: the cloud helpers of `icpx/cloud.py` (`pad_to`, `concat`,
`feat`, `feats_to_numpy`, `has_normals`) and payload features through
`create` and `interop`, against `icpx`. Tolerance: bit-equal arrays."""

import numpy as np
import pytest
import torch

from icpx.cloud import PointCloud as JCloud
from icpx.cloud import concat as j_concat
from icpx_torch import interop
from icpx_torch.cloud import PointCloud, concat
from torch_parity import to_np, torch_cloud

FIELDS = ("xyz", "mask", "normals", "covs", "feats")


def _jcloud(n, seed, normals=True, covs=True, feats=2):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32) if normals else None
    f = rng.uniform(size=(n, feats)).astype(np.float32) if feats else None
    names = ("intensity", "ring")[:feats] if feats else None
    jc = JCloud.create(xyz, nrm, feats=f, feat_names=names)
    if covs:
        c = rng.normal(size=(jc.capacity, 3, 3)).astype(np.float32)
        jc = jc.replace(covs=np.einsum("nij,nkj->nik", c, c))
    return jc


def _assert_same(tc, jc):
    for f in FIELDS:
        a, b = getattr(tc, f), getattr(jc, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(to_np(a), np.asarray(b), err_msg=f)
    assert tc.feat_names == jc.feat_names


def test_create_with_feats_matches_jax():
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    inten = rng.uniform(size=300).astype(np.float32)  # a 1-D column becomes (n, 1)
    jc = JCloud.create(xyz, feats=inten, feat_names=("intensity",))
    tc = PointCloud.create(xyz, feats=inten, feat_names=("intensity",), device="cpu")
    _assert_same(tc, jc)
    with pytest.raises(ValueError, match="feat_names"):
        PointCloud.create(xyz, feats=inten, feat_names=("a", "b"), device="cpu")
    with pytest.raises(ValueError, match="rows"):
        PointCloud.create(xyz, feats=inten[:10], device="cpu")


@pytest.mark.parametrize("capacity", [384, 512])
def test_pad_to_matches_jax(capacity):
    jc = _jcloud(300, seed=2)
    tc = torch_cloud(jc)
    _assert_same(tc.pad_to(capacity), jc.pad_to(capacity))
    with pytest.raises(ValueError, match="shrink"):
        tc.pad_to(128)


def test_concat_matches_jax():
    ja, jb = _jcloud(200, seed=3), _jcloud(130, seed=4)
    _assert_same(concat(torch_cloud(ja), torch_cloud(jb)), j_concat(ja, jb))
    jn = _jcloud(50, seed=5, normals=False)
    with pytest.raises(ValueError, match="normals"):
        concat(torch_cloud(ja), torch_cloud(jn))
    jf = _jcloud(50, seed=6, feats=1)
    with pytest.raises(ValueError, match="payload"):
        concat(torch_cloud(ja), torch_cloud(jf))


def test_feat_and_feats_to_numpy_match_jax():
    jc = _jcloud(250, seed=7)
    tc = torch_cloud(jc)
    for name in ("intensity", "ring"):
        np.testing.assert_array_equal(to_np(tc.feat(name)), np.asarray(jc.feat(name)))
    np.testing.assert_array_equal(tc.feats_to_numpy(), jc.feats_to_numpy())
    assert tc.has_normals() == jc.has_normals()
    with pytest.raises(KeyError, match="no feature"):
        tc.feat("rgb")
    bare = torch_cloud(_jcloud(10, seed=8, feats=0))
    assert bare.feats_to_numpy() is None
    with pytest.raises(KeyError, match="no payload"):
        bare.feat("intensity")


def test_features_survive_replace_to_and_interop():
    jc = _jcloud(100, seed=9)
    tc = torch_cloud(jc)
    moved = tc.to(torch.device("cpu")).with_xyz(tc.xyz + 1.0)
    _assert_same(moved.replace(xyz=tc.xyz), jc)
    back = interop.cloud_to_numpy(tc)
    again = interop.cloud_from_numpy(*(back[f] for f in FIELDS), back["feat_names"], device="cpu")
    _assert_same(again, jc)

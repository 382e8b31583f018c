"""Port parity: metrics, generic checkpoints, profiling, debug helpers, viz
and the fault injectors of `icpx_torch` against `icpx`."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icpx.cloud import PointCloud as JCloud
from icpx.geometry.se3 import SE3 as JSE3
from icpx.registration.icp import ICPConfig as JConfig
from icpx.registration.icp import register as j_register
from icpx.utils import checkpoint as j_checkpoint
from icpx.utils import debug as j_debug
from icpx.utils import metrics as j_metrics
from icpx_torch.cloud import PointCloud
from icpx_torch.distributed.fault import corrupt_points, drop_shard
from icpx_torch.geometry.se3 import SE3
from icpx_torch.registration.icp import register
from icpx_torch.utils import checkpoint, debug, metrics, profiling, pytree
from torch_parity import clouds, rotation, to_np, torch_config


# ---- metrics --------------------------------------------------------------------------


def test_metrics_jsonl_and_values(tmp_path):
    path = tmp_path / "m.jsonl"
    with metrics.MetricsLogger(path) as m:
        m.log(event="a", x=1.5, arr=torch.tensor([1.0, 2.0]), n=np.int64(3),
              flag=torch.tensor(True), zero_d=torch.tensor(2.5), arr_np=np.arange(3))
        m.log(event="b", s="text", none=None)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines[0]["arr"] == [1.0, 2.0] and lines[0]["n"] == 3 and lines[0]["flag"] is True
    assert lines[0]["zero_d"] == 2.5 and lines[0]["arr_np"] == [0, 1, 2]
    assert lines[1]["s"] == "text" and lines[1]["none"] is None
    mem = metrics.MetricsLogger()
    with mem:
        mem.log(event="c")
    assert len(mem.records) == 1 and "ts" in mem.records[0]


def test_metrics_nonfinite_is_valid_json(tmp_path):
    path = tmp_path / "m.jsonl"
    with metrics.MetricsLogger(path) as m:
        m.log(rmse=float("inf"), arr=[1.0, float("nan")], t=torch.tensor([float("-inf"), 1.0]),
              z=torch.tensor(float("nan")))
    rec = json.loads(path.read_text(), parse_constant=lambda c: 1 / 0)
    assert rec["rmse"] is None and rec["arr"] == [1.0, None]
    assert rec["t"] == [None, 1.0] and rec["z"] is None
    # the same values through the JAX package's sink give the same record
    jpath = tmp_path / "j.jsonl"
    with j_metrics.MetricsLogger(jpath) as m:
        m.log(rmse=float("inf"), arr=[1.0, float("nan")], t=jnp.asarray([float("-inf"), 1.0]),
              z=jnp.asarray(float("nan")))
    jrec = json.loads(jpath.read_text())
    assert {k: v for k, v in rec.items() if k != "ts"} == {k: v for k, v in jrec.items() if k != "ts"}


def test_icp_iteration_records_on_the_cat_pair_equal_jax(cat_pair):
    (js, jt), (ts, tt) = cat_pair
    """The golden config: both stop after 5 iterations; the records agree to
    2% while the pair is still far apart (each package estimates normals
    and sums in its own rounding) and both end below 1e-4 rmse."""
    jcfg = JConfig(objective="symmetric", max_iters=20, diff_threshold=1.0, max_corr_dist=50.0,
                   robust="huber")
    jrec = j_metrics.icp_iteration_records(j_register(js, jt, jcfg))
    rec = metrics.icp_iteration_records(register(ts, tt, torch_config(jcfg)))
    assert [r["iter"] for r in rec] == [r["iter"] for r in jrec] == list(range(1, 6))
    for a, b in zip(rec[:-1], jrec[:-1]):
        assert a["diff"] == pytest.approx(b["diff"], rel=2e-2)
        assert a["rmse"] == pytest.approx(b["rmse"], rel=2e-2)
    assert rec[-1]["diff"] < 1.0 and jrec[-1]["diff"] < 1.0
    assert rec[-1]["rmse"] < 1e-4 and jrec[-1]["rmse"] < 1e-4


@pytest.fixture(scope="module")
def cat_pair():
    from icpx.io.loaders import load_cat_pair

    js, jt = load_cat_pair()
    tgt_np = np.asarray(jt.to_numpy())[np.random.default_rng(0).permutation(3400)]
    src_np = np.asarray(js.to_numpy())
    (js2, ts2), (jt2, tt2) = clouds(src_np), clouds(tgt_np)
    return (js2, jt2), (ts2, tt2)


# ---- generic checkpoints -------------------------------------------------------------


def _states():
    """The same tree in both packages: dicts (unsorted keys), lists, tuples,
    None, SE3 and PointCloud with feature names."""
    rng = np.random.default_rng(1)
    R = rotation(rng)
    t = rng.normal(size=3).astype(np.float32)
    xyz = rng.normal(size=(130, 3)).astype(np.float32)
    feats = rng.uniform(size=(130, 1)).astype(np.float32)
    hist = np.arange(5, dtype=np.float32)
    jc = JCloud.create(xyz, feats=feats, feat_names=("intensity",))
    tc = PointCloud.create(xyz, feats=feats, feat_names=("intensity",), device="cpu")
    jstate = {"zeta": jnp.asarray(hist), "pose": JSE3(R=jnp.asarray(R), t=jnp.asarray(t)),
              "step": jnp.int32(7), "items": [jnp.ones(2), (jnp.zeros(3), None, jnp.int32(4))],
              "cloud": jc}
    tstate = {"zeta": torch.as_tensor(hist), "pose": SE3(R=torch.as_tensor(R), t=torch.as_tensor(t)),
              "step": torch.tensor(7, dtype=torch.int32),
              "items": [torch.ones(2), (torch.zeros(3), None, torch.tensor(4, dtype=torch.int32))],
              "cloud": tc}
    return jstate, tstate


def test_checkpoint_leaves_equal_jax_file(tmp_path):
    jstate, tstate = _states()
    j_checkpoint.save_checkpoint(tmp_path / "j.npz", jstate)
    checkpoint.save_checkpoint(tmp_path / "t.npz", tstate)
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        mj, mt = json.loads(str(zj["__manifest__"])), json.loads(str(zt["__manifest__"]))
        assert mj["n_leaves"] == mt["n_leaves"] == 10
        for i in range(mt["n_leaves"]):
            a, b = zt[f"leaf_{i}"], zj[f"leaf_{i}"]
            assert a.dtype == b.dtype and a.shape == b.shape, i
            np.testing.assert_array_equal(a, b)
    # the port loads either file into its template, leaves on the device asked
    for name in ("t.npz", "j.npz"):
        back = checkpoint.load_checkpoint(tmp_path / name, tstate, device="cpu")
        assert list(back) == list(tstate)
        torch.testing.assert_close(back["pose"].R, tstate["pose"].R, rtol=0, atol=0)
        assert int(back["step"]) == 7 and back["items"][1][1] is None
        assert back["cloud"].feat_names == ("intensity",)
        torch.testing.assert_close(back["cloud"].feats, tstate["cloud"].feats, rtol=0, atol=0)
        assert back["zeta"].device.type == "cpu"


def test_checkpoint_structure_mismatch_raises(tmp_path):
    state = {"a": torch.ones(3), "b": torch.zeros(3)}
    p = tmp_path / "s.npz"
    checkpoint.save_checkpoint(p, state)
    with pytest.raises(ValueError, match="structure"):
        checkpoint.load_checkpoint(p, (torch.ones(3), torch.zeros(3)), device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_checkpoint(p, {"a": torch.ones(3)}, device="cpu")
    # the JAX package refuses the same mismatch
    j_checkpoint.save_checkpoint(tmp_path / "j.npz", {"a": jnp.ones(3), "b": jnp.zeros(3)})
    with pytest.raises(ValueError):
        j_checkpoint.load_checkpoint(tmp_path / "j.npz", (jnp.ones(3), jnp.zeros(3)))


def test_pytree_paths_read_like_jax_keystr():
    import jax

    jstate, tstate = _states()
    paths = [p for p, _ in pytree.flatten(tstate)[0]]
    jpaths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert paths == jpaths


# ---- profiling -----------------------------------------------------------------------


def test_time_fn_counts_reps_and_cache_bust():
    calls = []

    def f(x, eps):
        calls.append(eps)
        return x + eps

    t = profiling.time_fn(f, torch.ones(8), reps=3, cache_bust=lambda k: float(k))
    assert t >= 0 and calls == [0.0, 1.0, 2.0, 3.0]  # 1 warm-up + 3 reps
    with profiling.Timer() as timer:
        out = timer.block({"a": torch.ones(2), "b": [torch.zeros(1)]})
    assert timer.elapsed >= 0 and out["a"].sum() == 2


def test_trace_context_writes_a_trace(tmp_path):
    with profiling.trace_context(tmp_path / "trace"):
        torch.ones(16).sum()
    assert any((tmp_path / "trace").iterdir())


# ---- debug ----------------------------------------------------------------------------


def test_nan_checks_trap_nans_inside_the_scope_only():
    with debug.nan_checks():
        ok = torch.ones(4) * 2
        with pytest.raises(FloatingPointError, match="NaN"):
            torch.log(torch.tensor([-1.0]))
    assert ok.sum() == 8
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()  # off again
    with debug.nan_checks(enabled=False):
        torch.log(torch.tensor([-1.0]))


def test_deterministic_mode_pins_and_restores_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with debug.deterministic_mode():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert not torch.are_deterministic_algorithms_enabled()


def test_assert_all_finite_names_the_leaf_as_jax_does():
    debug.assert_all_finite({"a": torch.ones(3), "b": [np.zeros(2)], "i": torch.tensor([1, 2])})
    bad_t = {"x": [torch.ones(2), torch.tensor([1.0, float("inf"), float("nan")])]}
    bad_j = {"x": [jnp.ones(2), jnp.asarray([1.0, float("inf"), float("nan")])]}
    with pytest.raises(FloatingPointError) as got:
        debug.assert_all_finite(bad_t, "state")
    with pytest.raises(FloatingPointError) as ref:
        j_debug.assert_all_finite(bad_j, "state")
    assert str(got.value) == str(ref.value) == "state['x'][1]: 2 non-finite values"


# ---- viz ------------------------------------------------------------------------------


def test_viz_renders(tmp_path):
    pytest.importorskip("matplotlib")
    from icpx_torch.io.loaders import synthetic_surface
    from icpx_torch.viz import render_clouds, render_trajectory

    pc = PointCloud.create(synthetic_surface(500), device="cpu")
    out = tmp_path / "c.png"
    render_clouds(out, [pc, pc], ["a", "b"], title="t")
    assert out.stat().st_size > 1000
    poses = [SE3.identity(device="cpu")] * 3
    out2 = tmp_path / "sub" / "t.png"
    render_trajectory(out2, poses, poses)
    assert out2.stat().st_size > 1000


# ---- fault injectors ---------------------------------------------------------------------


@pytest.mark.parametrize("shard", [0, 2, 3])
def test_drop_shard_equals_jax(shard):
    from icpx.distributed.fault import drop_shard as j_drop_shard

    mask = np.random.default_rng(shard).uniform(size=1001) < 0.9
    got = drop_shard(torch.as_tensor(mask), shard, 4)
    np.testing.assert_array_equal(to_np(got), np.asarray(j_drop_shard(jnp.asarray(mask), shard, 4)))


def test_corrupt_points_by_its_contract():
    xyz = torch.as_tensor(np.random.default_rng(2).normal(size=(20000, 3)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    out = corrupt_points(xyz, g, fraction=0.05, magnitude=100.0)
    moved = (out != xyz).any(1)
    assert 0.04 < float(moved.float().mean()) < 0.06  # the hit fraction
    torch.testing.assert_close(out[~moved], xyz[~moved], rtol=0, atol=0)  # untouched rows
    shift = (out - xyz)[moved]
    assert 80.0 < float(shift.std()) < 120.0  # magnitude x a standard normal
    again = corrupt_points(xyz, torch.Generator().manual_seed(0), fraction=0.05, magnitude=100.0)
    torch.testing.assert_close(again, out, rtol=0, atol=0)  # the generator seeds it
    assert not (corrupt_points(xyz, fraction=0.0) != xyz).any()

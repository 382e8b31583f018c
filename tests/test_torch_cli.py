"""Port parity: `icpx_torch.cli` against `icpx.cli`, on the CPU.

Each test runs the same arguments through both CLIs in process (the port's
with ``--device cpu``) and compares what they print (transforms to 1e-4)
and the files they write. The counterparts of tests/test_cli.py's tests
but the odometry ones (tests/test_torch_cli_odometry.py), and the port's
own: `--weight-feat` from a file, the device refusal, `bench`, and a run
with JAX and `icpx` blocked.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import icpx.cli as j_cli
import icpx_torch.cli as t_cli
from icpx.cloud import PointCloud as JCloud
from icpx.io import load_cloud as j_load_cloud
from icpx.io import save_cloud as j_save_cloud
from icpx.io.loaders import synthetic_surface
from icpx_torch.io import load_cloud
from torch_parity import cli_refuses, cli_rows, cli_transform, run_both

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    # the JAX CLI's persistent compile cache would write under $HOME
    monkeypatch.setenv("ICPX_NO_COMPILE_CACHE", "1")


@pytest.fixture
def cloud_file(tmp_path):
    path = tmp_path / "src.pcd"
    j_save_cloud(path, JCloud.create(synthetic_surface(800, seed=0)))
    return path


def test_info(cloud_file, capsys, tmp_path):
    jout, tout, _, _ = run_both(capsys, lambda d: ["info", str(cloud_file)], tmp_path)
    assert "800 points" in tout
    assert tout == jout


def test_convert(cloud_file, tmp_path, capsys):
    jout, tout, jd, td = run_both(capsys, lambda d: ["convert", str(cloud_file), str(d / "out.ply")],
                                  tmp_path)
    assert tout.replace("torch", "jax") == jout
    assert (td / "out.ply").read_bytes() == (jd / "out.ply").read_bytes()
    assert int(load_cloud(td / "out.ply", device="cpu").num_valid()) == 800


def test_perturb_then_register(cloud_file, tmp_path, capsys):
    jout, tout, jd, td = run_both(capsys, lambda d: [
        "perturb", str(cloud_file), str(d / "tgt.pcd"), "--angle", "0.2",
        "--translate", "0.1", "0", "0"], tmp_path)
    assert tout.replace("torch", "jax") == jout
    np.testing.assert_allclose(load_cloud(td / "tgt.pcd", device="cpu").to_numpy(),
                               np.asarray(j_load_cloud(jd / "tgt.pcd").to_numpy()), atol=1e-6)
    tgt = jd / "tgt.pcd"  # both register onto the same file
    jout, tout, jd, td = run_both(capsys, lambda d: [
        "register", str(cloud_file), str(tgt), "--max-iters", "12", "--diff-threshold", "1e-5",
        "--out", str(d / "aligned.pcd"), "--metrics", str(d / "m.jsonl")], tmp_path)
    assert "iters#1 / diff:" in tout and "transform:" in tout
    np.testing.assert_allclose(cli_transform(tout), cli_transform(jout), atol=1e-4)
    recs = [json.loads(line) for line in (td / "m.jsonl").read_text().splitlines()]
    jrecs = [json.loads(line) for line in (jd / "m.jsonl").read_text().splitlines()]
    assert recs[-1]["event"] == jrecs[-1]["event"] == "icp_done"
    assert [r["event"] for r in recs] == [r["event"] for r in jrecs]
    assert recs[-1]["inliers"] == jrecs[-1]["inliers"]
    a = load_cloud(td / "aligned.pcd", device="cpu").to_numpy()
    np.testing.assert_allclose(a, np.asarray(j_load_cloud(jd / "aligned.pcd").to_numpy()), atol=1e-3)
    b = load_cloud(tgt, device="cpu").to_numpy()
    assert np.abs(np.sort(a[:, 0]) - np.sort(b[:, 0])).mean() < 1e-3


def test_horn(cloud_file, tmp_path, capsys):
    tgt = tmp_path / "t.pcd"
    j_cli.main(["perturb", str(cloud_file), str(tgt), "--angle", "0.3"])
    jout, tout, _, _ = run_both(capsys, lambda d: ["horn", str(cloud_file), str(tgt)], tmp_path)
    assert "R:" in tout
    np.testing.assert_allclose(cli_rows(tout, "R:", 3), cli_rows(jout, "R:", 3), atol=1e-4)
    t = [line for line in tout.splitlines() if line.startswith("t: ")][0]
    jt = [line for line in jout.splitlines() if line.startswith("t: ")][0]
    np.testing.assert_allclose(np.array(t.split()[1:], float), np.array(jt.split()[1:], float),
                               atol=1e-4)


def test_register_config_override(cloud_file, tmp_path, capsys):
    cfgf = tmp_path / "cfg.json"
    cfgf.write_text(json.dumps({"robust": "huber", "max_iters": 3}))
    jout, tout, _, _ = run_both(capsys, lambda d: [
        "register", str(cloud_file), str(cloud_file), "--config", str(cfgf)], tmp_path)
    assert "iters=3" in tout or "converged=True" in tout
    np.testing.assert_allclose(cli_transform(tout), cli_transform(jout), atol=1e-4)


def test_register_ndt_objective(cloud_file, tmp_path, capsys):
    tgt = tmp_path / "nt.pcd"
    j_cli.main(["perturb", str(cloud_file), str(tgt), "--angle", "0.1"])
    jout, tout, _, _ = run_both(capsys, lambda d: [
        "register", str(cloud_file), str(tgt), "--objective", "ndt", "--ndt-cell", "32",
        "--max-iters", "25", "--diff-threshold", "0"], tmp_path)
    assert "converged" in tout
    np.testing.assert_allclose(cli_transform(tout), cli_transform(jout), atol=1e-4)


def test_register_ndt_rejects_pyramid(cloud_file, tmp_path):
    tgt = tmp_path / "t2.pcd"
    j_cli.main(["perturb", str(cloud_file), str(tgt), "--angle", "0.1"])
    cli_refuses(["register", str(cloud_file), str(tgt), "--objective", "ndt",
               "--pyramid-levels", "2"], "ndt does not compose")


def test_data_dir_env_read_at_call_time(tmp_path, monkeypatch):
    from icpx_torch.io import loaders

    monkeypatch.setenv("ICPX_DATA_DIR", str(tmp_path))
    assert loaders.reference_data_dir() == tmp_path
    assert loaders.REFERENCE_DATA_DIR == tmp_path  # dynamic module attribute
    assert not loaders.has_reference_data()
    monkeypatch.delenv("ICPX_DATA_DIR")
    assert loaders.has_reference_data()


def test_register_weight_feat_from_a_file(tmp_path, capsys):
    """A source PCD with an intensity column used as per-point weights: the
    column loads (the payload repair) and both CLIs weight by it alike."""
    rng = np.random.default_rng(3)
    xyz = synthetic_surface(900, seed=2)
    src = tmp_path / "w.pcd"
    j_save_cloud(src, JCloud.create(xyz, feats=rng.uniform(0.2, 1.0, (900, 1)).astype(np.float32),
                                    feat_names=("intensity",)))
    tgt = tmp_path / "wt.pcd"
    j_cli.main(["perturb", str(src), str(tgt), "--angle", "0.15"])
    assert load_cloud(src, device="cpu").feat_names == ("intensity",)
    jout, tout, _, _ = run_both(capsys, lambda d: [
        "register", str(src), str(tgt), "--weight-feat", "intensity", "--max-iters", "15",
        "--diff-threshold", "1e-5"], tmp_path)
    np.testing.assert_allclose(cli_transform(tout), cli_transform(jout), atol=1e-4)


def test_device_cuda_is_refused_without_a_card(cloud_file, monkeypatch):
    """No silent fall back to the CPU: without a card, the default device
    (cuda) fails with a message that names --device cpu."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t_cli.main(["info", str(cloud_file)])


@pytest.mark.parametrize("argv", [["bench"], ["bench", "--n", "1000"],
                                  ["--device", "cpu", "bench", "--reps", "1"]])
def test_bench_names_the_missing_harness(argv):
    with pytest.raises(SystemExit, match="step 5a"):
        t_cli.main(argv)


def test_cli_imports_neither_jax_nor_icpx(cloud_file, tmp_path):
    """`python -m icpx_torch.cli` with every jax* and icpx module blocked:
    info, convert, perturb and register run, and neither is imported."""
    code = f"""
import runpy, sys
for name in ("jax", "jaxlib", "icpx", "flax"):
    sys.modules[name] = None  # any import of them now raises ImportError
for argv in (["info", {str(cloud_file)!r}],
             ["convert", {str(cloud_file)!r}, {str(tmp_path / 'c.ply')!r}, "--binary"],
             ["perturb", {str(tmp_path / 'c.ply')!r}, {str(tmp_path / 'p.pcd')!r}, "--angle", "0.1"],
             ["register", {str(cloud_file)!r}, {str(tmp_path / 'p.pcd')!r}, "--max-iters", "5"]):
    sys.argv = ["icpx-torch", "--device", "cpu", *argv]
    try:
        runpy.run_module("icpx_torch.cli", run_name="__main__")
    except SystemExit as e:
        assert not e.code, e.code
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "icpx", "flax")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("clean")
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean") and "transform:" in proc.stdout

"""`chip_smoke.py` off the card: its refusals, and its control flow rehearsed
on the CPU with the kernel's plain version standing in for the kernel."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import chip_smoke
import torch_parity  # noqa: F401  (pins torch's thread count per worker)
from icpx_torch.kernels import nn_cuda
from icpx_torch.registration import icp

ROOT = Path(__file__).resolve().parent.parent


def test_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        chip_smoke.main()
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py the script exits non-zero
    and prints no result (no package to import, or no card)."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


class _Event:
    """Host-clock stand-in for torch.cuda.Event."""

    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_rehearsal_on_cpu(monkeypatch, capsys):
    def fake_kernel(q, r, m=None):
        nn_cuda.LAUNCHES += 1
        return nn_cuda.nearest_neighbor_reference(q, r, ref_mask=m)

    def dispatch(query, ref, *, ref_mask=None, tile_q=2048, tile_r=4096):
        return fake_kernel(query.contiguous(), ref.contiguous(), ref_mask)

    real_run = subprocess.run

    def fake_run(cmd, **kw):
        if cmd[0] == "nvidia-smi":
            return subprocess.CompletedProcess(cmd, 0, stdout="Fake GPU, 700.00 W\n")
        return real_run(cmd, **kw)

    monkeypatch.setattr(nn_cuda, "nn_cuda", fake_kernel)
    monkeypatch.setattr(nn_cuda, "build", lambda: None)
    monkeypatch.setattr(icp, "nearest_neighbor", dispatch)
    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    for name, value in (
        ("get_device_name", lambda i=0: "Fake GPU"),
        ("device_count", lambda: 1),
        ("synchronize", lambda *a: None),
        ("reset_peak_memory_stats", lambda *a: None),
        ("max_memory_allocated", lambda *a: 0),
        ("Event", _Event),
    ):
        monkeypatch.setattr(torch.cuda, name, value)

    chip_smoke.main(dev=torch.device("cpu"), n_pair=2048)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "Fake GPU", "count": 1}}
    (k,) = json.loads(lines[-2])["kernels"]
    assert k["route"] == "cuda" and k["source"] == "icpx_torch/csrc/nn.cu"
    assert (ROOT / k["source"]).exists()
    assert k["replaces"] == "icpx/kernels/knn_pallas.py:37"
    assert k["launches"] >= 2 and k["max_abs_err"] == 0.0
    assert "Fake GPU, 700.00 W" in lines
    assert any(line.startswith("cat: ") for line in lines)
    assert any(line.startswith("65k pair: ") for line in lines)

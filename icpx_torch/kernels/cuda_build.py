"""Builds the port's CUDA sources into shared libraries loaded with ctypes.

Every `icpx_torch/csrc/<stem>.cu` has a plain C interface. At first use it
is compiled with plain `nvcc` for sm_90a into `icpx_torch/_build/`, under a
name keyed on a hash of the source and the flags, and loaded with `ctypes`.
`compile_all` starts one `nvcc` per source that the cache misses, all at
once, and waits for them: a fresh checkout builds every kernel in the time
of the slowest one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
STEMS = ("nn", "blocknn", "sort")  # every source in csrc/
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_path(stem: str) -> Path:
    return CSRC / f"{stem}.cu"


def library_path(stem: str) -> Path:
    """Where the built library for the current source of `stem` lives."""
    h = hashlib.sha256(source_path(stem).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libicpx_{stem}-{h.hexdigest()[:16]}.so"


def build_log(stem: str) -> str:
    """nvcc's output for the current library of `stem` (the ptxas register,
    shared-memory and spill report), kept beside it; "" before a build."""
    log = library_path(stem).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def compile_all(stems: Sequence[str] = STEMS) -> None:
    """Compile every library of `stems` whose cache misses, in parallel."""
    jobs = []
    for stem in stems:
        path = library_path(stem)
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(source_path(stem))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((stem, path, tmp, proc))
    failed = []
    for stem, path, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode == 0:
            path.with_suffix(".log").write_text(out)
            os.replace(tmp, path)  # atomic: a concurrent build never sees a partial file
        else:
            failed.append(f"nvcc {stem}.cu failed ({proc.returncode}):\n{out}")
        if os.path.exists(tmp):
            os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(stem: str) -> ctypes.CDLL:
    """Build `stem` if needed and load it; every library exports
    `icpx_cuda_error_string(int) -> const char*`."""
    compile_all([stem])
    lib = ctypes.CDLL(str(library_path(stem)))
    lib.icpx_cuda_error_string.argtypes = [ctypes.c_int]
    lib.icpx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.icpx_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")

"""ctypes binding of the native C++ IO library (`native/icpx_io.cpp`).

Mirrors `icpx/io/native.py`: the loaders' byte-level loops (float tables
of ASCII PCD / xyz, float formatting for the writers, LZF for
``binary_compressed`` PCD, KITTI's xyz records) are C++, and Python keeps
header parsing and dispatch. The library is host code, not a device path.

It is compiled on first use with ``g++ -O3 -fPIC -shared -std=c++17`` into
`icpx_torch/_build/`, under a name keyed on a hash of the source and the
flags, as `kernels/cuda_build.py` builds the CUDA sources; nothing is
written beside the source. ``ICPX_NO_NATIVE=1`` (read at each call), a
missing source or a missing compiler make every entry return None, and the
callers fall back to numpy. `CALLS` counts the calls the library served and
`FALLBACKS` the calls it could not, by entry point.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "icpx_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
ABI_VERSION = 3

ENTRIES = ("parse_float_table", "parse_float_columns", "format_float_table",
           "lzf_compress", "lzf_decompress", "kitti_xyz")
CALLS: Dict[str, int] = {name: 0 for name in ENTRIES}
FALLBACKS: Dict[str, int] = {name: 0 for name in ENTRIES}

_lock = threading.Lock()
_count_lock = threading.Lock()  # the prefetcher's threads call the readers
_lib: Optional[ctypes.CDLL] = None
_tried = False

_I64 = ctypes.c_int64
_FPTR = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "icpx_parse_float_table": [ctypes.c_char_p, _I64, _I64, _FPTR, _I64],
    "icpx_parse_float_columns": [ctypes.c_char_p, _I64, _I64, _I64, _I64, _I64, _FPTR],
    "icpx_format_float_table": [_FPTR, _I64, _I64, ctypes.c_char_p, _I64],
    "icpx_kitti_xyz": [ctypes.c_char_p, _I64, _FPTR],
    "icpx_lzf_compress": [ctypes.c_char_p, _I64, ctypes.c_char_p, _I64],
    "icpx_lzf_decompress": [ctypes.c_char_p, _I64, ctypes.c_char_p, _I64],
}


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libicpx_io-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    if not SOURCE.exists():
        return None
    out = library_path()
    if out.exists():
        return out
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
    except OSError:
        return None
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
        return out
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None when ICPX_NO_NATIVE is
    set or it cannot be built or loaded (callers fall back to numpy)."""
    global _lib, _tried
    if os.environ.get("ICPX_NO_NATIVE"):
        return None
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = ctypes.c_int64, args
        if lib.icpx_io_abi_version() != ABI_VERSION:
            return None
        _lib = lib
        return _lib


def _served(name: str, out):
    """Count one call of entry `name`: served when `out` is not None."""
    with _count_lock:
        (CALLS if out is not None else FALLBACKS)[name] += 1
    return out


def reset_counts() -> None:
    for name in ENTRIES:
        CALLS[name] = FALLBACKS[name] = 0


def parse_float_table(text: bytes, n_rows: int, n_cols: int) -> Optional[np.ndarray]:
    """Whitespace-separated floats -> (n_rows, n_cols) float32, or None when
    the library is unavailable or a line is malformed or missing (numpy
    then raises a real error rather than misaligning columns)."""
    lib = get_lib()
    out = None
    if lib is not None:
        mat = np.empty((n_rows, n_cols), np.float32)
        got = lib.icpx_parse_float_table(text, len(text), n_rows * n_cols,
                                         mat.ctypes.data_as(_FPTR), n_cols)
        out = mat if got == n_rows * n_cols else None
    return _served("parse_float_table", out)


def parse_float_columns(text: bytes, n_rows: int, row_cols: int, col0: int,
                        n_take: int) -> Optional[np.ndarray]:
    """Columns [col0, col0 + n_take) of rows of `row_cols` floats ->
    (n_rows, n_take) float32, or None as `parse_float_table`."""
    lib = get_lib()
    out = None
    if lib is not None:
        mat = np.zeros((n_rows, n_take), np.float32)
        got = lib.icpx_parse_float_columns(text, len(text), n_rows, row_cols, col0, n_take,
                                           mat.ctypes.data_as(_FPTR))
        out = mat if got == n_rows else None
    return _served("parse_float_columns", out)


def format_float_table(values: np.ndarray) -> Optional[bytes]:
    """(n, c) float32 -> ASCII rows ("%.9g", space separated, '\\n' rows)."""
    lib = get_lib()
    out = None
    if lib is not None:
        values = np.ascontiguousarray(values, np.float32)
        n, c = values.shape
        cap = n * c * 20 + n + 64
        buf = ctypes.create_string_buffer(cap)
        wrote = lib.icpx_format_float_table(values.ctypes.data_as(_FPTR), n, c, buf, cap)
        out = buf.raw[:wrote] if wrote >= 0 else None
    return _served("format_float_table", out)


def lzf_compress(data: bytes) -> Optional[bytes]:
    """LZF (liblzf's format, as PCL's ``binary_compressed`` uses)."""
    lib = get_lib()
    out = None
    if lib is not None:
        cap = len(data) + len(data) // 16 + 64
        buf = ctypes.create_string_buffer(cap)
        n = lib.icpx_lzf_compress(data, len(data), buf, cap)
        out = buf.raw[:n] if n > 0 else None
    return _served("lzf_compress", out)


def lzf_decompress(data: bytes, expected: int) -> Optional[bytes]:
    lib = get_lib()
    out = None
    if lib is not None:
        buf = ctypes.create_string_buffer(expected)
        n = lib.icpx_lzf_decompress(data, len(data), buf, expected)
        out = buf.raw[:expected] if n == expected else None
    return _served("lzf_decompress", out)


def kitti_xyz(raw: bytes) -> Optional[np.ndarray]:
    """KITTI velodyne records (float32 x, y, z, reflectance) -> (N, 3) xyz."""
    lib = get_lib()
    out = None
    if lib is not None:
        out = np.empty((len(raw) // 16, 3), np.float32)
        lib.icpx_kitti_xyz(raw, len(raw), out.ctypes.data_as(_FPTR))
    return _served("kitti_xyz", out)

"""PCD v0.7 reader/writer: ``DATA ascii``, ``binary`` and
``binary_compressed`` (LZF, PCL's field-major layout).

Mirrors `icpx/io/pcd.py`'s header grammar and field handling (including
the multi-field `PointXYZLNormal` layout of the reference's
`cat_out.pcd`). ASCII bodies are parsed and formatted, and LZF payloads
compressed and decompressed, by the native IO library (`io/native.py`);
without it ASCII falls back to numpy and LZF decompression to the pure
Python decoder here, while a compressed write needs the library.
"""

from __future__ import annotations

import io as _io
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np

from icpx_torch.io import native

_TYPE_MAP = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
    ("I", 8): np.int64,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
    ("U", 8): np.uint64,
}
_INV_TYPE_MAP = {np.dtype(v): k for k, v in _TYPE_MAP.items()}

_DEFAULT_VIEWPOINT = [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]


@dataclass
class PCDHeader:
    version: str = "0.7"
    fields: List[str] = field(default_factory=lambda: ["x", "y", "z"])
    size: List[int] = field(default_factory=lambda: [4, 4, 4])
    type: List[str] = field(default_factory=lambda: ["F", "F", "F"])
    count: List[int] = field(default_factory=lambda: [1, 1, 1])
    width: int = 0
    height: int = 1
    viewpoint: List[float] = field(default_factory=lambda: list(_DEFAULT_VIEWPOINT))
    points: int = 0
    data: str = "ascii"


def _parse_header(stream) -> PCDHeader:
    hdr = PCDHeader()
    while True:
        raw = stream.readline()
        if not raw:
            raise ValueError("PCD: EOF before DATA line")
        line = raw.decode("ascii", errors="replace").strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        key, vals = parts[0].upper(), parts[1:]
        if key == "VERSION":
            hdr.version = vals[0] if vals else "0.7"
        elif key in ("FIELDS", "COLUMNS"):
            hdr.fields = [v.lower() for v in vals]
        elif key == "SIZE":
            hdr.size = [int(v) for v in vals]
        elif key == "TYPE":
            hdr.type = [v.upper() for v in vals]
        elif key == "COUNT":
            hdr.count = [int(v) for v in vals]
        elif key == "WIDTH":
            hdr.width = int(vals[0])
        elif key == "HEIGHT":
            hdr.height = int(vals[0])
        elif key == "VIEWPOINT":
            hdr.viewpoint = [float(v) for v in vals]
        elif key == "POINTS":
            hdr.points = int(vals[0])
        elif key == "DATA":
            hdr.data = vals[0].lower()
            break
        # unknown keys are skipped
    if len(hdr.count) != len(hdr.fields):
        hdr.count = [1] * len(hdr.fields)
    if hdr.points == 0:
        hdr.points = hdr.width * hdr.height
    if hdr.width == 0:
        hdr.width, hdr.height = hdr.points, 1
    return hdr


def _struct_dtype(hdr: PCDHeader) -> np.dtype:
    entries = []
    for name, sz, ty, cnt in zip(hdr.fields, hdr.size, hdr.type, hdr.count):
        base = _TYPE_MAP.get((ty, sz))
        if base is None:
            raise ValueError(f"PCD: unsupported TYPE/SIZE {ty}{sz} for field {name}")
        entries.append((name, base) if cnt == 1 else (name, base, (cnt,)))
    return np.dtype(entries)


def _read_ascii(body: bytes, hdr: PCDHeader, dtype: np.dtype, n: int) -> np.ndarray:
    n_cols = sum(hdr.count)
    # Wide integer fields (packed rgb, large labels) exceed float32's 2^24
    # integer range: such files take the float64 numpy path, exact to 2^53.
    wide_int = any(t in ("I", "U") and s >= 4 for t, s in zip(hdr.type, hdr.size))
    mat = None if wide_int else native.parse_float_table(body, n, n_cols)
    if mat is None:
        mat = np.genfromtxt(
            _io.StringIO(body.decode("ascii", errors="replace")),
            dtype=np.float64,
            max_rows=n,
            invalid_raise=False,
        )
    mat = np.atleast_2d(mat)
    if mat.shape[0] < n:
        raise ValueError(f"PCD: expected {n} rows, got {mat.shape[0]}")
    if mat.shape[1] != n_cols:
        raise ValueError(f"PCD: expected {n_cols} columns, got {mat.shape[1]}")
    rec = np.zeros(n, dtype=dtype)
    col = 0
    for name, cnt in zip(hdr.fields, hdr.count):
        if cnt == 1:
            rec[name] = mat[:, col].astype(rec[name].dtype)
        else:
            rec[name] = mat[:, col : col + cnt].astype(rec[name].dtype)
        col += cnt
    return rec


def read_pcd(path_or_bytes: Union[str, os.PathLike, bytes]) -> Dict[str, np.ndarray]:
    """Read a PCD file -> dict of field name to (N,) or (N, count) arrays.

    Always provides ``"xyz"`` (N, 3) float32, plus ``"normals"`` (N, 3)
    when normal_{x,y,z} fields are present, and the raw per-field arrays.
    """
    if isinstance(path_or_bytes, bytes):
        stream = _io.BytesIO(path_or_bytes)
    else:
        stream = open(path_or_bytes, "rb")
    with stream:
        hdr = _parse_header(stream)
        dtype = _struct_dtype(hdr)
        n = hdr.points
        if hdr.data == "ascii":
            rec = _read_ascii(stream.read(), hdr, dtype, n)
        elif hdr.data == "binary":
            buf = stream.read()
            need = dtype.itemsize * n
            if len(buf) < need:
                raise ValueError("PCD: binary payload truncated")
            if len(buf) >= need + dtype.itemsize:
                raise ValueError(
                    f"PCD: header declares {n} points but payload holds "
                    f"{len(buf) // dtype.itemsize}"
                )
            rec = np.frombuffer(buf, dtype=dtype, count=n).copy()
        elif hdr.data == "binary_compressed":
            rec = _read_binary_compressed(stream, dtype, n)
        else:
            raise ValueError(f"PCD: unsupported DATA kind {hdr.data!r}")

    out: Dict[str, np.ndarray] = {name: np.asarray(rec[name]) for name in hdr.fields}
    if all(k in out for k in ("x", "y", "z")):
        out["xyz"] = np.stack([out["x"], out["y"], out["z"]], axis=-1).astype(np.float32)
    if all(k in out for k in ("normal_x", "normal_y", "normal_z")):
        out["normals"] = np.stack(
            [out["normal_x"], out["normal_y"], out["normal_z"]], axis=-1
        ).astype(np.float32)
    out["_header"] = hdr  # type: ignore[assignment]
    return out


def _read_binary_compressed(stream, dtype: np.dtype, n: int) -> np.ndarray:
    """An LZF payload: u32 compressed and raw sizes, then the compressed
    bytes of the field-major (SoA) body, every x, then every y, ..."""
    comp_size, raw_size = struct.unpack("<II", stream.read(8))
    raw = _lzf_decompress(stream.read(comp_size), raw_size)
    out = np.zeros(n, dtype=dtype)
    offset = 0
    for name in dtype.names:
        sub = dtype[name]
        base = sub.base if sub.shape else sub
        cnt = int(np.prod(sub.shape)) if sub.shape else 1
        nbytes = base.itemsize * n * cnt
        arr = np.frombuffer(raw[offset:offset + nbytes], dtype=base)
        out[name] = arr if cnt == 1 else arr.reshape(n, cnt)
        offset += nbytes
    return out


def _lzf_decompress(data: bytes, expected: int) -> bytes:
    """The native decoder, else the pure Python one."""
    out = native.lzf_decompress(data, expected)
    return out if out is not None else _lzf_decompress_py(data, expected)


def _lzf_decompress_py(data: bytes, expected: int) -> bytes:
    """Minimal LZF decompressor (liblzf's format)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # a literal run of ctrl + 1 bytes
            run = ctrl + 1
            out += data[i:i + run]
            i += run
        else:  # a back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    if len(out) != expected:
        raise ValueError(f"LZF: expected {expected} bytes, got {len(out)}")
    return bytes(out)


def write_pcd(
    path: Union[str, os.PathLike],
    xyz: np.ndarray,
    *,
    normals: Optional[np.ndarray] = None,
    extra_fields: Optional[Dict[str, np.ndarray]] = None,
    binary: bool = False,
    compressed: bool = False,
    viewpoint: Optional[List[float]] = None,
) -> None:
    """Write a PCD v0.7 file: ascii (default), binary, or binary_compressed
    (LZF, field-major: PCL's layout)."""
    xyz = np.asarray(xyz, dtype=np.float32)
    n = xyz.shape[0]
    names = ["x", "y", "z"]
    cols: List[np.ndarray] = [xyz[:, 0], xyz[:, 1], xyz[:, 2]]
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32)
        names += ["normal_x", "normal_y", "normal_z"]
        cols += [normals[:, 0], normals[:, 1], normals[:, 2]]
    for k, v in (extra_fields or {}).items():
        v = np.asarray(v)
        if v.ndim != 1 or v.shape[0] != n:
            raise ValueError(f"extra field {k} must be (n,)")
        names.append(k)
        cols.append(v)

    types, sizes = zip(*(_INV_TYPE_MAP.get(c.dtype, ("F", 4)) for c in cols))
    vp = viewpoint or _DEFAULT_VIEWPOINT
    kind = "binary_compressed" if compressed else ("binary" if binary else "ascii")
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(names)}\n"
        f"SIZE {' '.join(str(s) for s in sizes)}\n"
        f"TYPE {' '.join(types)}\n"
        f"COUNT {' '.join('1' for _ in names)}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        f"VIEWPOINT {' '.join(_fmt(v) for v in vp)}\n"
        f"POINTS {n}\n"
        f"DATA {kind}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if compressed:
            raw = b"".join(np.ascontiguousarray(c).tobytes() for c in cols)
            comp = native.lzf_compress(raw)
            if comp is None:
                raise RuntimeError(
                    "a binary_compressed write needs the native IO library "
                    "(unset ICPX_NO_NATIVE, or install a C++ compiler)"
                )
            f.write(struct.pack("<II", len(comp), len(raw)))
            f.write(comp)
        elif binary:
            rec = np.zeros(
                n,
                dtype=np.dtype(
                    [(nm, c.dtype if c.dtype in _INV_TYPE_MAP else np.float32)
                     for nm, c in zip(names, cols)]
                ),
            )
            for nm, c in zip(names, cols):
                rec[nm] = c
            f.write(rec.tobytes())
        else:
            payload = None
            if all(c.dtype == np.float32 for c in cols):
                payload = native.format_float_table(np.stack(cols, axis=1))
            if payload is None:
                body = _io.StringIO()
                for i in range(n):
                    body.write(" ".join(_fmt(c[i]) for c in cols))
                    body.write("\n")
                payload = body.getvalue().encode("ascii")
            f.write(payload)


def _fmt(v) -> str:
    """Shortest decimal that round-trips the float32 value (no digit cap:
    a float32 can need 9 significant digits)."""
    if isinstance(v, (np.integer, int)):
        return str(int(v))
    s = np.format_float_positional(np.float32(v), unique=True, trim="0")
    return s.rstrip(".") or "0"

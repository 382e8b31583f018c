"""PLY reader/writer: ascii, binary little- and big-endian vertices.

Mirrors `icpx/io/ply.py`. Only the vertex element is interpreted
(positions, optional normals ``nx ny nz`` and any scalar properties); a
non-vertex element before it is skipped (a list-typed one cannot be, and
raises), elements after it are ignored.
"""

from __future__ import annotations

import io as _io
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

_PLY_TYPES = {
    "char": np.int8, "int8": np.int8,
    "uchar": np.uint8, "uint8": np.uint8,
    "short": np.int16, "int16": np.int16,
    "ushort": np.uint16, "uint16": np.uint16,
    "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32,
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
}


def _parse_header(stream):
    """(format, [(element name, count, [(property, dtype or None for a list)])])."""
    if stream.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: List[Tuple[str, int, list]] = []
    while True:
        line = stream.readline()
        if not line:
            raise ValueError("PLY: EOF in header")
        tok = line.decode("ascii").strip().split()
        if not tok or tok[0] == "comment":
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property" and elements:
            dt = None if tok[1] == "list" else np.dtype(_PLY_TYPES[tok[1]])
            elements[-1][2].append((tok[-1], dt))
        elif tok[0] == "end_header":
            return fmt, elements


def _read_vertices(stream, fmt: str, count: int, props) -> np.ndarray:
    if any(dt is None for _, dt in props):
        raise ValueError("PLY: list property in vertex element")
    dtype = np.dtype(props)
    if fmt == "ascii":
        mat = np.asarray([[float(v) for v in stream.readline().split()] for _ in range(count)],
                         dtype=np.float64).reshape(count, len(props))
        rec = np.zeros(count, dtype=dtype)
        for j, (pname, _) in enumerate(props):
            rec[pname] = mat[:, j]
        return rec
    if fmt == "binary_little_endian":
        return np.frombuffer(stream.read(dtype.itemsize * count), dtype=dtype, count=count).copy()
    if fmt == "binary_big_endian":
        big = dtype.newbyteorder(">")
        return np.frombuffer(stream.read(big.itemsize * count), dtype=big, count=count).astype(dtype)
    raise ValueError(f"PLY: unsupported format {fmt}")


def read_ply(path: Union[str, os.PathLike, bytes]) -> Dict[str, np.ndarray]:
    """Read PLY -> dict with ``"xyz"`` (N, 3) float32, ``"normals"`` when
    nx/ny/nz are present, and every vertex property under its own name."""
    stream = _io.BytesIO(path) if isinstance(path, bytes) else open(path, "rb")
    out: Dict[str, np.ndarray] = {}
    with stream:
        fmt, elements = _parse_header(stream)
        for name, count, props in elements:
            if name == "vertex":
                rec = _read_vertices(stream, fmt, count, props)
                out.update({pname: np.asarray(rec[pname]) for pname, _ in props})
                break  # elements after the vertices are ignored
            if any(dt is None for _, dt in props):
                raise ValueError("PLY: list-typed element precedes vertex "
                                 "(cannot compute skip size)")
            if fmt == "ascii":
                for _ in range(count):
                    stream.readline()
            else:
                stream.seek(np.dtype(props).itemsize * count, 1)
    if all(k in out for k in ("x", "y", "z")):
        out["xyz"] = np.stack([out["x"], out["y"], out["z"]], -1).astype(np.float32)
    if all(k in out for k in ("nx", "ny", "nz")):
        out["normals"] = np.stack([out["nx"], out["ny"], out["nz"]], -1).astype(np.float32)
    return out


def write_ply(
    path: Union[str, os.PathLike],
    xyz: np.ndarray,
    *,
    normals: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    """Write vertices to PLY (binary little-endian by default); the same
    bytes as the reference's writer."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    props = [("x", np.float32), ("y", np.float32), ("z", np.float32)]
    if normals is not None:
        props += [("nx", np.float32), ("ny", np.float32), ("nz", np.float32)]
    if colors is not None:
        props += [("red", np.uint8), ("green", np.uint8), ("blue", np.uint8)]
    rec = np.zeros(n, dtype=np.dtype(props))
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if normals is not None:
        normals = np.asarray(normals, np.float32)
        rec["nx"], rec["ny"], rec["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if colors is not None:
        colors = np.asarray(colors, np.uint8)
        rec["red"], rec["green"], rec["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]

    fmt = "binary_little_endian" if binary else "ascii"
    type_names = {np.dtype(np.float32): "float", np.dtype(np.uint8): "uchar"}
    header = ["ply", f"format {fmt} 1.0", f"element vertex {n}"]
    header += [f"property {type_names[np.dtype(pdt)]} {pname}" for pname, pdt in props]
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        if binary:
            f.write(rec.tobytes())
        else:
            body = _io.StringIO()
            for i in range(n):
                body.write(" ".join(
                    str(int(rec[pname][i])) if np.dtype(pdt) == np.uint8
                    else repr(float(rec[pname][i])) for pname, pdt in props) + "\n")
            f.write(body.getvalue().encode("ascii"))

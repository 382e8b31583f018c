"""Whitespace-separated xyz text (the `za.txt` fixture's format).

Mirrors `icpx/io/xyz.py`: leading non-numeric lines (column headers),
blank lines and ``#`` comments are skipped; the first three columns of
each row are the coordinates. Rows go through the native parser
(`io/native.py`); a ragged or malformed row falls back to numpy, which
raises rather than misaligning columns.
"""

from __future__ import annotations

import io
import os
from pathlib import Path
from typing import Union

import numpy as np

from icpx_torch.io import native


def _is_number(tok: bytes) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def read_xyz_txt(path: Union[str, os.PathLike]) -> np.ndarray:
    """Read xyz rows -> (N, 3) float32."""
    raw = Path(path).read_bytes()
    lines = [ln for ln in raw.splitlines() if ln.strip() and not ln.lstrip().startswith(b"#")]
    n_header = 0
    while n_header < len(lines) and not _is_number(lines[n_header].split()[0]):
        n_header += 1
    lines = lines[n_header:]
    if not lines:
        return np.zeros((0, 3), np.float32)
    row_cols = len(lines[0].split())
    if row_cols < 3:
        raise ValueError(f"xyz txt needs >= 3 columns, got {row_cols}")
    body = b"\n".join(lines)
    mat = native.parse_float_columns(body, len(lines), row_cols, 0, 3)
    if mat is not None:
        return mat
    full = np.loadtxt(io.BytesIO(body), dtype=np.float64, ndmin=2)
    return full[:, :3].astype(np.float32)


def write_xyz_txt(path: Union[str, os.PathLike], xyz: np.ndarray) -> None:
    """Tab-separated rows, 9 significant digits: every float32 reads back to
    the same bits (the reference writes 8, which can drop the last bit)."""
    np.savetxt(path, np.asarray(xyz, np.float32), fmt="%.9g", delimiter="\t")

"""Structured metrics: a JSONL sink and per-iteration ICP records.

Mirrors `icpx/utils/metrics.py`: every run can emit {iter, diff, rmse}
rows plus arbitrary scalars as machine-readable records. Tensors (on any
device) and numpy values become plain numbers or lists, and non-finite
floats become null, so the output is strict JSON.
"""

from __future__ import annotations

import json
import math
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Union

import numpy as np
import torch


class MetricsLogger:
    """Append-only JSONL metrics sink.

    Usage: ``with MetricsLogger(path) as m: m.log(event="icp", rmse=...)``.
    ``path=None`` collects in memory only (`.records`).
    """

    def __init__(self, path: Union[str, os.PathLike, None] = None):
        self.path = Path(path) if path is not None else None
        self.records: List[Dict[str, Any]] = []
        self._fh = None

    def __enter__(self) -> "MetricsLogger":
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")
        return self

    def __exit__(self, *exc) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def log(self, **fields: Any) -> Dict[str, Any]:
        rec = {"ts": time.time()}
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec


def _finite_or_none(x):
    return None if isinstance(x, float) and not math.isfinite(x) else x


def _jsonable(v: Any) -> Any:
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    if isinstance(v, (np.floating, np.integer, np.bool_)):
        v = v.item()
    elif hasattr(v, "tolist"):
        arr = np.asarray(v)
        v = arr.item() if arr.ndim == 0 else arr.tolist()
    # json.dumps would write the bare token `Infinity` / `NaN` for
    # non-finite floats, which strict JSON readers reject
    if isinstance(v, list):
        return [_finite_or_none(x) for x in v]
    return _finite_or_none(v)


def icp_iteration_records(result) -> List[Dict[str, Any]]:
    """An ICPResult's history tensors as per-iteration records, up to the
    first unused (NaN) entry."""
    diffs = result.diff_history.detach().cpu().numpy()
    rmses = result.rmse_history.detach().cpu().numpy()
    out = []
    for i, (d, r) in enumerate(zip(diffs, rmses)):
        if np.isnan(d):
            break
        out.append({"iter": i + 1, "diff": float(d), "rmse": float(r)})
    return out

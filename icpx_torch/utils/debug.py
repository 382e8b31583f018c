"""Debug and correctness-audit helpers.

Mirrors `icpx/utils/debug.py`: NaN trapping, the fp32 matmul precision
pinned inside a scope, a finiteness audit, and `shard_equivalence_report`,
which holds a sharded run against its replay on one device (the data-race
detector of SPMD code).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from icpx_torch.utils import pytree


class _NanCheck(TorchDispatchMode):
    """Raise FloatingPointError after any op whose floating output holds a
    NaN (each check syncs with the device: a debug tool, not a fast path)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for _, t in pytree.flatten(out)[0]:
            if torch.is_tensor(t) and t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def nan_checks(enabled: bool = True):
    """Trap NaNs produced by any op inside the scope (off when not
    `enabled`)."""
    if not enabled:
        yield
        return
    with _NanCheck():
        yield


@contextlib.contextmanager
def deterministic_mode():
    """Pin fp32 matmul precision to "highest" inside the scope, so results
    do not move with precision heuristics, and restore it after. As in the
    reference this changes no algorithm choice."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def assert_all_finite(tree, name: str = "tree") -> None:
    """Raise FloatingPointError if any floating leaf holds NaN or Inf."""
    leaves, _ = pytree.flatten(tree)
    for path, leaf in leaves:
        arr = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(f"{name}{path}: {bad} non-finite values")


def shard_equivalence_report(sharded_out, single_out, *, atol: float = 1e-5,
                             rtol: float = 1e-5) -> dict:
    """Compare a sharded run against its single-device replay, leaf by leaf
    in `utils.pytree`'s flatten order (the reference's). Returns {leaf path:
    max abs diff} for the leaves that differ beyond tolerance (NaN where a
    non-float leaf differs, inf where the finite entries differ); an empty
    dict means equivalent."""
    def host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    diffs = {}
    flat_a, _ = pytree.flatten(sharded_out)
    flat_b, _ = pytree.flatten(single_out)
    for (path, a), (_, b) in zip(flat_a, flat_b):
        a, b = host(a), host(b)
        if a.dtype.kind not in "fc":
            if not np.array_equal(a, b):
                diffs[path] = float("nan")
            continue
        if not np.array_equal(np.isfinite(a), np.isfinite(b)):
            diffs[path] = float("inf")
            continue
        finite = np.isfinite(a) & np.isfinite(b)
        if finite.any():
            d = np.abs(a[finite] - b[finite])
            if (d > atol + rtol * np.abs(b[finite])).any():
                diffs[path] = float(d.max())
    return diffs

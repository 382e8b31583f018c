"""Debug and correctness-audit helpers.

Mirrors `icpx/utils/debug.py`: NaN trapping, the fp32 matmul precision
pinned inside a scope, and a finiteness audit. `shard_equivalence_report`
serves the sharded paths and comes with them.
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

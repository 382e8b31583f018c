"""The level sorts of the KD builds a request runs, for the sort kernel's
roofline (`metrics/sort.roofline_pct.py`).

A median-cut build of n rows in tiles of s (`reference_online.kd_schedule`,
the documented schedule) sorts, at each level, every one of its c segments
of m = t2 * s / c rows: one launch of the sort kernel on the card, whose
bytes are `roofline.sort_bytes(c, m)`.
"""

from __future__ import annotations

from typing import List, Tuple

from reference_online import kd_schedule


def level_sorts(n: int, s: int) -> List[Tuple[int, int]]:
    """(c, m) of each level sort of a KD build of n rows in tiles of s."""
    t2, c, fans = kd_schedule(n, s)
    out = []
    for fan in fans:
        out.append((c, t2 * s // c))
        c *= fan
    return out

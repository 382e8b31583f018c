"""Collective traffic and overlap audits of the distributed layer.

The counterpart of the traffic half of `icpx/utils/hlo.py`. The reference
reads its collectives off the compiled HLO; here there is no HLO to parse,
so the facts come from `distributed.comm`'s per-process record of the
collectives this rank issued:

  * `collective_traffic(fn, *args)` runs fn and returns one row per
    collective, under XLA's opcode names (`all-reduce`,
    `collective-permute`, `all-to-all`, `all-gather`) with its bytes a
    rank, the input of a scaling model;
  * `assert_overlappable(record)` checks that every ring shift was posted
    before a fold and waited on after it, so the transfer has that fold
    to hide behind: the property the reference proves on its loop body's
    def-use graph (`tests/test_hlo_overlap.py`), here on the issue order.
"""

from __future__ import annotations

import dataclasses
from typing import List

from icpx_torch.distributed import comm


@dataclasses.dataclass
class CollectiveTraffic:
    computation: str  # the function that issued the collective
    opcode: str
    bytes: int  # bytes this rank sends


def collective_traffic(fn, *args, **kwargs) -> List[CollectiveTraffic]:
    """Run fn(*args, **kwargs) and list every collective it issued on this
    rank, in order (a permute counts once, at its post). Run it with
    max_iters=1 to read one iteration's traffic."""
    with comm.recording() as rec:
        fn(*args, **kwargs)
    return [CollectiveTraffic(e.where, e.kind, e.bytes) for e in rec
            if e.kind != "fold" and e.phase != "wait"]


@dataclasses.dataclass
class OverlapReport:
    computation: str
    ident: int  # the shift's id in the record
    folds_between: int  # folds issued after its post and before its wait

    @property
    def overlappable(self) -> bool:
        return self.folds_between > 0


def overlap_reports(record: List[comm.Event]) -> List[OverlapReport]:
    """One report per posted permute in the record."""
    posted = {}
    out = []
    for pos, e in enumerate(record):
        if e.kind != "collective-permute":
            continue
        if e.phase == "post":
            posted[e.ident] = (pos, e.where)
        elif e.phase == "wait" and e.ident in posted:
            start, where = posted.pop(e.ident)
            folds = sum(1 for f in record[start + 1:pos] if f.kind == "fold")
            out.append(OverlapReport(where, e.ident, folds))
    out += [OverlapReport(where, ident, 0) for ident, (_, where) in posted.items()]
    return out


def assert_overlappable(record: List[comm.Event]) -> List[OverlapReport]:
    """Assert every ring shift in the record was posted before the fold it
    hides behind and waited on after it; returns the reports."""
    reports = overlap_reports(record)
    if not reports:
        raise AssertionError("no collective-permute found in the record")
    bad = [r for r in reports if not r.overlappable]
    if bad:
        raise AssertionError("shift(s) with no fold between post and wait:\n" + "\n".join(
            f"{r.computation} #{r.ident}" for r in bad))
    return reports

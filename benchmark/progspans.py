"""The program's own spans in the traced stretch, for the per-layer metrics
that read them.

`icpx_torch.utils.profiling.span` and `fetch` put `icpx.*` ranges in
torch.profiler's trace while it records (category "user_annotation", which
`devtrace.Trace` keeps in `host`), on the same clock as the card's
intervals. A span's children are the spans that start and end inside it.
A program without these spans leaves every reader here with nothing to
read: each returns None.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

ITER = "icpx.iter"
FETCH = "icpx.fetch"


def spans(trace, name: str) -> List[Tuple[float, float]]:
    """(start, end) in microseconds of the host spans called `name` that
    lie inside the traced stretch, in order of start."""
    return sorted((a, b) for a, b, n in trace.host
                  if n == name and a >= trace.start and b <= trace.end)


def issue_ms_per_iter(ctx) -> Optional[float]:
    """Mean over the `icpx.iter` spans of their length less that of their
    `icpx.fetch` children: the host's milliseconds to issue an iteration."""
    if ctx.trace is None:
        return None
    iters = spans(ctx.trace, ITER)
    if not iters:
        return None
    fetches = spans(ctx.trace, FETCH)
    starts = [a for a, _ in fetches]
    total = 0.0
    for a, b in iters:
        inner = 0.0
        for fa, fb in fetches[bisect.bisect_left(starts, a):bisect.bisect_left(starts, b)]:
            if fb <= b:
                inner += fb - fa
        total += (b - a) - inner
    return total / len(iters) * 1e-3


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _overlap(xs: List[Tuple[float, float]], ys: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_pct_in_loop(ctx) -> Optional[float]:
    """100 x the card's idle time inside `icpx.iter` spans over the traced
    stretch's length; None without device events, as the `idle_pct.*`
    readers."""
    t = ctx.trace
    if t is None or t.window_s <= 0.0 or t.busy_s <= 0.0:
        return None
    loop = _union(spans(t, ITER))
    if not loop:
        return None
    inside = sum(b - a for a, b in loop)
    return 100.0 * (inside - _overlap(loop, t.busy_intervals())) * 1e-6 / t.window_s


def fetches(ctx, per: str) -> Optional[float]:
    """`icpx.fetch` spans in the trace over the traced requests' frames
    (`per="work"`: the records' `work`) or over the requests themselves
    (`per="request"`: one pair each)."""
    if ctx.trace is None or not spans(ctx.trace, ITER):
        return None
    traced = [r for r in ctx.records if r["index"] in ctx.traced]
    units = sum(r["work"] for r in traced) if per == "work" else len(traced)
    return len(spans(ctx.trace, FETCH)) / units if units else None

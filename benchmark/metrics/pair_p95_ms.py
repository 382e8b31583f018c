"""The 95th percentile (nearest rank) of every pair's latency in the
window, from the call to the synchronise after it (host clock); a pair
that fails the gate counts as missing any limit."""

import math


def read(ctx):
    lat = sorted((r["t1"] - r["t0"]) * 1e3 if r["passed"] else math.inf for r in ctx.records)
    return lat[max(math.ceil(0.95 * len(lat)), 1) - 1]

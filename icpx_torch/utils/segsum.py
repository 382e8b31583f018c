"""Segment sums in a fixed order, the same bits on every run and device.

The reference sums duplicate destinations with XLA's `.at[].add`, which
gives the same bits on every run. Torch's accumulating scatters
(`index_add_`, an accumulating `index_put_`, `scatter_add_`) add with
floating-point atomics on CUDA, in whatever order the threads arrive, so
two runs differ by roundoff. Here the order is fixed by construction:

  * `segment_plan(index, n)` sorts the contributions by destination
    (stable, so ascending contribution order within a destination) into a
    padded (n, max_deg) gather table; its one host fetch is `max_deg`,
    once a plan, so a caller builds the plan once a call and reuses it in
    every iteration;
  * `segment_sum(values, plan)` gathers each destination's row of
    contributions and adds them with plain elementwise adds, which round
    the same on the CPU and the card: from zero, in ascending contribution
    order, runs of at most `RUN` at a time; a destination with more than
    `RUN` contributions sums each run in order and then the runs' sums in
    the same way.

Pad slots gather a zero row, and adding +0.0 leaves a sum from zero
unchanged, so the padding changes no bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

RUN = 64  # contributions a destination summed strictly in order


@dataclass(frozen=True)
class SegmentPlan:
    table: torch.Tensor  # (n, max_deg) int64 contribution ids, n_items where padded
    n_items: int  # contributions the plan was built for

    @property
    def n_segments(self) -> int:
        return self.table.shape[0]


def segment_plan(index: torch.Tensor, n: int) -> SegmentPlan:
    """The plan that sums contribution e into destination index[e] (< n)."""
    idx = index.reshape(-1).long()
    e = idx.shape[0]
    dev = idx.device
    order = torch.argsort(idx, stable=True)
    deg = torch.bincount(idx, minlength=n)
    max_deg = int(deg.max()) if e else 0
    start = torch.cumsum(deg, 0) - deg
    dest = idx[order]
    rank = torch.arange(e, device=dev) - start[dest]
    table = torch.full((n, max_deg), e, dtype=torch.int64, device=dev)
    table[dest, rank] = order  # every (destination, rank) once: no accumulation
    return SegmentPlan(table=table, n_items=e)


def segment_sum(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """(n, *values.shape[1:]): row d is the sum of values[e] over the
    contributions e the plan sends to d, in the plan's fixed order."""
    if values.shape[0] != plan.n_items:
        raise ValueError(f"{values.shape[0]} values for a plan of {plan.n_items}")
    padded = torch.cat([values, values.new_zeros((1,) + tuple(values.shape[1:]))])
    return _ordered_sum(padded[plan.table])


def _ordered_sum(g: torch.Tensor) -> torch.Tensor:
    """Sum (n, d, ...) over d: in order from zero where d <= RUN, else each
    run of RUN in order, then the runs' sums the same way."""
    n, d = g.shape[0], g.shape[1]
    rest = tuple(g.shape[2:])
    if d > RUN:
        pad = (-d) % RUN
        if pad:
            g = torch.cat([g, g.new_zeros((n, pad) + rest)], 1)
        runs = g.shape[1] // RUN
        part = _ordered_sum(g.reshape((n * runs, RUN) + rest))
        return _ordered_sum(part.reshape((n, runs) + rest))
    acc = g.new_zeros((n,) + rest)
    for k in range(d):
        acc = acc + g[:, k]
    return acc

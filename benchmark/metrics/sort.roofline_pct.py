"""The sort kernel's share of its roofline over the traced requests: the
least time of every level sort of every KD build the requests ran (the
entry's `kernel_work`, `kdwork.level_sorts`; `roofline.sort_bytes` over
the card's memory rate) over the device time of the sort kernel's
launches in the trace."""

import roofline

KERNELS = ("sort_block_kernel", "merge_global_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.kernel_s(KERNELS)
    work = [w for r in ctx.records if r["index"] in ctx.traced
            for w in ctx.entry.kernel_work(r).get("sort", [])]
    if device_s <= 0.0 or not work:
        return None
    bound = sum(roofline.bound_s(roofline.sort_bytes(c, m), 0.0) for c, m in work)
    return 100.0 * bound / device_s

"""The nearest-neighbour kernels' share of their roofline over the traced
requests: the least time the searches could take (`roofline.nn_work` for
each pair's query and reference rows and valid references, once an ICP
iteration) over the device time of the kernels in the trace."""

import roofline

KERNELS = ("nn_pack_kernel", "nn_search_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.kernel_s(KERNELS)
    work = [w for r in ctx.records if r["index"] in ctx.traced
            for w in ctx.entry.kernel_work(r).get("nn", [])]
    if device_s <= 0.0 or not work:
        return None
    bound = sum(it * roofline.bound_s(*roofline.nn_work(nq, nr, nv)) for nq, nr, nv, it in work)
    return 100.0 * bound / device_s

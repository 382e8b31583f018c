"""The device's idle share of the traced stretch: 100 x (1 - the union of
the card's kernel, copy and memset intervals / the stretch's length), from
torch.profiler."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0.0 or ctx.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)

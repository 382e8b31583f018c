"""Points of the pairs finished in the window that pass the ground-truth
gate, over the window's seconds (host clock)."""


def read(ctx):
    return sum(r["work"] for r in ctx.records if r["passed"]) / ctx.window_s

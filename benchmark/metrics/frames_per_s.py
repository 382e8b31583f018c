"""Frames registered by the requests finished in the window whose chain
passes the ATE gate, over the window's seconds (host clock)."""


def read(ctx):
    return sum(r["work"] for r in ctx.records if r["passed"]) / ctx.window_s

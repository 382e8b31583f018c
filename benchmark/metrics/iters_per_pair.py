"""ICP iterations a pair (coarse + refine), as the results report them,
over every pair of the window."""


def read(ctx):
    its = [r["iters"] for r in ctx.records]
    return sum(its) / len(its) if its else None

"""ICP iterations a registered frame, as the results report them, over
every frame of the window."""


def read(ctx):
    its = [i for r in ctx.records for i in ctx.entry.frame_iters(r)]
    return sum(its) / len(its) if its else None

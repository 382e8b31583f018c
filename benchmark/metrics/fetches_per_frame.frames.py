"""Device-to-host reads a registered frame: the program's `icpx.fetch`
spans in the trace over the frames of the traced requests."""

import progspans


def read(ctx):
    return progspans.fetches(ctx, per="work")

"""Device-to-host reads a pair: the program's `icpx.fetch` spans in the
trace over the traced requests (one pair each)."""

import progspans


def read(ctx):
    return progspans.fetches(ctx, per="request")

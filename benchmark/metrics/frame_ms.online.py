"""Host milliseconds a registered frame: the mean length of the program's
`icpx.frame` spans (one an `OdometryStream.push` that registers a frame:
every scan's but the sequence's first) in the traced requests, on
torch.profiler's clock."""

import progspans

FRAME = "icpx.frame"


def read(ctx):
    if ctx.trace is None:
        return None
    frames = progspans.spans(ctx.trace, FRAME)
    return sum(b - a for a, b in frames) / len(frames) * 1e-3 if frames else None

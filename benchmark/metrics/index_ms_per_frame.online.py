"""Host milliseconds of KD index work a registered frame: the program's
`icpx.index` spans (each frame's source index, each keyframe's index) plus
the parts of its `icpx.keyframe` spans (a keyframe rebuild: centroid,
index, payload table) outside them, summed over the traced requests, over
their registered frames (torch.profiler's clock)."""

import progspans


def _inside(outer, inner):
    return sum(b - a for a, b in inner if any(oa <= a and b <= ob for oa, ob in outer))


def read(ctx):
    if ctx.trace is None:
        return None
    index = progspans.spans(ctx.trace, "icpx.index")
    keyframe = progspans.spans(ctx.trace, "icpx.keyframe")
    if not index and not keyframe:
        return None
    frames = sum(r["work"] for r in ctx.records if r["index"] in ctx.traced)
    total = sum(b - a for a, b in index) + sum(b - a for a, b in keyframe) \
        - _inside(keyframe, index)
    return total / frames * 1e-3 if frames else None

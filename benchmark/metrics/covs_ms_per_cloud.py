"""Milliseconds of one cloud's GICP covariances: CUDA events around the
program's `estimate_covariances` where `registration/icp.py` looks it up,
every call of the traced window."""

WRAP = ("icpx_torch.registration.icp:estimate_covariances",)


def read(ctx):
    ms = ctx.recorder.span_ms(WRAP[0])
    return sum(ms) / len(ms) if ms else None

"""Milliseconds of one scan's normals (k = 10): CUDA events around the
benchmark's own calls of the program's `estimate_normals`, every call of
the traced window."""

WRAP = ("icpx_torch.kernels.normals:estimate_normals",)


def read(ctx):
    ms = ctx.recorder.span_ms(WRAP[0])
    return sum(ms) / len(ms) if ms else None

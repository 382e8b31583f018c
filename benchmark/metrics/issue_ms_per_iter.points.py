"""Host milliseconds to issue one ICP iteration in the traced requests: the
mean over the program's `icpx.iter` spans of their length less their
`icpx.fetch` children (torch.profiler's clock)."""

import progspans


def read(ctx):
    return progspans.issue_ms_per_iter(ctx)

"""The card's idle share of the traced stretch that falls inside the ICP
loop: 100 x (the time inside the program's `icpx.iter` spans when no
kernel, copy or memset runs / the stretch's length), from torch.profiler."""

import progspans


def read(ctx):
    return progspans.idle_pct_in_loop(ctx)

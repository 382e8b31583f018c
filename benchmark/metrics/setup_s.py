"""Seconds from the process's start to the end of the warm requests:
imports, card initialisation, kernel builds (first run of a checkout),
the inputs made from the seed, and the warm-up."""


def read(ctx):
    return ctx.setup_s

"""Seconds from the process's start to the window: importing, reaching
the card, building or loading the kernels, making the weights and the
data (writing the streamed corpus), the first steps and the warm steps
(host clock)."""

UNIT, MOVES = "s", None


def read(ctx):
    return ctx.setup_s

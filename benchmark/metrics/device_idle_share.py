"""Share of the traced window in which nothing ran on the card: one minus
the union of its kernels, copies and fills over the window (the
profiler's device trace)."""

UNIT, MOVES = "%", "train_fps"


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    busy, _ = ctx.trace.busy()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / ctx.trace.window_s)

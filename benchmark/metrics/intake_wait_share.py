"""Share of the window's wall the host spent waiting on the epoch's stack
generator: each ``next()`` reads, transforms and shuffles until a cache
is full (host clock around the calls, the untraced window). Nothing to
read where the cell has no intake in its window."""

UNIT, MOVES = "%", "train_fps"


def read(ctx):
    w = ctx.window
    if "intake_s" not in w:
        return None
    return 100.0 * w["intake_s"] / w["wall_s"]

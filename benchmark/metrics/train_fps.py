"""Frames whose training step finished in the window, over the window's
wall, which ends when the card has finished (host clock)."""

UNIT, MOVES = "frames/s", None


def read(ctx):
    return ctx.window["frames"] / ctx.window["wall_s"]

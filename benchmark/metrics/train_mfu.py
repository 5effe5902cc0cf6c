"""The whole step's share of the card's peak: the model operations of the
window's frames (``work.step_flops_per_frame``) over the window's wall and
the peak of the configuration's compute type (host clock, the untraced
window of a ``--trace 1`` run)."""

UNIT, MOVES = "%", "train_fps"


def read(ctx):
    w = ctx.window
    flops = w["frames"] * ctx.work.step_flops_per_frame(ctx.cfg)
    return 100.0 * flops / (w["wall_s"] * ctx.work.peak(ctx.cfg))

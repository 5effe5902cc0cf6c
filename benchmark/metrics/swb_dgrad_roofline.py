"""``dgrad_roofline`` in the cell of Seide et al.'s CD-DNN: the input
gradients of every layer after the first (seven ``backward.dgrad`` spans a
step) against their bound, read by ``dgrad_roofline``'s own reader."""

from benchmark import harness

UNIT, MOVES = "%", "train_fps"


def read(ctx):
    return harness.metric_module("dgrad_roofline").read(ctx)

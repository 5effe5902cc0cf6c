"""``device_idle_share`` in the cell of Seide et al.'s CD-DNN: the share
of the traced window in which nothing ran on the card, read by
``device_idle_share``'s own reader."""

from benchmark import harness

UNIT, MOVES = "%", "train_fps"


def read(ctx):
    return harness.metric_module("device_idle_share").read(ctx)

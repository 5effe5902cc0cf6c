"""``train_mfu`` in the cell of Seide et al.'s CD-DNN: the whole step's
share of the card's peak, read by ``train_mfu``'s own reader."""

from benchmark import harness

UNIT, MOVES = "%", "train_fps"


def read(ctx):
    return harness.metric_module("train_mfu").read(ctx)

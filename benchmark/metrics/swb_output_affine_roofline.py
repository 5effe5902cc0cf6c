"""``output_affine_roofline`` in the cell of Seide et al.'s CD-DNN: the
output layer's forward, 2048→9304 (the ``forward.output`` span, one a
step), against its bound, read by ``output_affine_roofline``'s own
reader."""

from benchmark import harness

UNIT, MOVES = "%", "train_fps"


def read(ctx):
    return harness.metric_module("output_affine_roofline").read(ctx)

"""``affine_sigmoid_roofline`` in the cell of Seide et al.'s CD-DNN: the
hidden layers' forwards (seven ``affine_sigmoid`` a step, every kernel
named ``matmul_act``) against their bound, read by
``affine_sigmoid_roofline``'s own reader."""

from benchmark import harness

UNIT, MOVES = "%", "train_fps"


def read(ctx):
    return harness.metric_module("affine_sigmoid_roofline").read(ctx)

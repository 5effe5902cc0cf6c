"""``wgrad_momentum_update_roofline`` in the cell of Seide et al.'s
CD-DNN: the fused weight gradients with their momentum updates (eight a
step, every kernel named ``wgrad_momentum``) against their bound, read by
``wgrad_momentum_update_roofline``'s own reader."""

from benchmark import harness

UNIT, MOVES = "%", "train_fps"


def read(ctx):
    return harness.metric_module("wgrad_momentum_update_roofline").read(ctx)

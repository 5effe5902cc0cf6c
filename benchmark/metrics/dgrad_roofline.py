"""The input gradients ``dx = dz·Wᵀ`` of every layer after the first
(the program's ``backward.dgrad`` spans, whatever kernel forms them)
against their bound: the traced steps times one step's least time, each
layer's operations at the peak or its bytes (dz and W read, dx written)
at the HBM rate, over the spans' device time."""

from benchmark import spans

UNIT, MOVES = "%", "train_fps"
SPAN = "backward.dgrad"


def bound_s(cfg: dict, work) -> float:
    B = cfg["bunch"]
    return sum(work.bound_s(2.0 * B * i * o, work.F32 * (B * o + i * o + B * i), cfg)
               for i, o in work.layers(cfg)[1:])


def read(ctx):
    return spans.roofline(ctx, SPAN, len(ctx.work.layers(ctx.cfg)) - 1, bound_s)

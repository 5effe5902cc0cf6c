"""The plain SGD update of every parameter (the program's ``step.update``
span) against its bound: the traced steps times one step's least time,
each parameter's gradient and value read and its value written once at
the HBM rate (its two operations at the peak never bound it), over the
span's device time. With momentum the span updates the biases alone."""

from benchmark import spans

UNIT, MOVES = "%", "train_fps"
SPAN = "step.update"


def bound_s(cfg: dict, work) -> float:
    n = sum(i * o + o for i, o in work.layers(cfg))
    return work.bound_s(2.0 * n, 3 * work.F32 * n, cfg)


def read(ctx):
    return spans.roofline(ctx, SPAN, 1, bound_s)

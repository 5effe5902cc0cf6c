"""The output layer's forward ``x·W + b`` (the program's
``forward.output`` span, whatever kernels form it) against its bound: the
traced steps times one step's least time, its operations at the peak or
its bytes (x, W and b read, the logits written) at the HBM rate, over the
span's device time."""

from benchmark import spans

UNIT, MOVES = "%", "train_fps"
SPAN = "forward.output"


def bound_s(cfg: dict, work) -> float:
    B = cfg["bunch"]
    i, o = work.layers(cfg)[-1]
    return work.bound_s(2.0 * B * i * o, work.F32 * (B * i + i * o + o + B * o), cfg)


def read(ctx):
    return spans.roofline(ctx, SPAN, 1, bound_s)

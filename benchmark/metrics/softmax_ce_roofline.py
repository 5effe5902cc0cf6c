"""The fused softmax cross-entropy (the program's ``loss.softmax_ce``
span, one a step) against its bound: the traced steps times one step's
least time, the logits read, the stored gradient written and the int32
labels read once at the HBM rate (its operations at any peak never bound
it), over the span's device time."""

from benchmark import spans

UNIT, MOVES = "%", "train_fps"
SPAN = "loss.softmax_ce"
LABEL_BYTES = 4


def bound_s(cfg: dict, work) -> float:
    B, C = cfg["bunch"], cfg["dims"][-1]
    return (2 * work.F32 * B * C + LABEL_BYTES * B) / work.HBM_BYTES_S


def read(ctx):
    return spans.roofline(ctx, SPAN, 1, bound_s)

"""The weight gradients ``dW = xᵀ·dz`` of every layer (the program's
``backward.wgrad`` spans: without momentum the library's GEMMs) against
their bound: the traced steps times one step's least time, each layer's
operations at the peak or its bytes (x and dz read, dW written) at the
HBM rate, over the spans' device time. With momentum the same spans wrap
the fused update, whose bound is ``wgrad_momentum_update_roofline``'s."""

from benchmark import spans

UNIT, MOVES = "%", "train_fps"
SPAN = "backward.wgrad"


def bound_s(cfg: dict, work) -> float:
    B = cfg["bunch"]
    return sum(work.bound_s(2.0 * B * i * o, work.F32 * (B * i + B * o + i * o), cfg)
               for i, o in work.layers(cfg))


def read(ctx):
    return spans.roofline(ctx, SPAN, len(ctx.work.layers(ctx.cfg)), bound_s)

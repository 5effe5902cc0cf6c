"""The hidden layers' forwards (``affine_sigmoid``: every kernel named
``matmul_act``, pre-passes included) against their bound: the traced
steps times one step's least time (``work.affine_sigmoid_bound_s``), over
those kernels' device time in the trace."""

UNIT, MOVES = "%", "train_fps"
KERNELS = "matmul_act"


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.kernel_s(KERNELS)
    if t <= 0:
        return None
    return 100.0 * ctx.traced["bunches"] * ctx.work.affine_sigmoid_bound_s(ctx.cfg) / t

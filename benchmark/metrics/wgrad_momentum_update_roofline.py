"""The fused weight gradients with their momentum updates
(``wgrad_momentum_update``: every kernel named ``wgrad_momentum``,
pre-passes included) against their bound: the traced steps times one
step's least time (``work.wgrad_momentum_bound_s``), over those kernels'
device time in the trace. Nothing to read where no such kernel ran (a
step without momentum)."""

UNIT, MOVES = "%", "train_fps"
KERNELS = "wgrad_momentum"


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.kernel_s(KERNELS)
    if t <= 0:
        return None
    return 100.0 * ctx.traced["bunches"] * ctx.work.wgrad_momentum_bound_s(ctx.cfg) / t

"""Share of the traced window's GEMM operations that the library formed
(cuBLAS's f32 GEMMs run FFMA, near a third of the 3xTF32 bound): the
program's counter ``gemm.flops.library`` over the sum of its
``gemm.flops.<route>`` counters, each product's 2·M·N·K added where its
route is chosen. It counts products, not time, so it repeats exactly.
Nothing to read where the program keeps no such counters."""

UNIT, MOVES = "%", "train_fps"
PREFIX, LIBRARY = "gemm.flops.", "gemm.flops.library"


def counters():
    """The profiler's counters, or None where the program keeps none."""
    from nnet_asr_torch.utils.profiler import profiler

    read = getattr(profiler, "counters", None)
    return read() if callable(read) else None


def read(ctx):
    if ctx.trace is None:
        return None
    flops = {k: c["sum"] for k, c in (counters() or {}).items() if k.startswith(PREFIX)}
    total = sum(flops.values())
    if total <= 0:
        return None
    return 100.0 * flops.get(LIBRARY, 0.0) / total

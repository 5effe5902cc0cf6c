"""The program's own spans, as the port's profiler folds them
(``nnet_asr_torch.utils.profiler``): per span name, its calls and its
seconds on the card's clock. The spans record while a ``torch.profiler``
session records, so after the traced window the totals hold that window's
spans. A reader finds nothing where the program keeps no totals (a
checkout before the spans), where the span timed no device, or where its
calls are not the traced bunches times its calls a step."""

from __future__ import annotations

from typing import Callable, Dict, Optional

from nnet_asr_torch.utils.profiler import profiler


def totals() -> Optional[Dict[str, dict]]:
    """The profiler's per-name totals (waiting for the card), or None
    where the program keeps none."""
    read = getattr(profiler, "totals", None)
    return read() if callable(read) else None


def roofline(ctx, name: str, per_step: int, bound_s: Callable) -> Optional[float]:
    """The share (%) of span ``name``'s device time over the traced window
    that its least time takes: ``bound_s(cfg, work)``, one step's, times
    the window's ``ctx.traced["bunches"]`` steps, each of which opened the
    span ``per_step`` times."""
    if ctx.trace is None or not ctx.traced:
        return None
    row = (totals() or {}).get(name)
    if not row or not row.get("device_s") or row["device_s"] <= 0:
        return None
    bunches = ctx.traced["bunches"]
    if row["calls"] != bunches * per_step:
        return None
    return 100.0 * bunches * bound_s(ctx.cfg, ctx.work) / row["device_s"]

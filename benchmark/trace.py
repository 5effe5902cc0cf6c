"""The traced window: ``torch.profiler`` over a stretch of the cell's own
work, reduced to device intervals, the host's phases and the idle gaps.

The benchmark marks its own host phases with ``record_function`` ranges
named ``bench.<phase>``; the profiler puts them and the card's kernels,
copies and fills on one clock, so each idle gap of the card is named by
the phase the host was in when the card ran dry. ``KERNEL_GROUPS`` is the
table of kernel-name patterns the breakdown sums by.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

# (group, pattern searched in the kernel's name), first match wins: the
# port's hand-written kernels by wrapper and route (the f32 routes carry
# "_f32_" in their names), then the library's GEMMs
KERNEL_GROUPS = (("affine_sigmoid f32 CP_WGMMA", "matmul_act_f32_cp_"),
                 ("affine_sigmoid f32 WGMMA", "matmul_act_f32_"),
                 ("affine_sigmoid bf16", r"matmul_act_kernel.*Tile<[^>]*>, __nv_bfloat16"
                  r"|matmul_act_wgmma_kernel|matmul_act_cp_wgmma_kernel"),
                 ("affine_sigmoid", "matmul_act_kernel"),
                 ("wgrad_momentum_update f32 CP_WGMMA", "wgrad_momentum_f32_cp_"),
                 ("wgrad_momentum_update f32 WS_WGMMA", "wgrad_momentum_f32_ws_"),
                 ("wgrad_momentum_update f32 WGMMA", "wgrad_momentum_f32_"),
                 ("wgrad_momentum_update bf16", "wgrad_momentum_bf16_|wgrad_momentum_wgmma_"),
                 ("wgrad_momentum_update", "wgrad_"),
                 ("softmax_xent", "softmax_xent_"),
                 ("cuBLAS GEMM", "gemm|xmma|cutlass|nvjet"),
                 ("copies and fills", "Memcpy|Memset"),
                 ("reductions", "reduce"))

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


@dataclass
class Trace:
    """One traced window, on the profiler's clock (ns)."""
    start: int
    end: int
    device: List[Tuple[int, int, str]] = field(default_factory=list)   # (start, end, name)
    host: List[Tuple[int, int, str]] = field(default_factory=list)     # bench.* phases

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def busy(self) -> Tuple[float, List[Tuple[int, int]]]:
        """(seconds in which an operation ran on the card, idle gaps): the
        union of the device intervals inside the window, and the stretches
        between them."""
        merged: List[List[int]] = []
        for s, e in sorted((max(s, self.start), min(e, self.end)) for s, e, _ in self.device
                           if e > self.start and s < self.end):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        edges = [self.start] + [t for s, e in merged for t in (s, e)] + [self.end]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        return sum(e - s for s, e in merged) * 1e-9, gaps

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for s, e, name in self.device if rx.search(name)) * 1e-9

    def host_phase(self, t: int) -> str:
        """The innermost benchmark phase the host was in at ``t``."""
        best = None
        for s, e, name in self.host:
            if s <= t < e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return "outside any phase" if best is None else best[2].split(".", 1)[1]


def group_of(name: str) -> str:
    for group, pat in KERNEL_GROUPS:
        if re.search(pat, name):
            return group
    return name[:80]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (by group), and the
    longest idle gaps by what the host was doing, in seconds."""
    ops = {}
    for s, e, name in trace.device:
        g = group_of(name)
        ops[g] = ops.get(g, 0.0) + (e - s) * 1e-9
    _, gaps = trace.busy()
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": sorted(([g, s] for g, s in ops.items()), key=lambda r: -r[1])[:top],
            "idle_gaps": [[trace.host_phase(s), (e - s) * 1e-9] for s, e in longest]}


def _ns(ev, what: str) -> int:
    """An event's start or end in ns (older profilers give us)."""
    if hasattr(ev, f"{what}_ns"):
        return int(getattr(ev, f"{what}_ns")())
    start = ev.start_us()
    return int(1000 * (start if what == "start" else start + ev.duration_us()))


def _activity(ev) -> str:
    """The event's kind: a host range of the benchmark, a device
    operation, or other (host calls and the device's copies of the host
    ranges), for builds of the profiler with or without
    ``activity_type``."""
    name = ev.name()
    on_device = "CUDA" in str(ev.device_type())
    if name.startswith("bench."):
        return "device_range" if on_device else "user_annotation"
    if hasattr(ev, "activity_type"):
        return str(ev.activity_type())
    return "kernel" if on_device else "host"


def record(run: Callable[[Callable[[str], object]], None], torch) -> Optional[Trace]:
    """Profile ``run(phase)``, where ``phase(name)`` is a context manager
    that marks a host phase; None when the profiler saw no window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def phase(name: str):
        return record_function(f"bench.{name}")

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            run(phase)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        time.sleep(0.001)
    trace = None
    host, device = [], []
    for ev in prof.profiler.kineto_results.events():
        act = _activity(ev)
        if ev.name() == WINDOW and act == "user_annotation":
            trace = Trace(_ns(ev, "start"), _ns(ev, "end"))
        elif act == "user_annotation" and ev.name().startswith("bench."):
            host.append((_ns(ev, "start"), _ns(ev, "end"), ev.name()))
        elif act in DEVICE_ACTIVITIES:
            device.append((_ns(ev, "start"), _ns(ev, "end"), ev.name()))
    if trace is not None:
        trace.host, trace.device = host, device
    return trace

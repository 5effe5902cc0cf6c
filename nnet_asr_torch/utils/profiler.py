"""Wall-time profiling mirroring the reference's observability surface.

The reference wraps every device op in a Timer and accumulates per-op wall
time into CuDevice::AccuProfile, dumped as ``[cudevice profile]`` at exit
when trace&4 (cudevice.h:45-62, cumatrix.tcc). The granularity here is
*phases* (frontend/feature IO, transform, train-step, randomize, ...);
kernel-level detail comes from ``torch.profiler``. The port's copy of
``nnet_asr_tpu/utils/profiler.py``, behaviour unchanged.

``Profiler`` is a process-wide accumulator; ``phase("name")`` is a context
manager; ``report()`` prints the profile table. FPS/RT throughput lines
(TNet.cc:359-362) live on the trainers.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator


class Profiler:
    def __init__(self):
        self._acc: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._acc.clear()
            self._counts.clear()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._acc[name] += dt
                self._counts[name] += 1

    def accu(self, name: str, seconds: float) -> None:
        with self._lock:
            self._acc[name] += seconds
            self._counts[name] += 1

    def value(self, name: str) -> float:
        return self._acc.get(name, 0.0)

    def report(self) -> str:
        if not self._acc:
            return ""
        total = sum(self._acc.values())
        lines = ["[profile]"]
        for name in sorted(self._acc, key=self._acc.get, reverse=True):
            t = self._acc[name]
            lines.append(f"  {name:<28} {t:9.3f}s  {100 * t / total:5.1f}%"
                         f"  x{self._counts[name]}")
        lines.append(f"  {'TOTAL':<28} {total:9.3f}s")
        return "\n".join(lines) + "\n"


# process-wide instance (the CuDevice-singleton analog)
profiler = Profiler()


def enable_from_trace(trace: int) -> None:
    """trace&4 turns profiling on, matching the reference's -T bitmask."""
    if trace & 4:
        profiler.enabled = True

"""Spans and counters of the port's phases, on the host's clock and the card's.

The reference wraps every device op in a Timer and accumulates per-op wall
time into CuDevice::AccuProfile, dumped as ``[cudevice profile]`` at exit
when trace&4 (cudevice.h:45-62, cumatrix.tcc). The granularity here is
*spans* at the step, kernel-purpose and intake boundaries (the table in
PERF.md §3); kernel-level detail comes from ``torch.profiler``.

``Profiler`` is a process-wide recorder; ``phase(name, device)`` is a
context manager that opens a span; ``count(name, n)`` adds to a counter;
``report()`` prints the profile table. FPS/RT throughput lines
(TNet.cc:359-362) live on the trainers.

Spans record while ``enabled`` is set (``-T 4``) or while a
``torch.profiler`` session records (``recording()``); in the second case
each span is also a range in the session's trace, so the spans and the
card's kernels share the profiler's clock. The range is a function-scope
record function (a ``cpu_op`` event on the host's timeline), which the
profiler does not mirror onto the device's timeline as it mirrors
``record_function``'s user annotations: the device's events stay the
card's own work. Otherwise ``phase`` returns a shared null context and
``count`` returns at once; callers on the step's hot path check
``recording()`` once and skip their spans' with-blocks.

A span keeps its name, its start and end on the host clock and its parent
(the innermost span open on its thread when it opened). A span given a
CUDA ``device`` records a CUDA event on the device's current stream when
it opens and another when it closes: under ``-T 4`` always, under a
``torch.profiler`` session alone only where it is opened with
``timed_in_trace`` (the spans whose card time is read from a profiled
window), since each pair costs the host two more API calls, which the
session makes dearer, and the card a bubble between them. Closed spans
are folded into per-name totals, in the order they closed, once ``FOLD_AT``
more are waiting than after the last fold, up to the first whose closing
event the card has not reached (``Event.query``): recording never waits
for the card, and memory stays bounded by the spans the host runs ahead.
Only ``totals()`` and ``report()`` wait for the card. Self time is a
span's time less what its child spans cover.

A step replayed from a CUDA graph runs none of its host code, so the
graph holds its spans: while ``capturing(spans)`` is open, what the
capturing stream's threads record goes into ``spans`` (a ``GraphSpans``;
nothing where it is None) and not into the totals, whatever else records,
each span timed in a trace timed in the graph by two event nodes of its
own. ``replay(spans, launch)`` launches the graph and
adds its spans (each with no host time) and its counters once more; a
graph's events hold its last replay's times alone, so the next replay of
the same graph folds the last one first, waiting for the card to finish
it.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

import torch
from torch._C._autograd import _profiler_enabled

FOLD_AT = 64          # closed spans that wait for a fold
_Range = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()


class GraphSpans:
    """The spans (in the order they closed) and the counters' adds that a
    step recorded while a CUDA graph captured it; ``live`` while a replay's
    spans wait for their fold."""

    def __init__(self):
        self.spans: List["_Open"] = []
        self.counts: List[Tuple[str, float]] = []
        self.live = False


class _Open:
    """A span from its opening to its fold."""
    __slots__ = ("prof", "name", "device", "parent", "rf", "ev0", "ev1",
                 "t0", "t1", "child_host", "child_dev", "graph")

    def __init__(self, prof: "Profiler", name: str, device, timed: bool,
                 graph: Optional[GraphSpans] = None):
        self.prof, self.name, self.graph = prof, name, graph
        # the CUDA device's index, or None where the span times no device
        self.device = None
        if timed and device is not None and device.type == "cuda":
            self.device = (device.index if device.index is not None
                           else torch.cuda.current_device())
        self.rf = self.ev0 = self.ev1 = None
        self.child_host = self.child_dev = 0.0

    def __enter__(self):
        prof = self.prof
        stack = prof._stack()
        self.parent = stack[-1] if stack else None
        if _profiler_enabled():
            self.rf = _Range(self.name)
            self.rf.__enter__()
        if self.device is not None:
            self.ev0 = prof._event(self.device, self.graph is not None)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        prof = self.prof
        if self.device is not None:
            self.ev1 = prof._event(self.device, self.graph is not None)
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        prof._stack().pop()
        if self.parent is not None:
            self.parent.child_host += self.t1 - self.t0
        with prof._lock:
            if self.graph is not None:
                self.graph.spans.append(self)
                return False
            prof._pending.append(self)
            if len(prof._pending) >= prof._fold_at:
                prof._fold(wait=False)
        return False


class Profiler:
    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._pending: Deque[_Open] = collections.deque()
        self._fold_at = FOLD_AT        # the waiting spans at the next fold
        self._spare: Dict[int, List[torch.cuda.Event]] = {}
        # name -> [calls, host s, host self s, device s, device self s]; the
        # device ones None until a span of the name times the card
        self._totals: Dict[str, list] = {}
        self._counters: Dict[str, List[float]] = {}     # name -> [adds, sum]
        self._capturing = False                         # a capture is open
        self._graph: Optional[GraphSpans] = None        # what it records into
        self._live: List[GraphSpans] = []               # replays not folded

    def reset(self) -> None:
        with self._lock:
            self._pending.clear()
            self._fold_at = FOLD_AT
            self._totals.clear()
            self._counters.clear()
            for g in self._live:
                g.live = False
            self._live.clear()

    def recording(self) -> bool:
        """Whether spans and counters record (``-T 4`` or a
        ``torch.profiler`` session; on the stream of an open capture, where
        it captures into spans)."""
        if self._capturing and torch.cuda.is_current_stream_capturing():
            return self._graph is not None
        return self.enabled or _profiler_enabled()

    def phase(self, name: str, device: Optional[torch.device] = None,
              timed_in_trace: bool = False):
        """A span named ``name``; with a CUDA ``device``, also timed on
        that device's current stream (under a ``torch.profiler`` session
        alone only with ``timed_in_trace``, as in a capture)."""
        if self._capturing and torch.cuda.is_current_stream_capturing():
            g = self._graph
            return _NULL if g is None else _Open(self, name, device, timed_in_trace, g)
        if not (self.enabled or _profiler_enabled()):
            return _NULL
        return _Open(self, name, device, self.enabled or timed_in_trace)

    def count(self, name: str, n: float) -> None:
        """Add ``n`` to the counter ``name`` (one add a call)."""
        if self._capturing and torch.cuda.is_current_stream_capturing():
            if self._graph is not None:
                with self._lock:
                    self._graph.counts.append((name, n))
            return
        if not (self.enabled or _profiler_enabled()):
            return
        self._add(name, n)

    def _add(self, name: str, n: float) -> None:
        with self._lock:
            row = self._counters.setdefault(name, [0, 0])
            row[0] += 1
            row[1] += n

    @contextlib.contextmanager
    def capturing(self, spans: Optional[GraphSpans]):
        """Record into ``spans`` what the threads whose stream captures a
        CUDA graph record (the step's own thread and autograd's); with
        None, record nothing of theirs."""
        self._capturing, self._graph = True, spans
        try:
            yield spans
        finally:
            self._capturing, self._graph = False, None

    def replay(self, spans: GraphSpans, launch: Callable[[], None]) -> None:
        """``launch()`` a replay of the graph captured into ``spans``, then
        record its spans and counters once more (its last replay's spans
        folded first)."""
        with self._lock:
            if spans.live:
                self._fold_graph(spans)
        launch()
        with self._lock:
            spans.live = True
            self._live.append(spans)
        for name, n in spans.counts:
            self._add(name, n)

    # -- recording ---------------------------------------------------------
    def _stack(self) -> List[_Open]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _event(self, index: int, graph: bool = False) -> torch.cuda.Event:
        """A timing event, reused from spans already folded, recorded on
        the current stream of CUDA device ``index``; with ``graph`` a new
        one, captured as an event node of the graph."""
        if graph:
            ev = torch.cuda.Event(enable_timing=True, external=True)
            ev.record(torch.cuda.current_stream(index))
            return ev
        with self._lock:
            spare = self._spare.setdefault(index, [])
            ev = spare.pop() if spare else None
        if ev is None:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(index))
        return ev

    def _fold(self, wait: bool) -> None:
        """Fold closed spans into the totals in the order they closed, up
        to the first whose closing event the card has not reached (all of
        them with ``wait``, which waits for each such event); the next fold
        comes ``FOLD_AT`` spans later. Holds the lock."""
        pending = self._pending
        while pending:
            sp = pending[0]
            if sp.ev1 is not None and not sp.ev1.query():
                if not wait:
                    break
                sp.ev1.synchronize()
            pending.popleft()
            host = sp.t1 - sp.t0
            dev = None
            if sp.ev1 is not None:
                dev = sp.ev0.elapsed_time(sp.ev1) * 1e-3
                self._spare.setdefault(sp.device, []).extend((sp.ev0, sp.ev1))
                sp.ev0 = sp.ev1 = None
                if sp.parent is not None:
                    sp.parent.child_dev += dev
            row = self._totals.setdefault(sp.name, [0, 0.0, 0.0, None, None])
            row[0] += 1
            row[1] += host
            row[2] += host - sp.child_host
            if dev is not None:
                row[3] = (row[3] or 0.0) + dev
                row[4] = (row[4] or 0.0) + dev - sp.child_dev
            sp.parent = None
        self._fold_at = len(pending) + FOLD_AT

    def _fold_graph(self, g: GraphSpans) -> None:
        """Fold the spans of ``g``'s last replay, waiting for the card to
        finish it (no host time: the host ran none of it). Holds the lock."""
        child: Dict[int, float] = {}
        for sp in g.spans:
            dev = None
            if sp.ev1 is not None:
                sp.ev1.synchronize()
                dev = sp.ev0.elapsed_time(sp.ev1) * 1e-3
                if sp.parent is not None:
                    child[id(sp.parent)] = child.get(id(sp.parent), 0.0) + dev
            row = self._totals.setdefault(sp.name, [0, 0.0, 0.0, None, None])
            row[0] += 1
            if dev is not None:
                row[3] = (row[3] or 0.0) + dev
                row[4] = (row[4] or 0.0) + dev - child.get(id(sp), 0.0)
        g.live = False
        self._live.remove(g)

    # -- reading -----------------------------------------------------------
    def totals(self) -> Dict[str, Dict[str, Optional[float]]]:
        """Per span name, after waiting for the card: ``calls``, ``host_s``,
        ``host_self_s``, ``device_s`` and ``device_self_s`` (the device
        ones None where the span recorded no device time)."""
        with self._lock:
            self._fold(wait=True)
            for g in list(self._live):
                self._fold_graph(g)
            return {name: {"calls": calls, "host_s": host, "host_self_s": host_self,
                           "device_s": dev, "device_self_s": dev_self}
                    for name, (calls, host, host_self, dev, dev_self) in self._totals.items()}

    def counters(self) -> Dict[str, Dict[str, float]]:
        """Per counter: ``adds`` (calls of ``count``) and ``sum``."""
        with self._lock:
            return {k: {"adds": a, "sum": s} for k, (a, s) in self._counters.items()}

    def report(self) -> str:
        """The profile table: each span's host seconds, their share of the
        host self seconds of all spans, its calls and, where it recorded
        any, its device seconds; then the counters."""
        tot = self.totals()
        if not tot:
            return ""
        total = sum(r["host_self_s"] for r in tot.values())
        lines = ["[profile]"]
        for name in sorted(tot, key=lambda k: tot[k]["host_s"], reverse=True):
            r = tot[name]
            line = (f"  {name:<28} {r['host_s']:9.3f}s  {100 * r['host_s'] / total:5.1f}%"
                    f"  x{r['calls']}")
            if r["device_s"] is not None:
                line += f"  device {r['device_s']:9.3f}s"
            lines.append(line)
        lines.append(f"  {'TOTAL':<28} {total:9.3f}s")
        counters = self.counters()
        if counters:
            lines.append("[counters]")
            for name in sorted(counters):
                c = counters[name]
                lines.append(f"  {name:<28} {c['sum']:12.0f}  x{c['adds']}")
        return "\n".join(lines) + "\n"


# process-wide instance (the CuDevice-singleton analog)
profiler = Profiler()


def enable_from_trace(trace: int) -> None:
    """trace&4 turns profiling on, matching the reference's -T bitmask."""
    if trace & 4:
        profiler.enabled = True

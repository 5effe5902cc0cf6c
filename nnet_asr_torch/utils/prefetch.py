"""Background prefetching for the input pipeline.

The reference overlaps feature reading with training via a dedicated
reader thread with backpressure (Platform::ReadData, Platform.h:201-245,
suspend >20 / wake <=5). Here a thread pool maps the read function over
the utterance list with a bounded in-order queue: native htkio calls
release the GIL, so reads genuinely overlap device compute.

The port's copy of ``nnet_asr_tpu/utils/prefetch.py``, behaviour unchanged.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")


def prefetch_map(fn: Callable[[T], U], items: Iterable[T],
                 workers: int = 4, depth: int = 20) -> Iterator[U]:
    """Ordered parallel map with bounded lookahead (backpressure at
    ``depth`` outstanding items, the reference's suspend threshold)."""
    items = iter(items)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = []
        try:
            for _ in range(depth):
                pending.append(pool.submit(fn, next(items)))
        except StopIteration:
            items = None
        while pending:
            fut = pending.pop(0)
            if items is not None:
                try:
                    pending.append(pool.submit(fn, next(items)))
                except StopIteration:
                    items = None
            yield fut.result()

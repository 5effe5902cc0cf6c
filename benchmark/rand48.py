"""srand48/lrand48 and libstdc++'s ``std::random_shuffle``, bit for bit:
the frame order of TNet's cache shuffle (TNetLib/Cache.cc: ``srand48(seed)``,
then ``random_shuffle`` with ``lrand48() % n``), which the reference of the
streamed cell recomputes. drand48 is the POSIX 48-bit LCG; random_shuffle
swaps ``a[i]`` with ``a[lrand48() % (i + 1)]`` for i = 1 .. n-1.
"""

from __future__ import annotations

import numpy as np

_A, _C, _MASK = 0x5DEECE66D, 0xB, (1 << 48) - 1


class Shuffler:
    """``srand48(seed)``, then one ``random_shuffle`` a cache, the stream
    of draws running on from cache to cache."""

    def __init__(self, seed: int):
        self._x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def order(self, n: int) -> np.ndarray:
        """The order ``random_shuffle`` gives ``0 .. n-1``."""
        x, idx = self._x, np.arange(n, dtype=np.int64)
        for i in range(1, n):
            x = (_A * x + _C) & _MASK
            j = (x >> 17) % (i + 1)
            idx[i], idx[j] = idx[j], idx[i]
        self._x = x
        return idx

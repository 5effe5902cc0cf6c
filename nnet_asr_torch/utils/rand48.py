"""Bit-exact re-implementation of srand48/lrand48 and std::random_shuffle.

The reference seeds the cache shuffle with ``srand48(seed)`` and permutes
with ``std::random_shuffle(ptr, ptr+n, lrand48() % max)`` (TNetLib/Cache.cc:40-51,
156-183). Both are fully specified: drand48 is the POSIX 48-bit LCG and
libstdc++'s random_shuffle is Fisher-Yates ``swap(a[i], a[rng(i+1)])`` for
i = 1..n-1 — so the exact frame-shuffle order is reproducible here, which is
what makes seeded runs comparable across the reference and this framework.

The port's copy of ``nnet_asr_tpu/utils/rand48.py``, behaviour unchanged.
"""

from __future__ import annotations

import numpy as np

_A = 0x5DEECE66D
_C = 0xB
_MASK = (1 << 48) - 1


class Rand48:
    def __init__(self, seed: int = 0):
        self.srand48(seed)

    def srand48(self, seed: int) -> None:
        self._x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def _step(self) -> int:
        self._x = (_A * self._x + _C) & _MASK
        return self._x

    def lrand48(self) -> int:
        """Non-negative long in [0, 2^31)."""
        return self._step() >> 17

    def drand48(self) -> float:
        return self._step() / float(1 << 48)

    def random_shuffle(self, arr: np.ndarray) -> np.ndarray:
        """In-place libstdc++ std::random_shuffle with lrand48()%max."""
        n = len(arr)
        for i in range(1, n):
            j = self.lrand48() % (i + 1)
            arr[i], arr[j] = arr[j], arr[i]
        return arr

    def permutation(self, n: int) -> np.ndarray:
        """The exact permutation Cache::Randomize produces for n frames."""
        idx = np.arange(n, dtype=np.int64)
        # vectorized Fisher-Yates needs the j sequence first
        js = np.empty(n, dtype=np.int64)
        for i in range(1, n):
            js[i] = self.lrand48() % (i + 1)
        for i in range(1, n):
            j = js[i]
            idx[i], idx[j] = idx[j], idx[i]
        return idx

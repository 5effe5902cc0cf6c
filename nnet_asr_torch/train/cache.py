"""Device-resident frame-shuffling cache (port of ``DeviceFrameCache`` in
nnet_asr_tpu/train/cache.py).

Cache/CuCache semantics (TNetLib/Cache.cc, CuTNetLib/cuCache.cc): blocks
append in arrival order into one fixed device buffer (cuCache.cc
preallocates cachesize rows too), the cache drains at exact ``cachesize``
boundaries, the overflow of the block that crossed the boundary carries
into the next fill, and the trailing sub-bunch of a drain is discarded
(Cache.cc:239-244). The shuffle is the bit-exact srand48 +
std::random_shuffle permutation of the port's ``utils/rand48.py``, made on the host;
the row gather into stacked bunches runs on the device. ``max_bunches``
is the partial drain of the multi-device intake (``parallel/sharded_trainer.py``).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.rand48 import Rand48


class DeviceFrameCache:
    def __init__(self, cachesize: int, bunchsize: int, seed: int = 0,
                 randomize: bool = True):
        if cachesize % bunchsize != 0:
            raise ValueError(
                f"Non divisible cachesize {cachesize} by bunchsize {bunchsize}")
        self.cachesize = cachesize
        self.bunchsize = bunchsize
        self.randomize = randomize
        if seed == 0:
            seed = int(time.time())
        self.rng = Rand48(seed)
        self._buf: Optional[torch.Tensor] = None    # (cachesize + slack, D)
        self._labels = np.zeros((0,), np.int32)
        self._rows = 0                              # valid rows in _buf
        self.discarded = 0

    def _ensure_buffer(self, block: torch.Tensor) -> None:
        need = self.cachesize + block.shape[0]
        if self._buf is None or self._buf.shape[0] < need:
            buf = torch.empty((need, block.shape[1]), dtype=block.dtype,
                              device=block.device)
            if self._buf is not None:
                buf[:self._rows] = self._buf[:self._rows]
            self._buf = buf

    def add_block(self, block: torch.Tensor, valid: int, labels: np.ndarray) -> None:
        """Append ``block[:valid]`` (device rows from
        ``TransformPipeline.transform_block``) + host int labels."""
        if labels.shape[0] != valid or valid > block.shape[0]:
            raise ValueError(f"{labels.shape[0]} labels for {valid} valid rows "
                             f"of a {block.shape[0]}-row block")
        if self._rows >= self.cachesize:
            raise RuntimeError("AddData on full cache")
        self._ensure_buffer(block)
        self._buf[self._rows:self._rows + valid] = block[:valid]
        self._rows += valid
        self._labels = np.concatenate([self._labels, labels[:valid].astype(np.int32)])

    @property
    def full(self) -> bool:
        return self._rows >= self.cachesize

    @property
    def rows(self) -> int:
        return self._rows

    def take_stacked(self, max_bunches: Optional[int] = None
                     ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Shuffle + stack the cache into ((nb, bunch, D) feats, (nb, bunch)
        int32 labels) on the device and carry the overflow to the front for
        the next fill. None if fewer than one bunch is cached.

        ``max_bunches`` drains at most that many bunches and carries ALL
        remaining rows (not just the overflow past cachesize), discarding
        nothing: the ranks of a distributed intake drain the bunch count
        they agreed on each round. Only the drained prefix is shuffled;
        carried rows keep their arrival order."""
        if self._rows == 0:
            raise RuntimeError("take_stacked on empty cache")
        B = self.bunchsize
        n = min(self._rows, self.cachesize)
        if max_bunches is not None:
            n = min(n, max_bunches * B)
            n -= n % B      # partial drains take whole bunches only
            if n == 0:
                return None
        nb = n // B
        labels, self._labels = self._labels[:n], self._labels[n:]
        dev = self._buf.device
        if self.randomize:
            perm = self.rng.permutation(n)
            labels = labels[perm]
            rows = torch.from_numpy(perm[:nb * B]).to(dev)
        else:
            rows = torch.arange(nb * B, device=dev)
        out = None
        if nb > 0:
            # a gather makes a fresh tensor, so the roll below cannot touch it
            feats = self._buf.index_select(0, rows)
            out = (feats.reshape(nb, B, self._buf.shape[1]),
                   torch.from_numpy(np.ascontiguousarray(
                       labels[:nb * B].reshape(nb, B))).to(dev))
        if max_bunches is None:
            self.discarded += n - nb * B
        if self._rows > n:
            rest = self._rows - n
            self._buf[:rest] = self._buf[n:self._rows].clone()
            self._rows = rest
        else:
            self._rows = 0
            self._labels = np.zeros((0,), np.int32)
        return out

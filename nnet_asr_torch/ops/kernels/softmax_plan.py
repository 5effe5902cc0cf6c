"""Launch plan of the fused softmax-CE kernel (``csrc/softmax_ce.cu``).

``plan`` picks one of three shapes of the kernel from the row width C, the
batch B and the base pointer alone:

- ``NARROW`` (C <= ``NARROW_MAX``): one warp per row, ``NARROW_ROWS`` rows a
  block at a time, ``vpt`` values a lane (a power of two, 32 * vpt >= C)
  held in registers; MLP3's 960 x 135 gets 240 blocks;
- ``ROWS`` (C <= ``ROWS_MAX``): one block per row, ``ROWS_VPT`` values a
  thread, in a power of two of threads (64 to ``ROWS_THREADS``, so that
  whole blocks fill an SM; fewer threads a row hold more rows in flight);
  the production width 8192 is 512 threads x 16 values;
- ``WIDE`` (C > ``ROWS_MAX``): one block of ``WIDE_THREADS`` per row that
  walks the row twice, ``WIDE_UNROLL`` chunks a thread per step.

The grid is at most what the card holds at once, counting 1024 threads an
SM (the kernels keep to 64 registers a thread): block b works on rows
b, b + stride, ... (NARROW: its warp g on rows 4b + g, 4b + g + stride,
...; stride = blocks * rows_per_block), one after the other, and sums its
rows' stats in that order. ``block_rows`` lists them.

16-byte loads and stores (``vec``) need C to be a multiple of 4 floats and
a 16-byte aligned base (and, for NARROW, whole chunks: vpt % 4 == 0). In
every shape thread t of a row of T threads takes the chunks t + k*T,
k = 0, 1, ..., of 4 columns (vec) or 1: ``thread_columns`` spells that out
for the CPU tests, which hold every main-path shape to its plan.

Pure Python and numpy; the constants match the kernel's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

SM_COUNT = 132           # H100 SXM
SM_THREADS = 1024        # threads an SM holds at 64 registers a thread
NARROW, ROWS, WIDE = 0, 1, 2
NARROW_MAX = 512         # 32 lanes x 16 values
NARROW_ROWS = 4
NARROW_VPT = (1, 2, 4, 8, 16)
ROWS_MAX = 8192          # 512 threads x 16 values
ROWS_THREADS = 512
ROWS_VPT = 16
WIDE_THREADS = 512
WIDE_UNROLL = 4


class Plan(NamedTuple):
    variant: int         # NARROW, ROWS or WIDE
    threads: int         # of a block
    row_threads: int     # threads that share one row
    rows_per_block: int  # rows a block works on at once
    vpt: int             # values a thread holds (NARROW, ROWS) or loads per step (WIDE)
    vec: bool            # 16-byte loads and stores (else 4-byte)
    blocks: int          # the grid


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, C: int, ptr: int = 0) -> Plan:
    """The plan of (B, C) contiguous f32 logits whose base is at ``ptr``."""
    if B < 1 or C < 1:
        raise ValueError(f"empty logits {B}x{C}")
    vec = C % 4 == 0 and ptr % 16 == 0
    if C <= NARROW_MAX:
        vpt = next(v for v in NARROW_VPT if 32 * v >= C)
        threads = 32 * NARROW_ROWS
        return Plan(NARROW, threads, 32, NARROW_ROWS, vpt, vec and vpt % 4 == 0,
                    _grid(_cdiv(B, NARROW_ROWS), threads))
    if C <= ROWS_MAX:
        threads = max(64, 1 << (_cdiv(C, ROWS_VPT) - 1).bit_length())
        return Plan(ROWS, threads, threads, 1, ROWS_VPT, vec, _grid(B, threads))
    return Plan(WIDE, WIDE_THREADS, WIDE_THREADS, 1, WIDE_UNROLL * (4 if vec else 1), vec,
                _grid(B, WIDE_THREADS))


def _grid(blocks: int, threads: int) -> int:
    return min(blocks, SM_COUNT * max(1, SM_THREADS // threads))


def block_rows(p: Plan, B: int, b: int) -> list:
    """The rows block b works on, by row group (a warp of NARROW, else the
    block), each in the order the group takes them."""
    stride = p.blocks * p.rows_per_block
    return [list(range(b * p.rows_per_block + g, B, stride)) for g in range(p.rows_per_block)]


def thread_columns(p: Plan, C: int) -> np.ndarray:
    """(row_threads, n): the columns thread t of a row takes, in its order
    (for WIDE, the order of its two walks); -1 where a slot lies past C."""
    width = 4 if p.vec else 1
    T = p.row_threads
    if p.variant == WIDE:
        slots = _cdiv(_cdiv(C, width), WIDE_UNROLL * T) * WIDE_UNROLL
    else:
        slots = p.vpt // width
    chunk = np.arange(T)[:, None] + T * np.arange(slots)[None, :]
    cols = (chunk[:, :, None] * width + np.arange(width)).reshape(T, slots * width)
    return np.where(cols < C, cols, -1)

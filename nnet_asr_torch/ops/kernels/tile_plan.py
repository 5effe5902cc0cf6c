"""Launch plan of the tensor-core GEMM kernels (``csrc/tile_gemm.cuh``).

``matmul_act`` and ``wgrad_momentum_update`` share one main loop with two
tile shapes. ``plan`` picks, from the shapes and pointers alone:

- the tile: 128x128 (8 warps) where that grid has at least one block per
  SM, else 64x64 (4 warps);
- for the weight gradient only, split-K: the 64x64 tile is planned for two
  blocks per SM (one warp per scheduler alone leaves the mma latency bare),
  so where its grid has fewer (example-01's 960 x 1024 -> 135 has 48
  tiles, 960 x 598 -> 1024 has 160), the contraction is cut into
  ``splits`` chunks of ``k_chunk`` rows (a multiple of BK, at least
  ``MIN_K_STEPS`` steps each) to reach that;
- per operand, 16-byte or 4-byte asynchronous copies: 16 bytes needs a row
  pitch that is a multiple of 4 floats and a 16-byte aligned base pointer
  (the main path's widths 598 and 135 are neither).

Pure Python, so the CPU tests hold every main-path shape to its plan; the
indices of ``BIG``/``SMALL`` and ``BK`` match ``BigTile``/``SmallTile``.
"""

from __future__ import annotations

from typing import NamedTuple

SM_COUNT = 132           # H100 SXM
BK = 32                  # contraction step of both tiles
BIG, SMALL = 0, 1
TILES = {BIG: (128, 128), SMALL: (64, 64)}
SMALL_PER_SM = 2         # 64x64 blocks per SM that split-K aims at
MIN_K_STEPS = 4          # BK steps a split keeps at least
MAX_SPLITS = 16


class Plan(NamedTuple):
    tile: int            # BIG or SMALL
    bm: int
    bn: int
    splits: int          # 1: no split-K
    k_chunk: int         # rows of the contraction per split
    a_vec: bool          # 16-byte copies of A (else 4-byte)
    b_vec: bool          # 16-byte copies of B


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_count(M: int, N: int, tile: int) -> int:
    bm, bn = TILES[tile]
    return _cdiv(M, bm) * _cdiv(N, bn)


def vec16(pitch: int, ptr: int) -> bool:
    """Whether 16-byte copies can describe a matrix's rows."""
    return pitch % 4 == 0 and ptr % 16 == 0


def plan(M: int, N: int, K: int, a_pitch: int, b_pitch: int, a_ptr: int = 0,
         b_ptr: int = 0, split_k: bool = False) -> Plan:
    """The plan of an (M, K) x (K, N) product whose operands have row
    pitches ``a_pitch``, ``b_pitch`` (floats) at ``a_ptr``, ``b_ptr``."""
    if min(M, N, K) < 1:
        raise ValueError(f"empty GEMM {M}x{K}->{N}")
    tile = BIG if tile_count(M, N, BIG) >= SM_COUNT else SMALL
    tiles = tile_count(M, N, tile)
    splits, k_chunk = 1, K
    if split_k and tile == SMALL and tiles < SMALL_PER_SM * SM_COUNT:
        steps = _cdiv(K, BK)
        want = min(_cdiv(SMALL_PER_SM * SM_COUNT, tiles), MAX_SPLITS,
                   max(1, steps // MIN_K_STEPS))
        k_chunk = _cdiv(steps, want) * BK
        splits = _cdiv(K, k_chunk)
        if splits == 1:
            k_chunk = K
    bm, bn = TILES[tile]
    return Plan(tile, bm, bn, splits, k_chunk, vec16(a_pitch, a_ptr), vec16(b_pitch, b_ptr))

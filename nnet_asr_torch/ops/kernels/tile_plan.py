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
- per operand, the copy width: 16-byte asynchronous copies need a row
  pitch that is a multiple of 16 bytes and a 16-byte aligned base pointer
  (the main path's widths 598 and 135 are neither), else 4-byte ones a
  pitch and base in whole 4-byte words; a bf16 matrix with an odd pitch
  (135 columns: rows of 270 bytes, the weight gradient of MLP3's output
  layer) gets 2-byte plain loads, since ``cp.async`` has no 2-byte size.

The bf16 ``mma.sync`` loop shares the tiles, ``BK`` and the split.

``route`` names the kernel. ``WGMMA`` (``csrc/wgmma_gemm.cuh``: TMA loads
into a warp-specialised ring, ``wgmma``, ``BK`` 64, no split; 128x256
tiles for ``matmul_act``, 128x128 ones for the weight gradient, whose two
consumer warpgroups take turns) is taken exactly where the element size is 2 (bf16), every operand
TMA reads has a row pitch that is a multiple of 16 bytes, and every such
operand and every output written in wide accesses (``out_ptrs``: y of
``matmul_act``, which TMA stores; p and v of the weight gradient) has a
16-byte aligned base. Everything else is ``MMA_SYNC`` (``tile_gemm.cuh``),
among it MLP3's bf16 shapes: rows of 598 and 135 elements (1,196 and 270
bytes) that no TMA map describes. ``blocks`` is the kernel's grid: for the
weight gradient on ``WGMMA`` a persistent grid of ``min(tiles, SM_COUNT)``
blocks walking the tiles, two at a time. Pure Python, so the CPU tests hold every
main-path shape to its plan; the indices of ``BIG``/``SMALL`` and ``BK``
match ``BigTile``/``SmallTile``, ``WIDE`` and ``WGMMA_BK`` match
``wgmma_gemm.cuh``.
"""

from __future__ import annotations

from typing import NamedTuple

SM_COUNT = 132           # H100 SXM
BK = 32                  # contraction step of both tiles
BIG, SMALL, WIDE = 0, 1, 2
TILES = {BIG: (128, 128), SMALL: (64, 64), WIDE: (128, 256)}
MMA_SYNC, WGMMA = 0, 1
WGMMA_BK = 64            # contraction step of the WGMMA ring
SMALL_PER_SM = 2         # 64x64 blocks per SM that split-K aims at
MIN_K_STEPS = 4          # BK steps a split keeps at least
MAX_SPLITS = 16


class Plan(NamedTuple):
    tile: int            # BIG or SMALL
    bm: int
    bn: int
    splits: int          # 1: no split-K
    k_chunk: int         # rows of the contraction per split
    a_bytes: int         # copy width of A: 16, 4 or (2-byte elements) 2
    b_bytes: int         # copy width of B
    route: int           # MMA_SYNC or WGMMA
    blocks: int          # blocks of the GEMM kernel's grid

    @property
    def a_vec(self) -> bool:
        """16-byte copies of A."""
        return self.a_bytes == 16

    @property
    def b_vec(self) -> bool:
        """16-byte copies of B."""
        return self.b_bytes == 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_count(M: int, N: int, tile: int) -> int:
    bm, bn = TILES[tile]
    return _cdiv(M, bm) * _cdiv(N, bn)


def copy_bytes(pitch: int, ptr: int, elem: int = 4) -> int:
    """The widest copy (16, 4 or ``elem`` bytes) that describes every row
    of a matrix with row pitch ``pitch`` elements of ``elem`` bytes at
    ``ptr``."""
    for width in (16, 4):
        if (pitch * elem) % width == 0 and ptr % width == 0:
            return width
    return elem


def vec16(pitch: int, ptr: int) -> bool:
    """Whether 16-byte copies can describe an f32 matrix's rows."""
    return copy_bytes(pitch, ptr) == 16


def wgmma_route(elem: int, pitches, ptrs) -> bool:
    """Whether TMA and wgmma can take the product: 2-byte elements, row
    pitches (elements) of 16-byte multiples, every pointer 16-byte
    aligned."""
    return (elem == 2 and all(p * elem % 16 == 0 for p in pitches)
            and all(p % 16 == 0 for p in ptrs))


def plan(M: int, N: int, K: int, a_pitch: int, b_pitch: int, a_ptr: int = 0,
         b_ptr: int = 0, split_k: bool = False, elem: int = 4, out_ptrs=()) -> Plan:
    """The plan of an (M, K) x (K, N) product whose operands, of ``elem``
    bytes an element (4: f32, 2: bf16), have row pitches ``a_pitch``,
    ``b_pitch`` (elements) at ``a_ptr``, ``b_ptr``; ``out_ptrs``: the
    outputs' base pointers; ``split_k``: the weight gradient's plan."""
    if min(M, N, K) < 1:
        raise ValueError(f"empty GEMM {M}x{K}->{N}")
    if elem not in (2, 4):
        raise ValueError(f"element size {elem}: want 4 (f32) or 2 (bf16)")
    if wgmma_route(elem, (a_pitch, b_pitch), (a_ptr, b_ptr, *out_ptrs)):
        tile = BIG if split_k else WIDE
        tiles = tile_count(M, N, tile)
        return Plan(tile, *TILES[tile], 1, K, 16, 16, WGMMA,
                    min(tiles, SM_COUNT) if split_k else tiles)
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
    return Plan(tile, bm, bn, splits, k_chunk, copy_bytes(a_pitch, a_ptr, elem),
                copy_bytes(b_pitch, b_ptr, elem), MMA_SYNC, tiles * splits)

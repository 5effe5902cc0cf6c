"""Launch plan of the tensor-core GEMM kernels (``csrc/tile_gemm.cuh``).

``matmul_act`` and ``wgrad_momentum_update`` share one main loop with two
tile shapes. ``plan`` picks, from the shapes and pointers alone:

- the tile: 128x128 (8 warps) where that grid has at least one block per
  SM, else 64x64 (the SMALL tile: 72 KB of shared memory for f32 operands
  in a 4-stage ring, 4 warps of 32x32, or 8 of 32x16 for the f32 forward;
  ``SMALL_PER_SM`` = 3 blocks' shared memory fits an SM);
- for both kernels, split-K on the SMALL tile, where it shortens the
  busiest SM's time (``split_count``). The grid's blocks spread evenly
  over the SMs, so a grid of ``tiles`` tiles cut ``S`` ways puts ``B =
  ceil(tiles * S / SM_COUNT)`` blocks of ``steps / S`` BK steps on the
  busiest SM, ``SMALL_PER_SM`` at a time; each such wave also pays a
  block's fixed cost (its ring's prologue, the epilogue, the partials'
  round trip), ``BLOCK_COST`` BK steps: 3 of 3xTF32, 9 of the bf16 pass,
  whose steps are three times cheaper. The fewest splits of the least
  ``B * steps / S + ceil(B / SMALL_PER_SM) * BLOCK_COST``, with at least
  ``MIN_K_STEPS`` steps a split, are taken. One tmpe utterance's
  284x598->1024 (80 tiles: 52 SMs idle) runs 3 splits, the f32 weight
  gradients 960x598->1024 (160 tiles) 4 and 960x1024->135 (48 tiles) 5,
  the bf16 ones 2 and 5; TIMIT's 1024x368->500 (128 tiles) and MLP3's
  960x598->1024 forward (240 tiles) stay whole, since no split evens
  their load (``tools/gemm_ceiling.py --small`` measured each choice
  against its neighbours). Each split writes its f32 partial tile to a
  scratch buffer of ``blocks * bm * bn`` floats; the block that arrives
  last at a tile (an int counter per tile, kept zeroed) sums the partials
  in split order and runs the epilogue, in the same launch;
- per operand, the copy width: 16-byte asynchronous copies need a row
  pitch that is a multiple of 16 bytes and a 16-byte aligned base pointer
  (the main path's widths 598 and 135 are neither), else 8-byte ones a
  pitch and base in whole 8-byte units (f32 rows of 598: 2,392 bytes; f32
  operands on the SMALL tile only, whose kernels compile that path), else
  4-byte ones; a bf16 matrix with an odd pitch (135 columns: rows of 270
  bytes, the weight gradient of MLP3's output layer) gets 2-byte plain
  loads, since ``cp.async`` has no 2-byte size.

The bf16 ``mma.sync`` loop shares the tiles and ``BK``; its split weighs
the fixed cost of a block against its three times cheaper steps.

``route`` names the kernel. ``WGMMA`` (``csrc/wgmma_gemm.cuh``: TMA loads
into a warp-specialised ring, ``wgmma``, no split; 128x256 tiles for the
bf16 ``matmul_act``, else 128x128 ones on a persistent grid, whose two
consumer warpgroups take turns) is taken where the element size has such a route
(``WGMMA_ELEMS``), every operand TMA reads has a row pitch that is a
multiple of 16 bytes, and every such operand and every output written in
wide accesses (``out_ptrs``: y of ``matmul_act``; p and v of the weight
gradient) has a 16-byte aligned base. For 2-byte elements (bf16: one
``wgmma`` pass, ``BK`` 64) that is the whole rule. For 4-byte ones (f32:
3xTF32 on ``wgmma``, ``csrc/tf32_wgmma.cuh``, ``BK`` 32) the operand split
by the pre-pass, whose pitch is ``K``, counts among the operands, and the
product must be one whose 128x128 tiles fill the card (``tile_count(M, N,
BIG) >= SM_COUNT``, where the ``MMA_SYNC`` plan takes its BIG tile): the
production stack's 1024x{1024,4096}->4096 forward and its weight
gradients. Every other shape is ``MMA_SYNC`` (``tile_gemm.cuh``), with the
plan it had, but those of ``CP_WGMMA`` (below: the bf16 forward off TMA,
every f32 shape on the SMALL tile): the bf16 weight gradients at MLP3's
rows of 598 and 135 elements (1,196 and 270 bytes) that no TMA map
describes, bf16 rows of odd pitch, and the f32 products of the BIG tile's
size whose rows TMA cannot read. ``blocks`` is the kernel's grid: on ``WGMMA``, but for
the bf16 forward, a persistent grid of ``min(tiles, SM_COUNT)`` blocks
walking the tiles, two at a time. Pure Python, so the CPU tests
hold every main-path shape to its plan; ``BIG``/``SMALL``, ``BK``,
``STAGES`` and ``smem_bytes`` match ``BigTile``/``SmallTile`` and
``smem_bytes`` there, ``WIDE``, ``WGMMA_BK`` and ``wgmma_smem_bytes`` match
``wgmma_gemm.cuh`` and ``tf32_wgmma.cuh``, ``CP_STAGES``, ``CP_BK`` and
``cp_smem_bytes`` match ``CpPlanned`` of ``matmul_act.cu`` and ``cp_wgmma.cuh``.

``CP_WGMMA`` (``wgmma`` fed by ``cp.async`` copies that write the swizzled
layout the descriptors read) has a kernel for each element size of
``CP_WGMMA_ELEMS``, taken wherever every row pitch and base pointer, the
output's too, is a whole number of 4-byte units:

- bf16 (``csrc/cp_wgmma.cuh``), the forward only, wherever TMA cannot read
  the rows: MLP3's x at 598 columns (1,196-byte rows, 4-byte copies),
  TIMIT's W and y at 500 (1,000-byte rows, 8-byte copies), one tmpe
  utterance's and a mesh rank's rows. Its tile is 64x64 on one warpgroup, a
  ring of ``CP_STAGES`` stages of ``CP_BK`` = 64, split-K as ``cp_splits``
  says (``HALF`` 64x128, ``TALL`` 128x64 and ``BIG`` 128x128 are the tiles
  it was measured against, ``tools/gemm_ceiling.py --small``). A bf16 row
  of odd pitch (135 columns), or a base off a 4-byte boundary, has no such
  copy and stays on ``MMA_SYNC``.
- f32 (``csrc/cp_tf32_wgmma.cuh``: 3xTF32, x split into hi and lo in the
  block), the forward and the weight gradient, at every shape the f32
  WGMMA route leaves whose BIG ``mma.sync`` tiles would not fill the card
  (``tile_count(M, N, BIG) < SM_COUNT``; an f32 pitch is always whole
  4-byte units): every f32 product of the recipes (MLP3's 960x598->1024
  and its weight gradients 960x598->1024 and 960x1024->135, TIMIT's
  1024x368->500 and its output weight, the RBM recipe's 960x1024->1024,
  one tmpe utterance's and a mesh rank's rows). Its tile is ``CP_F32_TILE``
  (64 rows of x by 128 columns of W or e, two warpgroups of 64 columns
  each sharing x's split), a ring of ``CP_F32_STAGES`` stages of ``BK`` =
  32 floats (88 KB for the forward, 96 for the weight gradient: two blocks
  an SM), split as ``cp_f32_splits`` says, copies of 16, 8 or 4 bytes
  (64x64 on one warpgroup and 128x64 are the tiles it was measured
  against). Products of the
  BIG tile's size that TMA cannot read keep their ``MMA_SYNC`` BIG plan,
  and so does one recipe shape of the SMALL tile (``cp_f32_keeps_mma_sync``):
  the weight gradient of an odd number of outputs, MLP3's 960x1024->135.
  ``mma_sync_f32`` of ``tools/gemm_ceiling.py`` takes 4 out of this tuple
  and of ``WGMMA_ELEMS`` to force the f32 plans this route replaced.
"""

from __future__ import annotations

from typing import NamedTuple

SM_COUNT = 132           # H100 SXM
SM_SMEM = 233_472        # bytes of shared memory an SM gives its blocks (228 KB)
BLOCK_SMEM_RESERVED = 1024   # bytes of it the runtime keeps for each block
BK = 32                  # contraction step of both tiles
BIG, SMALL, WIDE, TALL, HALF = 0, 1, 2, 3, 4
TILES = {BIG: (128, 128), SMALL: (64, 64), WIDE: (128, 256), TALL: (128, 64), HALF: (64, 128)}
STAGES = {BIG: 3, SMALL: 4}   # depth of the cp.async ring
MMA_SYNC, WGMMA, CP_WGMMA = 0, 1, 2
WGMMA_ELEMS = (2, 4)     # element sizes with a WGMMA route (bf16, f32)
WGMMA_BK = {2: 64, 4: 32}   # contraction step of the WGMMA ring: one 128-byte line
CP_WGMMA_ELEMS = (2, 4)  # element sizes with a CP_WGMMA route (the bf16 forward, f32 both)
CP_STAGES = 3            # the CP_WGMMA ring (64x64 tiles: 48 KB, four blocks an SM)
CP_BK = 64               # contraction step of the CP_WGMMA ring
CP_PER_SM = 2            # CP_WGMMA blocks an SM the split aims at
CP_MIN_K_STEPS = 4       # CP_BK steps a CP_WGMMA split keeps at least
CP_F32_TILE = HALF       # the f32 CP_WGMMA tile: 64 rows of x by 128 of W's (or e's) columns
CP_F32_STAGES = 4        # the f32 CP_WGMMA ring (88 KB forward, 96 wgrad: two blocks an SM)
CP_F32_PER_SM = 2        # f32 CP_WGMMA blocks an SM holds
SMALL_PER_SM = 3         # SMALL blocks an SM holds (f32: 72 KB, <= 168 registers a thread)
MIN_K_STEPS = 4          # BK steps a split keeps at least
MAX_SPLITS = 16
BLOCK_COST = {4: 3, 2: 9}   # a block's fixed cost in BK steps, by element size


class Plan(NamedTuple):
    tile: int            # BIG or SMALL
    bm: int
    bn: int
    splits: int          # 1: no split-K
    k_chunk: int         # rows of the contraction per split
    a_bytes: int         # copy width of A: 16, 8, 4 or (2-byte elements) 2
    b_bytes: int         # copy width of B
    route: int           # MMA_SYNC, WGMMA or CP_WGMMA
    blocks: int          # blocks of the GEMM kernel's grid


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_count(M: int, N: int, tile: int) -> int:
    bm, bn = TILES[tile]
    return _cdiv(M, bm) * _cdiv(N, bn)


def split_count(tiles: int, steps: int, elem: int = 4) -> int:
    """Splits of a SMALL grid of ``tiles`` tiles over a contraction of
    ``steps`` BK steps of ``elem``-byte operands: the fewest of the least
    time on the busiest SM, ``B * steps / S + ceil(B / SMALL_PER_SM) *
    BLOCK_COST[elem]`` BK steps for ``B = ceil(tiles * S / SM_COUNT)``
    blocks; at most ``MAX_SPLITS``, and ``MIN_K_STEPS`` steps a split at
    least."""
    def cost(s):
        blocks = _cdiv(tiles * s, SM_COUNT)
        return blocks * steps / s + _cdiv(blocks, SMALL_PER_SM) * BLOCK_COST[elem]

    return min(range(1, max(1, min(MAX_SPLITS, steps // MIN_K_STEPS)) + 1),
               key=lambda s: (cost(s), s))


def smem_bytes(tile: int, elem: int, a_kmajor: bool) -> int:
    """Dynamic shared memory of a BIG or SMALL block (``smem_bytes`` of
    tile_gemm.cuh): the ring of A and B stages (rows padded as ``Ring``
    pads them), or the epilogue's staged f32 output tile where larger."""
    bm, bn = TILES[tile]
    a_stage = bm * (BK + (4 if elem == 4 else 8)) if a_kmajor else BK * (bm + 8)
    ring = elem * STAGES[tile] * (a_stage + BK * (bn + 8))
    return max(ring, 4 * bm * (bn + 8))


def copy_bytes(pitch: int, ptr: int, elem: int = 4, widths=(16, 8, 4)) -> int:
    """The widest copy (one of ``widths``, else ``elem`` bytes) that
    describes every row of a matrix with row pitch ``pitch`` elements of
    ``elem`` bytes at ``ptr``."""
    for width in widths:
        if (pitch * elem) % width == 0 and ptr % width == 0:
            return width
    return elem


def wgmma_smem_bytes(elem: int, wgrad: bool) -> int:
    """Dynamic shared memory of a WGMMA-route block (``SMEM_BYTES`` of its
    schedule): the ring, 128 bytes of barriers, the epilogue's staging and
    1024 bytes of slack to align the ring. bf16: 4 stages of x 128x64 and W
    64x256 (Cooperative), or of x and e 64x128 beside two 128x136 bf16 g
    tiles (PingPong); f32, both kernels: 4 stages of W or e 32x128 raw and
    x's hi and lo 128x32 (PingPong)."""
    if elem == 2:
        stage = 2 * WGMMA_BK[2] * (128 + (128 if wgrad else 256))
        return 4 * stage + 128 + (2 * 128 * 136 * 2 if wgrad else 0) + 1024
    return 4 * 4 * WGMMA_BK[4] * (128 + 2 * 128) + 128 + 1024


def cp_smem_bytes(tile: int = SMALL, stages: int = CP_STAGES) -> int:
    """Dynamic shared memory of a CP_WGMMA block (``SMEM_BYTES`` of its
    ``CpTile``): ``stages`` stages of x's bm rows and W's bn columns at
    ``CP_BK`` = 64 bf16 (128 bytes a row or k-line), and 1024 bytes of
    slack to align the ring."""
    bm, bn = TILES[tile]
    return stages * 2 * CP_BK * (bm + bn) + 1024


def cp_f32_smem_bytes(wgrad: bool, tile: int = HALF, stages: int = CP_F32_STAGES) -> int:
    """Dynamic shared memory of an f32 CP_WGMMA block (``SMEM_BYTES`` of
    its ``CpF32Tile``): ``stages - 2`` slots of W's or e's raw ``BK`` x bn
    k-lines, ``stages`` of the forward's x rows split in place (bm x ``BK``
    floats), 3 of x's lo rows (and of the weight gradient's hi, beside
    ``stages - 2`` of its raw x k-lines), and 1024 bytes of slack to align
    the ring."""
    bm, bn = TILES[tile]
    a, b = 4 * BK * bn, 4 * BK * bm
    return (stages - 2) * a + ((3 + 3 + stages - 2) if wgrad else (stages + 3)) * b + 1024


def cp_f32_keeps_mma_sync(wgrad: bool, b_pitch: int) -> bool:
    """Whether an f32 product the CP_WGMMA route could take stays on
    MMA_SYNC: the weight gradient whose e rows are no whole 8-byte units
    (an odd Out: MLP3's 135 senones, TIMIT's 39). There e arrives in 4-byte
    copies, p and v are updated one element at a time, and 57 of the 192
    columns of the last 64-wide tiles are empty; ``tools/gemm_ceiling.py
    --small --f32`` measured the CP_WGMMA kernel at 960x1024->135 slower
    than mma.sync under every split (its plan's 5: 20.86-21.16 us against
    17.70-17.79, NVIDIA H100 80GB HBM3, 700 W)."""
    return wgrad and b_pitch % 2 == 1


def cp_wgmma_route(elem: int, pitches, ptrs) -> bool:
    """Whether cp.async and wgmma can take the product: an element size
    with a CP_WGMMA route, row pitches (elements) and pointers in whole
    4-byte units."""
    return (elem in CP_WGMMA_ELEMS and all(p * elem % 4 == 0 for p in pitches)
            and all(p % 4 == 0 for p in ptrs))


def cp_splits(M: int, N: int, K: int) -> int:
    """Splits of a CP_WGMMA product on 64x64 tiles: K cut into the most
    splits whose blocks still fit ``CP_PER_SM`` an SM in one wave and keep
    ``CP_MIN_K_STEPS`` steps each. ``tools/gemm_ceiling.py --small``
    measured it: one tmpe utterance's 80 tiles over 10 steps run
    fastest in 3 splits, a mesh rank's 128 tiles over 10 steps in 2;
    TIMIT's 128 tiles over 6 steps and MLP3's 240 tiles whole (a split of
    6 steps costs more in the partials' round trip than it saves); the
    64x128, 128x64 and 128x128 tiles lost at all four shapes."""
    tiles = tile_count(M, N, SMALL)
    steps = _cdiv(K, CP_BK)
    splits = 1
    while (tiles * (splits + 1) <= CP_PER_SM * SM_COUNT
           and _cdiv(steps, splits + 1) >= CP_MIN_K_STEPS):
        splits += 1
    return splits


def cp_f32_splits(M: int, N: int, K: int) -> int:
    """Splits of an f32 CP_WGMMA product: the fewest of the least ``W *
    (steps / S + BLOCK_COST[4])`` BK steps for ``W`` waves of
    ``CP_F32_PER_SM`` one-warpgroup 64x64 blocks an SM (``W =
    ceil(ceil(tiles * S / SM_COUNT) / CP_F32_PER_SM)``, tiles of 64x64): a
    64x64 block takes as long beside another on its SM as alone (its
    stage's chain, not the SM's tensor cores, sets its pace), so a second
    block an SM is free and a second wave is not. At most ``MAX_SPLITS``,
    and ``MIN_K_STEPS`` steps a split. The kernels run 64x128 tiles
    (``CP_F32_TILE``: two such warpgroups sharing x's split), whose grid is
    half as many blocks of the same splits. ``tools/gemm_ceiling.py
    --small --f32`` measured every split of both tiles at the recipes'
    shapes, and this rule picks the fastest of each at each: MLP3's forward
    and the RBM recipe's 960x1024->1024 whole, TIMIT's and a mesh rank's 2
    ways, one tmpe utterance's 3, MLP3's 598->1024 weight gradient 3 (and
    960x1024->135, which stays on MMA_SYNC, 5)."""
    tiles, steps = tile_count(M, N, SMALL), _cdiv(K, BK)

    def cost(s):
        waves = _cdiv(_cdiv(tiles * s, SM_COUNT), CP_F32_PER_SM)
        return waves * (steps / s + BLOCK_COST[4])

    return min(range(1, max(1, min(MAX_SPLITS, steps // MIN_K_STEPS)) + 1),
               key=lambda s: (cost(s), s))


def cp_fixed(M: int, N: int, K: int, tile: int, splits: int, a_bytes: int,
             b_bytes: int, elem: int = 2) -> Plan:
    """The CP_WGMMA plan of an (M, K) x (K, N) product on ``tile`` with K
    cut into ``splits`` chunks of whole steps (``CP_BK`` for bf16, ``BK``
    for f32; fewer where K has fewer steps) and the given copy widths."""
    step = CP_BK if elem == 2 else BK
    k_chunk = _cdiv(_cdiv(K, step), splits) * step if splits > 1 else K
    n = _cdiv(K, k_chunk)
    return Plan(tile, *TILES[tile], n, k_chunk if n > 1 else K, a_bytes, b_bytes, CP_WGMMA,
                tile_count(M, N, tile) * n)


def wgmma_route(elem: int, pitches, ptrs) -> bool:
    """Whether TMA and wgmma can take the product: an element size with a
    WGMMA route, row pitches (elements) of 16-byte multiples, every pointer
    16-byte aligned."""
    return (elem in WGMMA_ELEMS and all(p * elem % 16 == 0 for p in pitches)
            and all(p % 16 == 0 for p in ptrs))


def plan(M: int, N: int, K: int, a_pitch: int, b_pitch: int, a_ptr: int = 0,
         b_ptr: int = 0, wgrad: bool = False, elem: int = 4, out_ptrs=()) -> Plan:
    """The plan of an (M, K) x (K, N) product whose operands, of ``elem``
    bytes an element (4: f32, 2: bf16), have row pitches ``a_pitch``,
    ``b_pitch`` (elements) at ``a_ptr``, ``b_ptr``; ``out_ptrs``: the
    outputs' base pointers; ``wgrad``: the weight gradient's plan (its
    WGMMA tile and grid differ)."""
    if min(M, N, K) < 1:
        raise ValueError(f"empty GEMM {M}x{K}->{N}")
    if elem not in (2, 4):
        raise ValueError(f"element size {elem}: want 4 (f32) or 2 (bf16)")
    # f32: the pre-pass's split copy of one operand has pitch K, and only
    # products whose 128x128 tiles fill the card take the route
    pitches = (a_pitch, b_pitch) if elem == 2 else (a_pitch, b_pitch, K)
    if (wgmma_route(elem, pitches, (a_ptr, b_ptr, *out_ptrs))
            and (elem == 2 or tile_count(M, N, BIG) >= SM_COUNT)):
        # persistent 128x128 (PingPong) but for the bf16 forward's 128x256
        persistent = wgrad or elem == 4
        tile = BIG if persistent else WIDE
        tiles = tile_count(M, N, tile)
        return Plan(tile, *TILES[tile], 1, K, 16, 16, WGMMA,
                    min(tiles, SM_COUNT) if persistent else tiles)
    if (cp_wgmma_route(elem, (a_pitch, b_pitch), (a_ptr, b_ptr, *out_ptrs))
            and (not wgrad if elem == 2 else tile_count(M, N, BIG) < SM_COUNT
                 and not cp_f32_keeps_mma_sync(wgrad, b_pitch))):
        widths = (16, 8, 4)
        return cp_fixed(M, N, K, SMALL if elem == 2 else CP_F32_TILE,
                        cp_splits(M, N, K) if elem == 2 else cp_f32_splits(M, N, K),
                        copy_bytes(a_pitch, a_ptr, elem, widths),
                        copy_bytes(b_pitch, b_ptr, elem, widths), elem)
    tile = BIG if tile_count(M, N, BIG) >= SM_COUNT else SMALL
    tiles = tile_count(M, N, tile)
    splits, k_chunk = 1, K
    want = split_count(tiles, _cdiv(K, BK), elem) if tile == SMALL else 1
    if want > 1:
        k_chunk = _cdiv(_cdiv(K, BK), want) * BK
        splits = _cdiv(K, k_chunk)
    bm, bn = TILES[tile]
    widths = (16, 8, 4) if tile == SMALL and elem == 4 else (16, 4)
    return Plan(tile, bm, bn, splits, k_chunk, copy_bytes(a_pitch, a_ptr, elem, widths),
                copy_bytes(b_pitch, b_ptr, elem, widths), MMA_SYNC, tiles * splits)

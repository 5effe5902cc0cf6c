"""Launch plan of the GEMM kernels of ``matmul_act`` and
``wgrad_momentum_update``.

``plan`` picks, from the shapes, pointers and element size alone, the
kernel's route, its tile, its split of the contraction and the width of
each operand's copies. Pure Python, so the CPU tests hold every main-path
shape to its plan; the constants match the CUDA sources named below.
The routes, in the order ``plan`` tries them:

- ``WGMMA``: TMA and ``wgmma`` on a warp-specialised ring
  (``csrc/wgmma_gemm.cuh``, one bf16 pass; ``csrc/tf32_wgmma.cuh``, 3xTF32
  for f32), wherever every operand TMA reads has a row pitch of a 16-byte
  multiple and every such operand and output (``out_ptrs``) a 16-byte
  aligned base; for f32 the pre-pass's split copy (pitch K) counts among
  them, and only products whose 128x128 tiles fill the card take it
  (``tile_count(M, N, BIG) >= SM_COUNT``: the production stack's). Tiles of
  128x256 for the bf16 forward, else 128x128 on a persistent grid of
  ``min(tiles, SM_COUNT)`` blocks whose two consumer warpgroups take turns;
  no split.
- ``WS_WGMMA``: 3xTF32 ``wgmma`` on the warp-specialised ring of
  ``csrc/cp_tf32_wgmma.cuh`` (a producer warpgroup copying by ``cp.async``
  and transposing and splitting e, a consumer warpgroup issuing
  ``wgmma``), f32, the weight gradient of an odd Out whose N width the
  kernel is built for (``ws_f32_takes``, ``WS_ROWS_WIDTHS``: MLP3's
  960x1024->135), with Out on ``wgmma``'s N (the ``ROWS`` tile, 64 rows of
  p by 136 columns, one tile across Out). A tile's splits (``ws_splits``)
  are one cluster that sums its partials through distributed shared
  memory.
- ``CP_WGMMA``: ``wgmma`` fed by ``cp.async`` copies of 16, 8 or 4 bytes
  into the swizzled layout its descriptors read, wherever every row pitch
  and base, the output's too, is a whole number of 4-byte units. bf16
  (``csrc/cp_wgmma.cuh``), where TMA cannot read the rows: the forward
  (MLP3's x at 598 columns, TIMIT's W and y at 500), 64x64 tiles, a ring of
  ``CP_STAGES`` stages of ``CP_BK``, split as ``cp_splits``; the weight
  gradient ``g = x^T e`` with In on ``wgmma``'s M and Out on its N
  (``cp_wgrad_tile``: MLP3's 960x598->1024 on 64x64 column tiles, and
  960x1024->135 on the ``ROWS`` tile across Out, where e's 270-byte rows
  need only a 16-byte aligned base: a stage of 64 whole rows is one run),
  split as ``cp_wgrad_splits``, a tile's splits one cluster. f32
  (``csrc/cp_tf32_wgmma.cuh``, 3xTF32, x split into hi and lo by the block):
  the forward and the weight gradient at every shape the routes above
  leave whose BIG tiles would not fill the card (every f32 product of the
  recipes but MLP3's 960x1024->135 weight gradient), 64 rows of x by 128
  columns of W or e (``CP_F32_TILE``), ``CP_F32_STAGES`` stages, split as
  ``cp_f32_splits``.
- ``MMA_SYNC``: ``csrc/tile_gemm.cuh``'s loop (3xTF32 or one bf16
  ``mma.sync`` pass fed by a ``cp.async`` ring), everything else: bf16 rows
  of odd pitch the routes above refuse (2-byte loads: ``cp.async`` has no
  2-byte size), f32
  products of the BIG tile's size off TMA, and the f32 weight gradient of
  an odd Out no WS_WGMMA width covers (``cp_f32_keeps_mma_sync``: TIMIT's
  39). 128x128 tiles (8 warps) where that grid fills the card, else 64x64
  (``SMALL``: ``SMALL_PER_SM`` blocks an SM), split-K on the SMALL tile
  where it shortens the busiest SM's time (``split_count``), copies of 16,
  8 (the SMALL tile's f32 kernels only) or 4 bytes (``copy_bytes``).

The f32 input gradient ``dx = dz W^T`` has a plan of its own
(``dgrad_plan``): the WGMMA route's pitches at f32 (``csrc/dgrad.cu``, W
read K-major as A, dz split by a pre-pass as B) on grids that fill the
card or all but 1/16 of one wave, else None: ``torch.matmul``.

On ``MMA_SYNC`` and ``CP_WGMMA`` each split writes its f32 partial tile to
a scratch of ``blocks * bm * bn`` floats, and the block that arrives last
at a tile (an int counter per tile, kept zeroed) sums the partials in split
order and runs the epilogue, in the same launch (the bf16 CP_WGMMA weight
gradient's splits and WS_WGMMA's are instead one cluster a tile, summed
through distributed shared memory). ``blocks`` is the kernel's grid. Each
rule's docstring says what ``tools/gemm_ceiling.py`` measured of it on the
card. ``mma_sync_f32``, ``mma_sync_bf16`` and
``without_ws`` there switch routes off by element size (``WGMMA_ELEMS``,
``CP_WGMMA_ELEMS``, ``WS_ELEMS``) to force the plans the routes replaced.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

SM_COUNT = 132           # H100 SXM
SM_SMEM = 233_472        # bytes of shared memory an SM gives its blocks (228 KB)
BLOCK_SMEM_RESERVED = 1024   # bytes of it the runtime keeps for each block
BK = 32                  # contraction step of both tiles
BIG, SMALL, WIDE, TALL, HALF, ROWS = 0, 1, 2, 3, 4, 5
TILES = {BIG: (128, 128), SMALL: (64, 64), WIDE: (128, 256), TALL: (128, 64), HALF: (64, 128),
         ROWS: (64, 136)}
STAGES = {BIG: 3, SMALL: 4}   # depth of the cp.async ring
MMA_SYNC, WGMMA, CP_WGMMA, WS_WGMMA = 0, 1, 2, 3
# the profiler's counter of the operations (2·M·N·K a product) each route
# forms, added where the route is chosen; the library's products (cuBLAS,
# and every product on the CPU) count in LIBRARY_FLOPS
ROUTE_FLOPS = {MMA_SYNC: "gemm.flops.mma_sync", WGMMA: "gemm.flops.wgmma",
               CP_WGMMA: "gemm.flops.cp_wgmma", WS_WGMMA: "gemm.flops.ws_wgmma"}
LIBRARY_FLOPS = "gemm.flops.library"
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
CP_WGRAD_TILE = SMALL    # the bf16 CP_WGMMA weight gradient's column tile (Out > 136)
CP_WGRAD_ROWS = 136      # the widest Out its ROWS tile spans (wgmma's N)
CP_WGRAD_STAGES = {SMALL: 3, ROWS: 4}   # its rings (csrc/sgd_fused.cu CpWgrad*)
CP_WGRAD_MAX_CLUSTER = 6   # splits of one tile, one cluster, at most (cp_wgrad_splits)
WS_ELEMS = (4,)          # element sizes with a WS_WGMMA route (f32)
DGRAD_ELEMS = (4,)       # element sizes with a dgrad route (f32; dgrad_plan)
# the fewest BIG tiles the dgrad route takes: its two consumer warpgroups
# share each tile (Cooperative), so a block of one tile idles neither, and
# a grid of one wave loses only the SMs it leaves empty, taken where that
# is at most 1/16 of them (128 tiles leave 4 of 132, as the production
# grid's two waves of 256 tiles leave 8 slots of 264)
ONE_WAVE_MIN = -(-15 * SM_COUNT // 16)
WS_ROWS_WIDTHS = (136,)  # Out rounded up to 8 that the WS weight gradient is built for
WS_ROWS_STAGES = 4       # its ring (168 KB, and 51 KB of raw e rows: one block an SM)
WS_MAX_SPLITS = 6        # a WS tile's splits are one cluster (ws_splits)
WS_SPLIT_COST = 0.5      # BK steps a WS split adds to the cluster's reduction
SMALL_PER_SM = 3         # SMALL blocks an SM holds (f32: 72 KB, <= 168 registers a thread)
MIN_K_STEPS = 4          # BK steps a split keeps at least
MAX_SPLITS = 16
BLOCK_COST = {4: 3, 2: 9}   # a block's fixed cost in BK steps, by element size


class Plan(NamedTuple):
    tile: int            # a key of TILES
    bm: int
    bn: int
    splits: int          # 1: no split-K
    k_chunk: int         # rows of the contraction per split
    a_bytes: int         # copy width of A: 16, 8, 4 or (2-byte elements) 2
    b_bytes: int         # copy width of B
    route: int           # MMA_SYNC, WGMMA, CP_WGMMA or WS_WGMMA
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


def cp_wgrad_smem_bytes(tile: int, stages: int = 0) -> int:
    """Dynamic shared memory of a bf16 CP_WGMMA weight-gradient block
    (``SMEM_BYTES`` of its ``CpWgradTile``): ``stages`` stages (by default
    ``CP_WGRAD_STAGES``) of x's 64 k-lines of 64 In and e's bn columns in
    boxes of 64 (the ROWS tile's 136 in three), the ROWS tile's ``stages -
    2`` raw slots of ``CP_BK`` rows of e, 1024 bytes of slack to align the
    ring."""
    bm, bn = TILES[tile]
    stages = stages or CP_WGRAD_STAGES[tile]
    raw = (stages - 2) * CP_BK * bn * 2 if tile == ROWS else 0
    return stages * (bm * 128 + _cdiv(bn, 64) * 64 * 128) + raw + 1024


def cp_wgrad_tile(N: int, a_pitch: int, b_pitch: int, a_ptr: int, b_ptr: int,
                  out_ptrs=()):
    """The tile of the bf16 CP_WGMMA weight gradient g = x^T e (x's pitch
    ``a_pitch`` In, e's ``b_pitch`` = N = Out), or None where the route
    cannot take it: x's rows and every base but e's in whole 4-byte units;
    ``ROWS`` where one tile spans Out (``CP_WGRAD_ROWS``) and e's base is
    16-byte aligned (a stage of whole rows is one run copied 16 bytes at a
    time: e's 270-byte rows at Out = 135), else ``CP_WGRAD_TILE`` where e's
    rows and base are whole 4-byte units too."""
    if not (a_pitch % 2 == 0 and all(p % 4 == 0 for p in (a_ptr, *out_ptrs))):
        return None
    if N <= CP_WGRAD_ROWS and b_ptr % 16 == 0:
        return ROWS
    if b_pitch % 2 == 0 and b_ptr % 4 == 0:
        return CP_WGRAD_TILE
    return None


def cp_wgrad_splits(M: int, N: int, K: int, tile: int) -> int:
    """Splits of the bf16 CP_WGMMA weight gradient (In = M, Out = N, the
    bunch K) on ``tile``: K cut into the most splits whose blocks still fit
    one wave of as many blocks an SM as their shared memory allows, two
    CP_BK steps a split at least, at most ``CP_WGRAD_MAX_CLUSTER``: a
    tile's splits are one cluster. ``tools/gemm_ceiling.py --small
    --bf16-wgrad`` measured every split at MLP3's two weights (f32 v, alone
    by events, NVIDIA H100 80GB HBM3, 700 W): 960x598->1024 on 64x64 tiles
    as clusters fastest at 3 (15.76-15.89 us; 2: 17.40-17.48, 4:
    19.37-19.48); 960x1024->135 on the ROWS tile as clusters 11.70-11.77 us
    at 5 splits of 3 steps (6 forced gives the same 5; 4: 13.61-13.72),
    19.15-19.25 at 8 of 2 in a first build (16 clusters of 8 blocks of 135
    KB do not fit one wave); mma.sync 20.71-20.79 and 14.57-14.71. Builds
    since removed lost there: split-K by tickets through scratch (17.13-17.19
    at 3 splits and 16.41-17.02 at 5) and 64x128 column tiles (19.93-20.11
    at 4 splits as clusters, 23.95-23.98 at 3 by tickets, both spilling at
    three blocks' 168 registers)."""
    tiles, steps = tile_count(M, N, tile), _cdiv(K, CP_BK)
    per_sm = SM_SMEM // (cp_wgrad_smem_bytes(tile) + BLOCK_SMEM_RESERVED)
    splits = 1
    while (splits < CP_WGRAD_MAX_CLUSTER and tiles * (splits + 1) <= per_sm * SM_COUNT
           and _cdiv(steps, splits + 1) >= 2):
        splits += 1
    return splits


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


def ws_f32_smem_bytes(nb: int = TILES[ROWS][1], stages: int = WS_ROWS_STAGES) -> int:
    """Dynamic shared memory of a WS_WGMMA block (``SMEM_BYTES`` of its
    ``WsF32Tile``): ``stages`` slots of A's raw ``BK`` k-lines of 64
    columns and B's hi and lo (nb rows of ``BK`` floats), ``stages - 1``
    raw slots of e's rows, a full and an empty barrier a slot, 1024 bytes
    of slack; by default the tile the kernel is built with."""
    b_slot = nb * 4 * BK
    return stages * (4 * BK * 64 + 2 * b_slot) + (stages - 1) * b_slot + 16 * stages + 1024


def cp_f32_keeps_mma_sync(wgrad: bool, b_pitch: int) -> bool:
    """Whether an f32 product the CP_WGMMA route could take stays on
    MMA_SYNC (where ``ws_f32_takes`` does not send it to WS_WGMMA first):
    the weight gradient whose e rows are no whole 8-byte units (an odd Out:
    TIMIT's 39). There e arrives in 4-byte copies, p and v are updated one
    element at a time, and most columns of the last 64-wide tiles are
    empty; ``tools/gemm_ceiling.py --small --f32`` measured the CP_WGMMA
    kernel at 960x1024->135 slower than mma.sync under every split (its
    plan's 5: 32.64-33.30 us against 17.67-18.08, NVIDIA H100 80GB HBM3,
    700 W)."""
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
    960x1024->135, which goes to WS_WGMMA, 5)."""
    tiles, steps = tile_count(M, N, SMALL), _cdiv(K, BK)

    def cost(s):
        waves = _cdiv(_cdiv(tiles * s, SM_COUNT), CP_F32_PER_SM)
        return waves * (steps / s + BLOCK_COST[4])

    return min(range(1, max(1, min(MAX_SPLITS, steps // MIN_K_STEPS)) + 1),
               key=lambda s: (cost(s), s))


def cp_fixed(M: int, N: int, K: int, tile: int, splits: int, a_bytes: int,
             b_bytes: int, elem: int = 2, route: int = CP_WGMMA) -> Plan:
    """The CP_WGMMA (or ``route``'s) plan of an (M, K) x (K, N) product on
    ``tile`` with K cut into ``splits`` chunks of whole steps (``CP_BK`` for
    bf16, ``BK`` for f32; fewer where K has fewer steps) and the given copy
    widths."""
    step = CP_BK if elem == 2 else BK
    k_chunk = _cdiv(_cdiv(K, step), splits) * step if splits > 1 else K
    n = _cdiv(K, k_chunk)
    return Plan(tile, *TILES[tile], n, k_chunk if n > 1 else K, a_bytes, b_bytes, route,
                tile_count(M, N, tile) * n)


def ws_splits(M: int, N: int, K: int) -> int:
    """Splits of a WS_WGMMA product (In = M, Out = N, the bunch K) on the
    ``ROWS`` tile: the fewest of the least ``W * (steps / S +
    BLOCK_COST[4])`` BK steps for ``W = ceil(tiles * S / SM_COUNT)`` waves
    of one block an SM, plus, split, a block's fixed cost for the
    cluster's stash and barriers and ``WS_SPLIT_COST`` a split for the
    partials each block reads; at most ``WS_MAX_SPLITS``, and
    ``MIN_K_STEPS`` steps a split at least. ``tools/gemm_ceiling.py --small
    --f32 --ws`` measured every split at 960x1024->135 (NVIDIA H100 80GB
    HBM3, 700 W): fastest at 6 (14.35-14.43 us; 5: 15.67-15.82, 4:
    18.72-18.94, 3: 21.90-22.18, 8: 23.02-23.03, its 16 clusters of 8
    blocks of 225 KB not all resident at once)."""
    tiles, steps = tile_count(M, N, ROWS), _cdiv(K, BK)

    def cost(s):
        return (_cdiv(tiles * s, SM_COUNT) * (steps / s + BLOCK_COST[4])
                + ((BLOCK_COST[4] + s * WS_SPLIT_COST) if s > 1 else 0))

    return min(range(1, max(1, min(WS_MAX_SPLITS, steps // MIN_K_STEPS)) + 1),
               key=lambda s: (cost(s), s))


def ws_rows_e_bytes(out: int, e_ptr: int) -> int:
    """The copy width of e in the WS weight gradient: one ROWS tile spans
    every column, so a stage is ``BK`` whole rows, one run of memory that
    starts at a multiple of 128 bytes from e's base, which alone decides."""
    return copy_bytes(BK * out, e_ptr)


def ws_rows_width(out: int) -> int:
    """The N width of the WS weight gradient for ``out`` outputs: ``out``
    rounded up to a multiple of 8, wgmma's N step for TF32."""
    return _cdiv(out, 8) * 8


def ws_f32_takes(M: int, N: int, K: int, wgrad: bool, b_pitch: int) -> bool:
    """Whether an f32 product goes to the WS_WGMMA route: the weight
    gradient of an odd Out whose N width (``ws_rows_width``) the kernel is
    built for, MLP3's 960x1024->135, in place of mma.sync; no forward (the
    kernel has none: a forward on the ring lost to the CP_WGMMA loop at
    every recipe shape, PERF.md). At 960x1024->135, 6 splits (NVIDIA H100
    80GB HBM3, 700 W), the kernel as built (232 registers a thread) ran
    14.31-14.44 and 14.51-14.56 us alone (two runs) against mma.sync's
    18.05, 18.21 and cuBLAS's (addmm_ + add_) 20.30-20.78
    (``tools/gemm_ceiling.py --small --f32 --ws``), and 14.99 in turns
    with cuBLAS against mma.sync's 19.97 and cuBLAS's 17.83, alone 13.39
    against mma.sync's 17.18 (chip_smoke.py phase 3). A first
    build that also carried column tiles for Out > 136 (255 registers)
    only tied mma.sync alone (17.58-17.82 against 17.64-17.85 over four
    runs) and led it in turns (18.66, 18.77 against 19.93, 19.92)."""
    return wgrad and b_pitch % 2 == 1 and ws_rows_width(N) in WS_ROWS_WIDTHS


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
    if elem == 2 and wgrad and elem in CP_WGMMA_ELEMS:   # x on wgmma's M, e on its N
        tile = cp_wgrad_tile(N, a_pitch, b_pitch, a_ptr, b_ptr, out_ptrs)
        if tile is not None:
            return cp_fixed(M, N, K, tile, cp_wgrad_splits(M, N, K, tile),
                            copy_bytes(a_pitch, a_ptr, 2),
                            16 if tile == ROWS else copy_bytes(b_pitch, b_ptr, 2))
    if (elem in WS_ELEMS and tile_count(M, N, BIG) < SM_COUNT
            and all(p % 4 == 0 for p in (a_ptr, b_ptr, *out_ptrs))
            and ws_f32_takes(M, N, K, wgrad, b_pitch)):   # Out on wgmma's N
        return cp_fixed(M, N, K, ROWS, ws_splits(M, N, K), copy_bytes(a_pitch, a_ptr),
                        ws_rows_e_bytes(N, b_ptr), elem, WS_WGMMA)
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


def dgrad_plan(M: int, In: int, Out: int, dz_ptr: int = 0, w_ptr: int = 0, out_ptrs=(),
               elem: int = 4) -> Optional[Plan]:
    """The plan of the input gradient ``dx = dz W^T`` of a layer In -> Out
    at a bunch of M rows (dz (M, Out), W (In, Out), dx (M, In), row-major,
    ``elem`` bytes an element) on the f32 WGMMA route (``csrc/dgrad.cu``:
    ``dx^T = W dz^T`` on the persistent grid of 128x128 tiles, W read
    K-major, dz split into hi and lo by a pre-pass), or None where
    ``torch.matmul`` forms it. The route takes an element size in
    ``DGRAD_ELEMS`` and ``WGMMA_ELEMS``, pitches (Out for dz, W and the
    split copies, In for dx) of 16-byte multiples, 16-byte aligned operands
    and outputs (``out_ptrs``), and a grid of 128x128 tiles of dx^T that
    needs two waves or more, or fills one wave but for at most 1/16 of the
    SMs (``ONE_WAVE_MIN`` tiles): the production stack's 1024x4096->4096
    and 4096->8192 layers (256 tiles), the SWB CD-DNN's 1024x2048->2048 and
    2048->9304 and a 2x2 mesh rank's 512 rows of the production stack (128
    tiles, one a block); not MLP3's or TIMIT's widths, their mesh rank's
    rows, a tmpe utterance's, the RBM recipe's 64 tiles or any bf16 step."""
    if min(M, In, Out) < 1 or elem not in DGRAD_ELEMS:
        return None
    tiles = tile_count(In, M, BIG)
    if not (wgmma_route(elem, (Out, In), (dz_ptr, w_ptr, *out_ptrs))
            and tiles >= ONE_WAVE_MIN):
        return None
    return Plan(BIG, *TILES[BIG], 1, Out, 16, 16, WGMMA, min(tiles, SM_COUNT))

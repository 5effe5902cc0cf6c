"""What holds the GEMM main loops back: the kernels beside variants of them.

    python -m nnet_asr_torch.tools.gemm_ceiling [--reps N] [--small [--f32 | --bf16-wgrad]]
    python -m nnet_asr_torch.tools.gemm_ceiling --dgrad [--reps N]

Builds ``csrc/`` twelve times, each into its own directory under
``build/gemm_ceiling/``, and times, with f32 operands on both routes (the
f32 WGMMA route, and the MMA_SYNC one that serves every other f32 shape),
``matmul_act`` (no activation) at 1024x4096->4096 and with the sigmoid at
1024x1024->4096, and ``wgrad_momentum_update`` at 1024x4096->8192 (f32
velocity) and, on the WGMMA route, ->4096 and 1024x1024->4096; with bf16
operands on the WGMMA route ``matmul_act`` with the sigmoid and without at
1024x4096->4096, with it at 1024x1024->4096, and the wgrad at
1024x4096->8192 and ->4096 (f32 velocity), with each build, in turns, by
CUDA events (a sleep kernel first, so that the host queues every call
before the device starts and short kernels are timed by the device
alone):

  3xtf32              the kernels as they are;
  3pass_nosplit       the same three mma.sync per tile with the raw f32 bits
                      as both hi and lo (no split work; the results are
                      wrong): the tensor-core issue of the 3xTF32 main loop;
  1pass               one mma.sync per tile, no split: plain one-pass TF32
                      (three decimal digits; not f32-accurate);
  f32_wgmma_mainloop  the f32 WGMMA kernels with their epilogues compiled
                      but never run (no y, p or v written; the results are
                      wrong): the pre-pass, TMA, the ring, the register
                      split and wgmma;
  f32_wgmma_1pass     one wgmma (hi * hi) a k8 step in place of three:
                      one-pass TF32, the issue ceiling of the main loop
                      (not f32-accurate);
  f32_wgmma_nosplit   the A fragments' raw f32 bits as hi and lo (no
                      register split; the results are wrong): the split's
                      cost;
  f32_wgmma_prepass   the pre-pass alone (the GEMM not launched; y, p and v
                      not written);
  f32_wgmma_a_fastest the persistent grid walking the tiles with A's
                      columns fastest (every column of W or e in flight) in
                      place of groups of 8 rows of tiles along B;
  f32_wgmma_ss        the kernels as they are, plus a candidate design the
                      port does not take (``gemm_ceiling_ss.cu``, the
                      forward only): W, too, split and transposed by a
                      pre-pass, both operands read by wgmma from shared
                      memory (SS), 3 stages of 64 KB;
  wgmma_mainloop      the bf16 WGMMA-route kernels with their epilogues
                      compiled but never run (no y, p or v written; the
                      results are wrong; with the epilogue deleted, ptxas
                      may drop the wgmma whose results nothing reads):
                      TMA, the ring and wgmma alone;
  wgmma_wgrad_r4      the bf16 wgrad's epilogue with 4 rows a warp in flight
                      in place of 8;
  wgmma_ieee_sigmoid  matmul_act bf16's sigmoid by expf and an IEEE divide in
                      place of __expf and __fdividef.

With ``--small`` it times the SMALL route instead, at the recipes' shapes
(``SMALL_CASES``: the f32 forward at TIMIT's 1024x368->500, one tmpe
utterance's 284x598->1024, MLP3's 960x598->1024 and a 2x2 mesh rank's
480x598->1024; the bf16 forward and both weight gradients of MLP3), each
beside its library yardstick (addmm + sigmoid_; addmm_ with beta + add_;
bf16 x.T @ e + the f32 update passes) in the same turn, with each build and
plan of ``SMALL_VARIANTS``:

  small                   the kernels and plan as they are: the f32 forward
                          on 8 warps of 32x16, the rest on 4 of 32x32,
                          split-K where it shortens the busiest SM's time
                          (tile_plan.split_count);
  small_no_copy8          the SMALL tiles without their 8-byte copy path
                          (f32 rows of 598 take 4-byte copies);
  small_no_split_code     the SMALL tiles without the split-K reduction
                          compiled in, and no split-K;
  small_f32_forward_4w    the f32 forward on 4 warps of 32x32 too;
  small_nosplit           no split-K (the plan's MAX_SPLITS at 1);
  small_split_two_per_sm  split-K until the SMALL grid has two blocks an SM.

Then, with the bf16 forward at the four recipe shapes of ``BF16_SHAPES``
(MLP3's 960x598->1024, TIMIT's 1024x368->500, one tmpe utterance's
284x598->1024, a 2x2 mesh rank's 480x598->1024), it times the candidate
designs of the CP_WGMMA route against each other and against the library
call (bf16 addmm + sigmoid_), in two turns, with each build of
``CP_VARIANTS`` (the kernel compiled with one tile, ``CpPlanned`` of
matmul_act.cu):

  library                 bf16 addmm + sigmoid_;
  mma.sync                the MMA_SYNC kernel (the route it replaces,
                          forced: ``mma_sync_bf16``);
  plan                    the CP_WGMMA kernel as ``tile_plan.plan`` picks;
  cp BMxBN/S              the build's tile with S splits, forced;
  prepass+cp16            x (at 598) or W (at 500) copied by a pre-pass into
                          16-byte-pitched scratch (``F.pad``; y back into
                          place by a second copy at 500), then the CP_WGMMA
                          kernel with 16-byte copies of every operand, on
                          the plan's split;
  prepass+tma             the same pre-pass, then the WGMMA route's TMA
                          kernel (128x256 tiles);

and the builds: ``cp`` the kernels as they are (64x64, a 3-stage ring;
every candidate above), ``cp_ring4`` and ``cp_ring6`` that tile with 4- and
6-stage rings, ``cp_mainloop`` its epilogue compiled but never run (y not
written; the results are wrong), ``cp_64x128`` (one warpgroup),
``cp_128x64`` and ``cp_128x128`` (two) with 4-stage rings (these with the
plan and the ``cp`` candidates of their own tile).

Last, with f32 operands at the shapes of ``F32_SHAPES`` (the forward at
MLP3's 960x598->1024, TIMIT's 1024x368->500, a 2x2 mesh rank's
480x598->1024, one tmpe utterance's 284x598->1024 and the RBM recipe's
960x1024->1024; the wgrad at MLP3's 960x598->1024 and 960x1024->135, f32
velocity), the candidate designs of the f32 CP_WGMMA route
(``csrc/cp_tf32_wgmma.cuh``), in two turns (``gemm_ceiling f32 ...``
lines), with each build of ``CP_F32_VARIANTS`` (``CpF32Planned`` of
cp_tf32_wgmma.cuh swapped):

  library                 addmm + sigmoid_; addmm_ with beta + add_;
  mma.sync                the MMA_SYNC kernel (the route it replaces,
                          forced: ``mma_sync_f32``);
  plan                    the f32 CP_WGMMA kernel as ``tile_plan.plan``
                          picks;
  cp BMxBN/S              the build's tile with S splits, forced;
  prepass+cp              (the ``cp_f32_prepass`` build only) the f32
                          WGMMA route's pre-pass, x split (and for the
                          wgrad transposed)
                          into hi and lo in device memory by a first
                          kernel, then the loop copying both by cp.async
                          (``gemm_ceiling_cp_pre.cu``; the plan's split);

and the builds: ``cp_f32`` the kernels as they are (64 rows of x by 128
columns of W or e on two warpgroups, a 4-stage ring), ``cp_f32_ring5``
and ``cp_f32_ring6`` that tile with 5- and 6-stage rings,
``cp_f32_mainloop`` its epilogues compiled but never run (y, p and v not
written; the results are wrong), ``cp_f32_64x64`` (one warpgroup) and
``cp_f32_128x64`` (one warpgroup of 128 x rows), with 4-stage rings (these
with the plan and the ``cp`` candidates of their own tile),
``cp_f32_prepass``, and three that take the loop apart (the results of
the first two are wrong): ``cp_f32_1pass`` (one TF32 pass, hi * hi, in
place of three), ``cp_f32_nosplit`` (x used raw, no split in the block),
``cp_f32_acc2`` (odd k8 steps into a second accumulator chain, added after
the loop), and ``cp_f32_3blk`` (64x64 with registers capped for three
blocks an SM). ``--small --f32`` times these alone.

With ``--small --bf16-wgrad`` it times the bf16 CP_WGMMA weight gradient
(``cp_wgmma.cuh`` ``wgrad_mainloop``) alone, in two turns (``gemm_ceiling
cpw ...`` lines), at MLP3's 960x598->1024 and 960x1024->135 (f32 v): the
library (bf16 ``x.T @ e``, then the f32 update passes), mma.sync forced
(``mma_sync_bf16``), the plan, and the plan's tile with each split forced,
with each build of ``cpw_variants`` (as built, the ROWS tile on a 5-stage
ring; the update or the realignment of e's rows cut out); ``--builds``
picks some.

With ``--small --f32 --ws`` it times the WS_WGMMA route (the
warp-specialised ring of ``csrc/cp_tf32_wgmma.cuh``) instead, in two
turns (``gemm_ceiling ws ...`` lines): the weight gradient at
960x1024->135 on the plan's split and each split forced, beside (the
``ws`` build) the route it had before (mma.sync), the f32 CP_WGMMA
kernel forced and the library, with each build of ``WS_VARIANTS``: ``ws``
the kernel as it is (a 4-slot ring), ``ws_rows_ring3`` with 3,
``ws_batch2`` its epilogue with 2 slots a thread in flight in place of 4,
``ws_mainloop`` the split epilogue compiled but never run. With ``--turns`` (before or without
``--ws``) it times the kernels PERF.md lists as slower in turns with the
library than alone after each kind of preceding kernel (``turns``).

With ``--dgrad`` it builds ``csrc/`` once and times the f32 input
gradient ``dgrad`` on its WGMMA kernel (``csrc/dgrad.cu``) at
``DGRAD_CASES`` (the production stack's two shapes, the SWB CD-DNN's two
one-wave ones, a 2x2 mesh rank's 512 rows) beside cuBLAS's FFMA product
(``torch.matmul``, the route it replaced): each against float64, then,
over three rounds, the kernel (its pre-pass and GEMM apart) and the
library in turns by the profiler, and each alone by CUDA events, beside
the bound (operations at 165 TFLOP/s).

For f32 on MMA_SYNC, the gap between the first two is the hi/lo split's
cost, the second against the 3xTF32 bound what mma.sync's issue rate
allows; on WGMMA, the variants split the kernel's time into the pre-pass,
the epilogue, the register split and the wgmma issue. For
bf16, the kernel's time less the main loop's is what its epilogue adds
(bias, sigmoid and y's TMA stores; the p and v update, which the wgrad's
ping-pong schedule overlaps with the other consumer's main loop). Needs
the card and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import math
import os
import shutil
import subprocess
import sys

import torch

from ..ops.kernels import _build
from ..ops.kernels import matmul_act as MA
from ..ops.kernels import sgd_fused as SF

SPLIT = "  hi = rna_tf32(x);\n  lo = rna_tf32(x - __uint_as_float(hi));"
RAW = "  hi = __float_as_uint(x);\n  lo = hi;"
MMA3 = ("        mma_tf32(acc[i][j], alo[i], bhi);\n"
        "        mma_tf32(acc[i][j], ahi[i], blo);\n"
        "        mma_tf32(acc[i][j], ahi[i], bhi);")
MMA1 = "        mma_tf32(acc[i][j], ahi[i], bhi);"
# the WGMMA-route kernels' epilogue calls, and the wgrad epilogue's chunk
STORE_Y = "    store_y_tile(s, &ty, bias, wg - 1, m0, n0, act, acc);"
UPDATE_PV = "      update_tile(gs, p, v, a, m, In, Out, m0, n0, acc0, acc1);"
ROWS8 = "  constexpr int R = 8;"
ROWS4 = "  constexpr int R = 4;"
FAST_SIGMOID = "__fdividef(1.0f, 1.0f + __expf(-z{}))"
IEEE_SIGMOID = "1.0f / (1.0f + expf(-z{}))"
# the f32 WGMMA route's epilogue calls, its lo terms, its register split,
# and its GEMM launches
F32_STORE_Y = "                     store_y_f32(b, y, M, N, n0, m0, act, acc0, acc1);\n"
F32_UPDATE = "                     update_tile_f32(p, v, a, m, In, Out, out0, in0, acc0, acc1);\n"
LO_TERMS = ("      wgmma_m64n128k8_rs(acc0, fh0 + 4, dh);    // lo * hi\n"
            "      wgmma_m64n128k8_rs(acc1, fh0 + 12, dh);\n"
            "      wgmma_m64n128k8_rs(acc0, fh0, dl);        // hi * lo\n"
            "      wgmma_m64n128k8_rs(acc1, fh0 + 8, dl);\n")
REG_SPLIT = "  nnet_tile::split_tf32("
RAW_SPLIT = "  raw_tf32("
LOAD_FRAGS = "__device__ __forceinline__ void load_frags("
RAW_DEF = ("__device__ __forceinline__ void raw_tf32(float x, uint32_t& hi, uint32_t& lo) {\n"
           "  hi = lo = __float_as_uint(x);\n}\n\n")
F32_FWD_LAUNCH = ("  matmul_act_f32_wgmma_kernel<<<blocks, W::THREADS, T::S::SMEM_BYTES, s>>>"
                  "(tw, txh, txl, b, y, M,\n"
                  "                                                                           "
                  "N, K, act);\n")
F32_WGRAD_LAUNCH = ("  wgrad_momentum_f32_wgmma_kernel<V><<<blocks, W::THREADS, T::S::SMEM_BYTES, "
                    "stream>>>(\n      te, txh, txl, p, v, a, m, B, In, Out);\n")
GROUP_B = "constexpr int GROUP_B = 8;"
# variant: [(file in csrc/, text, replacement)]
VARIANTS = {"3xtf32": [], "3pass_nosplit": [("tile_gemm.cuh", SPLIT, RAW)],
            "1pass": [("tile_gemm.cuh", SPLIT, RAW), ("tile_gemm.cuh", MMA3, MMA1)],
            "wgmma_mainloop": [("matmul_act.cu", STORE_Y, f"    if (act < 0)\n  {STORE_Y}"),
                               ("sgd_fused.cu", UPDATE_PV, f"      if (In < 0)\n  {UPDATE_PV}")],
            "wgmma_wgrad_r4": [("sgd_fused.cu", ROWS8, ROWS4)],
            "wgmma_ieee_sigmoid": [("matmul_act.cu", FAST_SIGMOID.format(i), IEEE_SIGMOID.format(i))
                                   for i in (0, 1)],
            "f32_wgmma_mainloop": [("matmul_act.cu", F32_STORE_Y, f"if (act < 0) {{\n{F32_STORE_Y}}}\n"),
                                   ("sgd_fused.cu", F32_UPDATE, f"if (In < 0) {{\n{F32_UPDATE}}}\n")],
            "f32_wgmma_1pass": [("tf32_wgmma.cuh", LO_TERMS, "")],
            "f32_wgmma_nosplit": [("tf32_wgmma.cuh", LOAD_FRAGS, RAW_DEF + LOAD_FRAGS),
                                  ("tf32_wgmma.cuh", REG_SPLIT, RAW_SPLIT)],
            "f32_wgmma_prepass": [("matmul_act.cu", F32_FWD_LAUNCH, ""),
                                  ("sgd_fused.cu", F32_WGRAD_LAUNCH, "")],
            "f32_wgmma_a_fastest": [("tf32_wgmma.cuh", GROUP_B, GROUP_B.replace("8", "1"))],
            "f32_wgmma_ss": []}
# sources compiled beside csrc/ in a build: the SS candidate design
EXTRA = {"f32_wgmma_ss": [os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       "gemm_ceiling_ss.cu")]}
SS_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


@contextlib.contextmanager
def _without(elem):
    """The WGMMA and CP_WGMMA routes' element sizes without ``elem`` while
    inside."""
    from ..ops.kernels import tile_plan

    saved = tile_plan.WGMMA_ELEMS, tile_plan.CP_WGMMA_ELEMS, tile_plan.WS_ELEMS
    tile_plan.WGMMA_ELEMS = tuple(e for e in saved[0] if e != elem)
    tile_plan.CP_WGMMA_ELEMS = tuple(e for e in saved[1] if e != elem)
    tile_plan.WS_ELEMS = tuple(e for e in saved[2] if e != elem)
    try:
        yield
    finally:
        tile_plan.WGMMA_ELEMS, tile_plan.CP_WGMMA_ELEMS, tile_plan.WS_ELEMS = saved


def mma_sync_f32():
    """Every f32 GEMM on the MMA_SYNC route while inside (both wgmma
    routes' element sizes without 4), the plan every f32 shape had before
    those routes: the mma.sync rows here and in chip_smoke.py, at the
    production shapes and at the recipes'."""
    return _without(4)


@contextlib.contextmanager
def library_dgrad():
    """Every f32 input gradient on ``torch.matmul`` (cuBLAS) while inside,
    as before its WGMMA kernel (``tile_plan.DGRAD_ELEMS`` without 4); the
    other routes stay as they are."""
    from ..ops.kernels import tile_plan

    saved = tile_plan.DGRAD_ELEMS
    tile_plan.DGRAD_ELEMS = ()
    try:
        yield
    finally:
        tile_plan.DGRAD_ELEMS = saved


@contextlib.contextmanager
def without_ws():
    """Every f32 GEMM off the WS_WGMMA route while inside, on the route it
    had before that one: the f32 CP_WGMMA route, or MMA_SYNC for the weight
    gradient of an odd Out (``tile_plan.cp_f32_keeps_mma_sync``)."""
    from ..ops.kernels import tile_plan

    saved = tile_plan.WS_ELEMS
    tile_plan.WS_ELEMS = ()
    try:
        yield
    finally:
        tile_plan.WS_ELEMS = saved


@contextlib.contextmanager
def mma_sync_bf16():
    """Every bf16 forward and weight gradient off the CP_WGMMA route while
    inside (the route's element sizes without 2), as before that route: the
    mma.sync rows of the recipes' bf16 shapes here and in chip_smoke.py."""
    from ..ops.kernels import tile_plan

    saved = tile_plan.CP_WGMMA_ELEMS
    tile_plan.CP_WGMMA_ELEMS = tuple(e for e in saved if e != 2)
    try:
        yield
    finally:
        tile_plan.CP_WGMMA_ELEMS = saved


F32_FORWARD_TILE = "std::is_same<E, float>::value, SmallTile8, SmallTile>"


def split_two_per_sm(tiles, steps, elem=4):
    """The split rule tried first: cut K until the SMALL grid has two
    blocks an SM, at least MIN_K_STEPS steps a split."""
    from ..ops.kernels import tile_plan as tp

    if tiles >= 2 * tp.SM_COUNT:
        return 1
    return min(-(-2 * tp.SM_COUNT // tiles), tp.MAX_SPLITS, max(1, steps // tp.MIN_K_STEPS))


COPY8 = ("  } else if (COPY8 && bytes == 8) {\n    if constexpr (COPY8)\n"
         "      copy_runs<8, E, ROWS, COLS, SP, THREADS>(s, g, ld, r0, c0, rows_end, cols_end);\n"
         "  } else if")
SPLIT_CODE = "  if constexpr (!T::SMALL) {\n    return true;"
# name: (text substitutions, tile_plan attributes set while it is timed)
SMALL_VARIANTS = {
    "small": ([], {}),
    "small_no_copy8": ([("tile_gemm.cuh", COPY8, "  } else if")], {}),
    "small_no_split_code": ([("tile_gemm.cuh", SPLIT_CODE, SPLIT_CODE.replace("!T::SMALL", "true"))],
                            {"MAX_SPLITS": 1}),
    "small_f32_forward_4w": ([("matmul_act.cu", F32_FORWARD_TILE,
                               F32_FORWARD_TILE.replace("SmallTile8", "SmallTile"))], {}),
    "small_nosplit": ([], {"MAX_SPLITS": 1}),
    "small_split_two_per_sm": ([], {"split_count": split_two_per_sm})}


BF16_SHAPES = ((960, 598, 1024), (1024, 368, 500), (284, 598, 1024), (480, 598, 1024))
CP_TILE = "using CpPlanned = nnet_cpw::CpTile<1, 64, 3>;"
CP_STORE = "  nnet_cpw::store_y<T>(ring, acc, b, y, M, N, m0, n0, act);"


def _cp_tile(wg, bn, stages):
    return [("matmul_act.cu", CP_TILE, CP_TILE.replace("<1, 64, 3>", f"<{wg}, {bn}, {stages}>"))]


F32_SHAPES = ((960, 598, 1024), (1024, 368, 500), (480, 598, 1024), (284, 598, 1024),
              (960, 1024, 1024))
F32_WGRAD_SHAPES = ((960, 598, 1024), (960, 1024, 135))
CP_F32_TILE = "using CpF32Planned = CpF32Tile<2, 64, 4, MODE>;"
F32_CP_STORE = "  nnet_cpf::store_y<T>(acc, bias, y, M, N, m0, n0, act);"
F32_CP_UPDATE = "  nnet_cpf::update_pv<T, V>(acc, p, v, a, m, In, Out, in0, out0);"
# the f32 CP_WGMMA loop's two lo terms, and its split of x in the block
LO_HI = "        wgmma_k8<T::NB>(d, cur + 8 * kk + 4, dh);   // lo * hi\n"
HI_LO = "        wgmma_k8<T::NB>(d, cur + 8 * kk, dl);       // hi * lo\n"
B_SPLIT = "split_stage<T>(hi_slot(s), lo_slot(s), raw_slot(s));"
PRE_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "gemm_ceiling_cp_pre.cu")
PRE_ARGS = {"matmul_act_f32_cp_pre": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
            + [ctypes.c_void_p] * 3,
            "wgrad_momentum_update_f32_cp_pre": [ctypes.c_void_p] * 8 + [ctypes.c_float] * 2
            + [ctypes.c_int] * 7 + [ctypes.c_void_p]}


def _cp_f32_tile(wg, nb, stages):
    return [("cp_tf32_wgmma.cuh", CP_F32_TILE,
             CP_F32_TILE.replace("<2, 64, 4, MODE>", f"<{wg}, {nb}, {stages}, MODE>"))]


# name: (text substitutions, the tile compiled in, sources beside csrc/)
CP_F32_VARIANTS = {
    "cp_f32": ([], "HALF", ()), "cp_f32_ring5": (_cp_f32_tile(2, 64, 5), "HALF", ()),
    "cp_f32_ring6": (_cp_f32_tile(2, 64, 6), "HALF", ()),
    "cp_f32_mainloop": ([("matmul_act.cu", F32_CP_STORE, f"  if (act < 0)\n{F32_CP_STORE}"),
                         ("sgd_fused.cu", F32_CP_UPDATE, f"  if (In < 0)\n{F32_CP_UPDATE}")],
                        "HALF", ()),
    "cp_f32_64x64": (_cp_f32_tile(1, 64, 4), "SMALL", ()),
    "cp_f32_128x64": (_cp_f32_tile(1, 128, 4), "TALL", ()),
    "cp_f32_prepass": ([], "HALF", (PRE_SOURCE,)),
    "cp_f32_1pass": ([("cp_tf32_wgmma.cuh", LO_HI, ""), ("cp_tf32_wgmma.cuh", HI_LO, "")],
                     "HALF", ()),
    "cp_f32_nosplit": ([("cp_tf32_wgmma.cuh", B_SPLIT, "")], "HALF", ()),
    "cp_f32_acc2": ([("cp_tf32_wgmma.cuh", "constexpr int CHAINS = 1;",
                      "constexpr int CHAINS = 2;")], "HALF", ()),
    "cp_f32_3blk": (_cp_f32_tile(1, 64, 4) + [("cp_tf32_wgmma.cuh", "MIN_BLOCKS = 1;",
                                               "MIN_BLOCKS = 3;")], "SMALL", ())}

WS_ROWS_TILE = "using WsF32Rows = WsF32Tile<136, 4>;"
WS_BATCH = "constexpr int WS_BATCH = 4;"
WS_UPDATE = "    nnet_cpf::ws_update_pv<T, V>(ring, p, v, a, m, In, Out, in0);"

# name: text substitutions of the WS kernel's build
WS_VARIANTS = {
    "ws": [],
    "ws_rows_ring3": [("cp_tf32_wgmma.cuh", WS_ROWS_TILE, WS_ROWS_TILE.replace("4>", "3>"))],
    "ws_batch2": [("cp_tf32_wgmma.cuh", WS_BATCH, WS_BATCH.replace("4", "2"))],
    "ws_mainloop": [("sgd_fused.cu", WS_UPDATE, f"    if (In < 0)\n  {WS_UPDATE}")],
}

CPW_ROWS = "using CpWgradRows = nnet_cpw::CpWgradTile<136, 4>;"
CPW_SHAPES = ((960, 598, 1024), (960, 1024, 135))
CPW_UPDATE = ("  cp_update<T, V>(st, splits, p, v, a, m, In, Out, m0, n0, lo, "
              "min(chunks, lo + per));")
CPW_REALIGN = ("realign_rows<T>(stage(0) + T::A_BYTES, raw(0), Out);",
               "realign_rows<T>(stage(kt + 1) + T::A_BYTES, raw(kt + 1), Out);")


def cpw_variants():
    """name: (text substitutions, tile_plan attributes while it is timed) of
    the bf16 CP_WGMMA weight gradient's builds: ``cpw`` as built (64x64
    column tiles on 3 stages, the ROWS tile on 4), ``cpw_rows_ring5`` the
    ROWS tile on 5 stages; and two that take the kernel apart (their
    results are wrong): ``cpw_mainloop`` the cluster's update compiled but
    never run (the loop, the stash and the cluster's barriers),
    ``cpw_norealign`` the ROWS tile's realignment of e's stage cut (the run
    copies still land)."""
    from ..ops.kernels import tile_plan as tp

    return {"cpw": ([], {}),
            "cpw_rows_ring5": ([("sgd_fused.cu", CPW_ROWS, CPW_ROWS.replace("4>", "5>"))],
                               {"CP_WGRAD_STAGES": {**tp.CP_WGRAD_STAGES, tp.ROWS: 5}}),
            "cpw_mainloop": ([("sgd_fused.cu", CPW_UPDATE, f"  if (In < 0)\n  {CPW_UPDATE}")],
                             {}),
            "cpw_norealign": ([("cp_wgmma.cuh", line, "") for line in CPW_REALIGN], {})}


# name: (text substitutions, the tile compiled in)
CP_VARIANTS = {"cp": ([], "SMALL"), "cp_ring4": (_cp_tile(1, 64, 4), "SMALL"),
               "cp_ring6": (_cp_tile(1, 64, 6), "SMALL"),
               "cp_mainloop": ([("matmul_act.cu", CP_STORE, f"  if (act < 0)\n{CP_STORE}")],
                               "SMALL"),
               "cp_64x128": (_cp_tile(1, 128, 4), "HALF"),
               "cp_128x64": (_cp_tile(2, 64, 4), "TALL"),
               "cp_128x128": (_cp_tile(2, 128, 4), "BIG")}


def bf16_candidates(dev, tile_name):
    """(shape, library, [(candidate, fn)]) at each of BF16_SHAPES for a
    build whose kernel has the tile ``tile_name`` of tile_plan: with the
    planned tile every candidate, else the plan's split and each forced
    split on that tile."""
    import torch.nn.functional as F

    from ..ops.kernels import tile_plan as tp

    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream(dev)
    out = []
    for M, K, N in BF16_SHAPES:
        x = torch.randn((M, K), generator=gen, device=dev).to(bf)
        w = (torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)).to(bf)
        b = torch.randn((N,), generator=gen, device=dev).to(bf)
        y = torch.empty((M, N), dtype=bf, device=dev)
        plan = tp.plan(M, N, K, K, N, x.data_ptr(), w.data_ptr(), elem=2,
                       out_ptrs=(y.data_ptr(),))

        def cp(p, x=x, w=w, b=b, y=y):
            return lambda: MA._launch_cp_wgmma(_build.load_library(), x, w, b, y, "sigmoid", p,
                                               stream)

        def on_mma_sync(x=x, w=w, b=b):
            with mma_sync_bf16():
                MA.matmul_act(x, w, b, "sigmoid")

        tile = getattr(tp, tile_name)
        bm, bn = tp.TILES[tile]
        cands = [("plan", cp(tp.cp_fixed(M, N, K, tile, plan.splits, plan.a_bytes,
                                         plan.b_bytes)))]
        for splits in (1, 2, 3, 4):
            cands.append((f"cp {bm}x{bn}/{splits}",
                          cp(tp.cp_fixed(M, N, K, tile, splits, plan.a_bytes, plan.b_bytes))))
        if tile != plan.tile:
            out.append((f"{M}x{K}->{N}", lambda x=x, w=w, b=b: torch.addmm(b, x, w).sigmoid_(),
                        cands))
            continue
        cands.insert(0, ("mma.sync", on_mma_sync))
        if K % 8:   # x's rows to 16-byte pitch; W's rows past K are zero
            Kp = -(-K // 8) * 8
            wp = F.pad(w, (0, 0, 0, Kp - K))
            p16 = tp.cp_fixed(M, N, Kp, plan.tile, plan.splits, 16, 16)

            def pre_cp(x=x, wp=wp, b=b, y=y, p16=p16, Kp=Kp):
                xp = F.pad(x, (0, Kp - x.shape[1]))
                MA._launch_cp_wgmma(_build.load_library(), xp, wp, b, y, "sigmoid", p16, stream)

            def pre_tma(x=x, wp=wp, b=b, Kp=Kp):
                MA.matmul_act(F.pad(x, (0, Kp - x.shape[1])), wp, b, "sigmoid")
        else:       # W's and y's rows to 16-byte pitch
            Np = -(-N // 8) * 8
            bp_ = F.pad(b, (0, Np - N))
            yp = torch.empty((M, Np), dtype=bf, device=dev)
            p16 = tp.cp_fixed(M, Np, K, plan.tile, plan.splits, 16, 16)

            def pre_cp(x=x, w=w, bp_=bp_, yp=yp, y=y, p16=p16, Np=Np):
                wp = F.pad(w, (0, Np - w.shape[1]))
                MA._launch_cp_wgmma(_build.load_library(), x, wp, bp_, yp, "sigmoid", p16, stream)
                y.copy_(yp[:, :y.shape[1]])

            def pre_tma(x=x, w=w, bp_=bp_, y=y, Np=Np):
                y.copy_(MA.matmul_act(x, F.pad(w, (0, Np - w.shape[1])), bp_,
                                      "sigmoid")[:, :y.shape[1]])
        cands += [("prepass+cp16", pre_cp), ("prepass+tma", pre_tma)]
        out.append((f"{M}x{K}->{N}", lambda x=x, w=w, b=b: torch.addmm(b, x, w).sigmoid_(),
                    cands))
    return out


def small_cases(dev):
    """(name, flops, kernel, library yardstick) at the SMALL route's shapes."""
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    cases = []

    def affine(M, K, N, dt):
        x = torch.randn((M, K), generator=gen, device=dev).to(dt)
        w = (torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)).to(dt)
        b = torch.randn((N,), generator=gen, device=dev).to(dt)
        cases.append((f"affine {'bf16' if dt == bf else 'f32'} {M}x{K}->{N}", 2.0 * M * N * K,
                      lambda: MA.matmul_act(x, w, b, "sigmoid"),
                      lambda: torch.addmm(b, x, w).sigmoid_()))

    def wgrad(B, In, Out, dt):
        x = torch.randn((B, In), generator=gen, device=dev).to(dt)
        e = (torch.randn((B, Out), generator=gen, device=dev) / math.sqrt(B)).to(dt)
        p, v = torch.zeros((In, Out), device=dev), torch.zeros((In, Out), device=dev)
        pl, vl = p.clone(), v.clone()
        if dt == bf:
            def library():
                corr = (x.T @ e).float().add_(vl, alpha=0.9)
                vl.copy_(corr)
                pl.sub_(corr, alpha=1e-3)
        else:
            def library():
                pl.add_(vl.addmm_(x.T, e, beta=0.9), alpha=-1e-3)
        cases.append((f"wgrad {'bf16' if dt == bf else 'f32'} {B}x{In}->{Out}",
                      2.0 * B * In * Out,
                      lambda: SF.wgrad_momentum_update(x, e, p, v, 1e-3, 0.9), library))

    for M, K, N in ((1024, 368, 500), (284, 598, 1024), (960, 598, 1024), (480, 598, 1024)):
        affine(M, K, N, torch.float32)
    for M, K, N in BF16_SHAPES:
        affine(M, K, N, bf)
    for dt in (torch.float32, bf):
        wgrad(960, 598, 1024, dt)
        wgrad(960, 1024, 135, dt)
    return cases


def build_variant(name, subs, root, extra=()):
    """Compile csrc/ with the text substitutions ``subs``, and the sources
    ``extra`` beside it."""
    d = os.path.join(root, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    for src in extra:
        shutil.copy(src, d)
    for fname, old, new in subs:
        path = os.path.join(d, fname)
        with open(path) as f:
            src = f.read()
        if old not in src:
            raise RuntimeError(f"{name}: {fname} no longer holds {old!r}")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    so = os.path.join(d, "lib.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
           *sorted(os.path.join(d, s) for s in os.listdir(d) if s.endswith(".cu"))]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(so):
    lib = ctypes.CDLL(so)
    for fn, argtypes in _build.SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.nnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nnet_cuda_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "matmul_act_f32_wgmma_ss"):
        lib.matmul_act_f32_wgmma_ss.argtypes = SS_ARGS
        lib.matmul_act_f32_wgmma_ss.restype = ctypes.c_int
    for fn, argtypes in PRE_ARGS.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def event_us(fn, reps):
    """Device us a call by CUDA events. A sleep kernel holds the device
    while the host queues every call, so a kernel shorter than its
    wrapper's host time is still timed by the device alone."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)   # ~10 ms at the H100's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gemm_ceiling")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--small", action="store_true",
                    help="time the SMALL route's variants at the recipes' shapes")
    ap.add_argument("--f32", action="store_true",
                    help="with --small, time only the f32 CP_WGMMA candidates")
    ap.add_argument("--builds", default="",
                    help="with --small --f32, the CP_F32_VARIANTS (with --ws: WS_VARIANTS; with "
                         "--small --bf16-wgrad: cpw_variants) to build (comma-separated; "
                         "default all)")
    ap.add_argument("--ws", action="store_true",
                    help="with --small --f32, time the WS_WGMMA candidates (WS_VARIANTS) instead")
    ap.add_argument("--bf16-wgrad", action="store_true",
                    help="with --small, time only the bf16 CP_WGMMA weight gradient's "
                         "candidates (cpw_variants; --builds picks some)")
    ap.add_argument("--turns", action="store_true",
                    help="with --small --f32, first the kernels slower in turns with the library "
                         "than alone, after each prelude (turns())")
    ap.add_argument("--dgrad", action="store_true",
                    help="time the f32 dgrad kernel against cuBLAS at DGRAD_CASES (dgrads())")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_ceiling: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.path.join(os.path.dirname(_build.BUILD_DIR), "gemm_ceiling")
    builds = [b for b in args.builds.split(",") if b]
    if args.dgrad:
        dgrads(args.reps)
        return 0
    if args.small and args.bf16_wgrad:
        cpw_only(root, args.reps, builds)
        return 0
    if args.small and args.f32 and (args.turns or args.ws):
        if args.turns:
            turns(args.reps, turn_libs(root))
        if args.ws:
            ws_only(root, args.reps, builds)
        return 0
    if args.small:
        return small(root, args.reps, args.f32, builds)
    builds = {name: build_variant(name, subs, root, EXTRA.get(name, ()))
              for name, subs in VARIANTS.items()}
    libs = {}
    for name, (so, proc) in builds.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = load(so)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    M, K, N = 1024, 4096, 4096
    x = torch.randn((M, K), generator=gen, device=dev)
    w = torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)
    b = torch.zeros((N,), device=dev)
    B, In, Out = 1024, 4096, 8192
    xs = torch.randn((B, In), generator=gen, device=dev)
    es = torch.randn((B, Out), generator=gen, device=dev) / math.sqrt(B)
    p, v = torch.zeros((In, Out), device=dev), torch.zeros((In, Out), device=dev)
    bf = torch.bfloat16
    xb, wb, bb, xsb, esb = (t.to(bf) for t in (x, w, b, xs, es))
    x1, w1 = x[:, :1024].contiguous(), w[:1024].contiguous()
    xb1, wb1 = xb[:, :1024].contiguous(), wb[:1024].contiguous()
    es4, esb4 = es[:, :4096].contiguous(), esb[:, :4096].contiguous()
    xs1 = xs[:, :1024].contiguous()
    p4, v4 = torch.zeros((In, 4096), device=dev), torch.zeros((In, 4096), device=dev)
    p1, v1 = torch.zeros((1024, 4096), device=dev), torch.zeros((1024, 4096), device=dev)

    def on_mma_sync(fn):
        def call():
            with mma_sync_f32():
                fn()
        return call

    def ss(x, w, b, act):
        """The SS candidate's forward (gemm_ceiling_ss.cu), its scratch
        made once; None where the build has no such entry point."""
        Mx, Kx = x.shape
        Nx = w.shape[1]
        y = torch.empty((Mx, Nx), device=dev)
        xs_, ws_ = torch.empty((2, Mx, Kx), device=dev), torch.empty((2, Nx, Kx), device=dev)
        blocks = min(-(-Mx // 128) * -(-Nx // 128), 132)

        def call():
            lib = _build._lib
            if not hasattr(lib, "matmul_act_f32_wgmma_ss"):
                return None
            _build.check(lib.matmul_act_f32_wgmma_ss(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), xs_[0].data_ptr(),
                xs_[1].data_ptr(), ws_[0].data_ptr(), ws_[1].data_ptr(), Mx, Nx, Kx,
                MA.ACTS[act], blocks, torch.cuda.current_stream().cuda_stream),
                "matmul_act_f32_wgmma_ss")
            return y
        return call

    cases = [(f"matmul_act f32 mma.sync {M}x{K}->{N}", 2.0 * M * N * K,
              on_mma_sync(lambda: MA.matmul_act(x, w, b, "none"))),
             (f"matmul_act f32 wgmma {M}x{K}->{N}", 2.0 * M * N * K,
              lambda: MA.matmul_act(x, w, b, "none")),
             (f"matmul_act f32 mma.sync sigmoid {M}x1024->{N}", 2.0 * M * N * 1024,
              on_mma_sync(lambda: MA.matmul_act(x1, w1, b, "sigmoid"))),
             (f"matmul_act f32 wgmma sigmoid {M}x1024->{N}", 2.0 * M * N * 1024,
              lambda: MA.matmul_act(x1, w1, b, "sigmoid")),
             (f"matmul_act f32 wgmma-ss {M}x{K}->{N}", 2.0 * M * N * K, ss(x, w, b, "none")),
             (f"matmul_act f32 wgmma-ss sigmoid {M}x1024->{N}", 2.0 * M * N * 1024,
              ss(x1, w1, b, "sigmoid")),
             (f"wgrad_momentum_update f32 mma.sync {B}x{In}->{Out}", 2.0 * B * In * Out,
              on_mma_sync(lambda: SF.wgrad_momentum_update(xs, es, p, v, 0.0, 0.0))),
             (f"wgrad_momentum_update f32 wgmma {B}x{In}->{Out}", 2.0 * B * In * Out,
              lambda: SF.wgrad_momentum_update(xs, es, p, v, 0.0, 0.0)),
             (f"wgrad_momentum_update f32 wgmma {B}x{In}->4096", 2.0 * B * In * 4096,
              lambda: SF.wgrad_momentum_update(xs, es4, p4, v4, 0.0, 0.0)),
             (f"wgrad_momentum_update f32 wgmma {B}x1024->4096", 2.0 * B * 1024 * 4096,
              lambda: SF.wgrad_momentum_update(xs1, es4, p1, v1, 0.0, 0.0)),
             (f"matmul_act bf16 sigmoid {M}x{K}->{N}", 2.0 * M * N * K,
              lambda: MA.matmul_act(xb, wb, bb, "sigmoid")),
             (f"matmul_act bf16 none {M}x{K}->{N}", 2.0 * M * N * K,
              lambda: MA.matmul_act(xb, wb, bb, "none")),
             (f"matmul_act bf16 sigmoid {M}x1024->{N}", 2.0 * M * N * 1024,
              lambda: MA.matmul_act(xb1, wb1, bb, "sigmoid")),
             (f"wgrad_momentum_update bf16 {B}x{In}->{Out}", 2.0 * B * In * Out,
              lambda: SF.wgrad_momentum_update(xsb, esb, p, v, 0.0, 0.0)),
             (f"wgrad_momentum_update bf16 {B}x{In}->4096", 2.0 * B * In * 4096,
              lambda: SF.wgrad_momentum_update(xsb, esb4, p4, v4, 0.0, 0.0))]
    counters = ("matmul_act_bf16_wgmma", "matmul_act_f32_wgmma",
                "wgrad_momentum_update_bf16_wgmma", "wgrad_momentum_update_f32_wgmma")
    before = [_build.LAUNCHES[k] for k in counters]
    saved = _build._lib
    try:
        for turn in range(2):
            for name, lib in (libs.items() if turn == 0 else reversed(libs.items())):
                _build._lib = lib
                row = []
                for what, flops, fn in cases:
                    if "wgmma-ss" in what and not hasattr(lib, "matmul_act_f32_wgmma_ss"):
                        continue
                    us = event_us(fn, args.reps)
                    row.append(f"{what} {us:.1f} us ({flops / us / 1e6:.1f} TFLOP/s)")
                print(f"gemm_ceiling turn {turn} {name}: " + "; ".join(row), flush=True)
        # the SS candidate against the kernel: the same y
        _build._lib = libs["f32_wgmma_ss"]
        for (what, _, fn), (_, _, ref) in ((cases[4], cases[1]), (cases[5], cases[3])):
            y_ss, y_ref = fn(), ref()
            torch.cuda.synchronize()
            print(f"gemm_ceiling {what}: max |y - the kernel's| "
                  f"{(y_ss - y_ref).abs().max().item():.3e}")
    finally:
        _build._lib = saved
    if any(_build.LAUNCHES[k] == n for k, n in zip(counters, before)):
        raise RuntimeError("a WGMMA route was not taken by its cases")
    return 0


def small(root, reps, f32_only=False, f32_builds=()) -> int:
    """Time SMALL_VARIANTS at small_cases' shapes, in two turns, then the
    bf16 and the f32 CP_WGMMA designs; with ``f32_only`` the f32 designs
    alone, with the builds of CP_F32_VARIANTS named in ``f32_builds`` (all
    if empty)."""
    from ..ops.kernels import tile_plan

    builds, libs = {}, {}
    f32_variants = {n: v for n, v in CP_F32_VARIANTS.items() if not f32_builds or n in f32_builds}
    variants = [] if f32_only else [(n, v[0], ()) for n, v in [*SMALL_VARIANTS.items(),
                                                              *CP_VARIANTS.items()]]
    variants += [(n, v[0], v[2]) for n, v in f32_variants.items()]
    for name, subs, extra in variants:
        key = repr((subs, extra))
        if key not in builds:
            builds[key] = build_variant(name, subs, root, extra)
    for key, (so, proc) in builds.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas [{os.path.basename(os.path.dirname(so))}] "
                      f"{line.split(':', 1)[-1].strip()}")
        libs[key] = load(so)
    if f32_only:
        saved = _build._lib
        try:
            f32_designs(libs, reps, f32_variants)
        finally:
            _build._lib = saved
        return 0
    cases = small_cases(torch.device("cuda", 0))
    saved = _build._lib, {k: getattr(tile_plan, k) for _, attrs in SMALL_VARIANTS.values()
                          for k in attrs}
    try:
        for turn in range(2):
            order = list(SMALL_VARIANTS.items())
            for name, (subs, attrs) in (order if turn == 0 else reversed(order)):
                _build._lib = libs[repr((subs, ()))]
                for k, v in {**saved[1], **attrs}.items():
                    setattr(tile_plan, k, v)
                row = []
                for what, flops, kernel, library in cases:
                    us, lib_us = event_us(kernel, reps), event_us(library, reps)
                    row.append(f"{what} {us:.2f} us (library {lib_us:.2f} us)")
                print(f"gemm_ceiling small turn {turn} {name}: " + "; ".join(row), flush=True)
        for k, v in saved[1].items():
            setattr(tile_plan, k, v)
        bf16_designs(libs, reps)
        f32_designs(libs, reps, f32_variants)
    finally:
        _build._lib = saved[0]
        for k, v in saved[1].items():
            setattr(tile_plan, k, v)
    return 0


def ws_only(root, reps, names=()) -> None:
    """Build the WS_VARIANTS named in ``names`` (all if empty), in parallel,
    and time them (ws_designs)."""
    variants = {n: v for n, v in WS_VARIANTS.items() if not names or n in names}
    libs = {}
    for name, subs in variants.items():
        libs[repr((subs, ()))] = build_variant(name, subs, root)
    for key, (so, proc) in libs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out}")
        for line in out.splitlines():
            if ("registers" in line or "spill" in line
                    or ("Compiling entry" in line and "ws_wgmma" in line)):
                print(f"  ptxas [{os.path.basename(os.path.dirname(so))}] "
                      f"{line.split(':', 1)[-1].strip()}")
        libs[key] = load(so)
    saved = _build._lib
    try:
        ws_designs(libs, reps, variants)
    finally:
        _build._lib = saved


def cpw_candidates(dev):
    """(shape, library, [(candidate, fn)]) of the bf16 weight gradient at
    CPW_SHAPES, f32 velocity, under the tile_plan attributes in force: the
    library (bf16 x.T @ e, then the f32 update passes), mma.sync (the route
    the CP_WGMMA one replaced, forced: ``mma_sync_bf16``), the plan, and
    the plan's tile with 1 to ``CP_WGRAD_MAX_CLUSTER`` splits forced."""
    from ..ops.kernels import tile_plan as tp

    gen = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream(dev)
    out = []
    for B, In, Out in CPW_SHAPES:
        x = torch.randn((B, In), generator=gen, device=dev).to(bf)
        e = (torch.randn((B, Out), generator=gen, device=dev) / math.sqrt(B)).to(bf)
        p, v = torch.zeros((In, Out), device=dev), torch.zeros((In, Out), device=dev)
        pl_, vl = p.clone(), v.clone()
        plan = tp.plan(In, Out, B, In, Out, x.data_ptr(), e.data_ptr(), wgrad=True, elem=2,
                       out_ptrs=(p.data_ptr(), v.data_ptr()))
        assert plan.route == tp.CP_WGMMA

        def cpw(q, x=x, e=e, p=p, v=v):
            return lambda: SF._launch_bf16_cp_wgmma(_build._lib, x, e, p, v, 1e-3, 0.9, q,
                                                    stream)

        def on_mma_sync(x=x, e=e, p=p, v=v):
            with mma_sync_bf16():
                SF.wgrad_momentum_update(x, e, p, v, 1e-3, 0.9)

        def library(x=x, e=e, pl_=pl_, vl=vl):
            corr = (x.T @ e).float().add_(vl, alpha=0.9)
            vl.copy_(corr)
            pl_.sub_(corr, alpha=1e-3)

        bm, bn = tp.TILES[plan.tile]
        cands = [("mma.sync", on_mma_sync), ("plan", cpw(plan))]
        cands += [(f"cpw {bm}x{bn}/{k}", cpw(tp.cp_fixed(In, Out, B, plan.tile, k, plan.a_bytes,
                                                          plan.b_bytes)))
                  for k in range(1, tp.CP_WGRAD_MAX_CLUSTER + 1)]
        out.append((f"wgrad {B}x{In}->{Out}", library, cands))
    return out


def cpw_only(root, reps, names=()) -> None:
    """Build the cpw_variants named in ``names`` (all if empty), in
    parallel, and time cpw_candidates with each, in two turns (each
    candidate in a window of its own calls, beside the library's); print
    each candidate's range over the turns."""
    from ..ops.kernels import tile_plan as tp

    variants = {n: v for n, v in cpw_variants().items() if not names or n in names}
    procs = {name: build_variant(name, subs, root) for name, (subs, _) in variants.items()}
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out}")
        for line in out.splitlines():
            if ("registers" in line or "spill" in line
                    or ("Compiling entry" in line and "bf16_cp_wgmma" in line)):
                print(f"  ptxas [{name}] {line.split(':', 1)[-1].strip()}")
        libs[name] = load(so)
    dev = torch.device("cuda", 0)
    saved = _build._lib, {k: getattr(tp, k) for _, attrs in variants.values() for k in attrs}
    before = _build.LAUNCHES["wgrad_momentum_update_bf16_cp_wgmma"]
    seen = {}
    try:
        for turn in range(2):
            order = list(variants.items())
            for name, (_, attrs) in (order if turn == 0 else reversed(order)):
                _build._lib = libs[name]
                for k, val in {**saved[1], **attrs}.items():
                    setattr(tp, k, val)
                for shape, library, cands in cpw_candidates(dev):
                    lib_us = event_us(library, reps)
                    seen.setdefault((name, shape, "library"), []).append(lib_us)
                    row = [f"library {lib_us:.2f}"]
                    for what, fn in (cands if turn == 0 else reversed(cands)):
                        us = event_us(fn, reps)
                        seen.setdefault((name, shape, what), []).append(us)
                        row.append(f"{what} {us:.2f}")
                    print(f"gemm_ceiling cpw turn {turn} {name} {shape}: " + "; ".join(row),
                          flush=True)
    finally:
        _build._lib = saved[0]
        for k, val in saved[1].items():
            setattr(tp, k, val)
    for (name, shape, what), us in seen.items():
        print(f"gemm_ceiling cpw {name} {shape} {what}: {min(us):.2f}-{max(us):.2f} us")
    if _build.LAUNCHES["wgrad_momentum_update_bf16_cp_wgmma"] == before:
        raise RuntimeError("the bf16 CP_WGMMA weight gradient was not taken by its candidates")


def bf16_designs(libs, reps) -> None:
    """Time bf16_candidates with each build of CP_VARIANTS, in two turns,
    and print each candidate's range over the turns beside the library's."""
    dev = torch.device("cuda", 0)
    shapes = {tile: bf16_candidates(dev, tile) for _, tile in CP_VARIANTS.values()}
    before = _build.LAUNCHES["matmul_act_bf16_cp_wgmma"]
    seen = {}
    for turn in range(2):
        order = list(CP_VARIANTS.items())
        for name, (subs, tile) in (order if turn == 0 else reversed(order)):
            _build._lib = libs[repr((subs, ()))]
            for shape, library, cands in shapes[tile]:
                lib_us = event_us(library, reps)
                seen.setdefault((name, shape, "library"), []).append(lib_us)
                row = [f"library {lib_us:.2f}"]
                for what, fn in (cands if turn == 0 else reversed(cands)):
                    us = event_us(fn, reps)
                    seen.setdefault((name, shape, what), []).append(us)
                    row.append(f"{what} {us:.2f}")
                print(f"gemm_ceiling bf16 turn {turn} {name} {shape}: " + "; ".join(row),
                      flush=True)
    for (name, shape, what), us in seen.items():
        print(f"gemm_ceiling bf16 {name} {shape} {what}: {min(us):.2f}-{max(us):.2f} us")
    if _build.LAUNCHES["matmul_act_bf16_cp_wgmma"] == before:
        raise RuntimeError("the CP_WGMMA route was not taken by its candidates")


def f32_candidates(dev, tile_name, prepass):
    """(shape, library, [(candidate, fn)]) at each of F32_SHAPES (the
    forward) and F32_WGRAD_SHAPES (the wgrad, f32 v) for a build whose f32
    CP_WGMMA kernels have the tile ``tile_name`` of tile_plan: the plan's
    split and each forced split on that tile; with the planned tile
    (``CP_F32_TILE``) also mma.sync forced and, in the pre-pass build,
    ``prepass+cp``. At a shape the plan keeps on MMA_SYNC (960x1024->135)
    "plan" is the plan the route would take there."""
    from ..ops.kernels import tile_plan as tp

    gen = torch.Generator(device=dev).manual_seed(2)
    stream = torch.cuda.current_stream(dev)
    tile = getattr(tp, tile_name)
    bm, bn = tp.TILES[tile]
    out = []
    for M, K, N in F32_SHAPES:
        x = torch.randn((M, K), generator=gen, device=dev)
        w = torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)
        b = torch.randn((N,), generator=gen, device=dev)
        y = torch.empty((M, N), device=dev)
        plan = tp.plan(M, N, K, K, N, x.data_ptr(), w.data_ptr(), out_ptrs=(y.data_ptr(),))
        assert plan.route == tp.CP_WGMMA

        def cp(p, x=x, w=w, b=b, y=y):
            return lambda: MA._launch_cp_wgmma(_build._lib, x, w, b, y, "sigmoid", p, stream)

        cands = [("plan", cp(tp.cp_fixed(M, N, K, tile, plan.splits, plan.a_bytes,
                                         plan.b_bytes, elem=4)))]
        cands += [(f"cp {bm}x{bn}/{s}", cp(tp.cp_fixed(M, N, K, tile, s, plan.a_bytes,
                                                       plan.b_bytes, elem=4)))
                  for s in (1, 2, 3, 4)]
        if tile == tp.CP_F32_TILE:
            def on_mma_sync(x=x, w=w, b=b):
                with mma_sync_f32():
                    MA.matmul_act(x, w, b, "sigmoid")

            cands.insert(0, ("mma.sync", on_mma_sync))
        if prepass:
            xs = torch.empty((2, M, K), device=dev)

            def pre(x=x, w=w, b=b, y=y, xs=xs, plan=plan):
                _scratch, split = _build.split_args(plan, dev, stream)
                _build.check(_build._lib.matmul_act_f32_cp_pre(
                    x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), xs[0].data_ptr(),
                    xs[1].data_ptr(), x.shape[0], w.shape[1], x.shape[1], 1,
                    tp.copy_bytes(x.shape[1], xs[0].data_ptr()), plan.b_bytes, *split,
                    stream.cuda_stream), "matmul_act_f32_cp_pre")

            cands.append(("prepass+cp", pre))
        out.append((f"affine {M}x{K}->{N}", lambda x=x, w=w, b=b: torch.addmm(b, x, w).sigmoid_(),
                    cands))
    for B, In, Out in F32_WGRAD_SHAPES:
        x = torch.randn((B, In), generator=gen, device=dev)
        e = torch.randn((B, Out), generator=gen, device=dev) / math.sqrt(B)
        p, v = torch.zeros((In, Out), device=dev), torch.zeros((In, Out), device=dev)
        pl_, vl = p.clone(), v.clone()
        plan = tp.plan(In, Out, B, In, Out, x.data_ptr(), e.data_ptr(), wgrad=True,
                       out_ptrs=(p.data_ptr(), v.data_ptr()))
        if plan.route != tp.CP_WGMMA:   # an odd Out, off the route: the plan it would take
            assert tp.cp_f32_keeps_mma_sync(True, Out)
            plan = tp.cp_fixed(In, Out, B, tp.CP_F32_TILE, tp.cp_f32_splits(In, Out, B),
                               tp.copy_bytes(In, x.data_ptr()), tp.copy_bytes(Out, e.data_ptr()),
                               elem=4)

        def cpw(q, x=x, e=e, p=p, v=v):
            return lambda: SF._launch_f32_cp_wgmma(_build._lib, x, e, p, v, 1e-3, 0.9, q, stream)

        cands = [("plan", cpw(tp.cp_fixed(In, Out, B, tile, plan.splits, plan.a_bytes,
                                          plan.b_bytes, elem=4)))]
        cands += [(f"cp {bm}x{bn}/{s}", cpw(tp.cp_fixed(In, Out, B, tile, s, plan.a_bytes,
                                                        plan.b_bytes, elem=4)))
                  for s in (1, 2, 3, 4, 5, 6)]
        if tile == tp.CP_F32_TILE:
            def wg_mma_sync(x=x, e=e, p=p, v=v):
                with mma_sync_f32():
                    SF.wgrad_momentum_update(x, e, p, v, 1e-3, 0.9)

            cands.insert(0, ("mma.sync", wg_mma_sync))
        if prepass:
            xs = torch.empty((2, In, B), device=dev)

            def wpre(x=x, e=e, p=p, v=v, xs=xs, plan=plan):
                _scratch, split = _build.split_args(plan, dev, stream)
                _build.check(_build._lib.wgrad_momentum_update_f32_cp_pre(
                    x.data_ptr(), e.data_ptr(), p.data_ptr(), v.data_ptr(), xs[0].data_ptr(),
                    xs[1].data_ptr(), split[2], split[3], 1e-3, 0.9, x.shape[0], x.shape[1],
                    e.shape[1], split[0], split[1], tp.copy_bytes(x.shape[0], xs[0].data_ptr()),
                    plan.b_bytes, stream.cuda_stream), "wgrad_momentum_update_f32_cp_pre")

            cands.append(("prepass+cp", wpre))
        out.append((f"wgrad {B}x{In}->{Out}",
                    lambda x=x, e=e, pl_=pl_, vl=vl: pl_.add_(vl.addmm_(x.T, e, beta=0.9),
                                                              alpha=-1e-3), cands))
    return out


def f32_designs(libs, reps, variants) -> None:
    """Time f32_candidates with each build of ``variants`` (of
    CP_F32_VARIANTS), in two turns, and print each candidate's range over
    the turns beside the library's."""
    dev = torch.device("cuda", 0)
    builds = {name: (libs[repr((subs, extra))], tile, bool(extra))
              for name, (subs, tile, extra) in variants.items()}
    shapes = {name: f32_candidates(dev, tile, pre) for name, (_, tile, pre) in builds.items()}
    counters = ("matmul_act_f32_cp_wgmma", "wgrad_momentum_update_f32_cp_wgmma")
    before = [_build.LAUNCHES[k] for k in counters]
    seen = {}
    for turn in range(2):
        order = list(builds.items())
        for name, (lib, _, _) in (order if turn == 0 else reversed(order)):
            _build._lib = lib
            for shape, library, cands in shapes[name]:
                lib_us = event_us(library, reps)
                seen.setdefault((name, shape, "library"), []).append(lib_us)
                row = [f"library {lib_us:.2f}"]
                for what, fn in (cands if turn == 0 else reversed(cands)):
                    us = event_us(fn, reps)
                    seen.setdefault((name, shape, what), []).append(us)
                    row.append(f"{what} {us:.2f}")
                print(f"gemm_ceiling f32 turn {turn} {name} {shape}: " + "; ".join(row),
                      flush=True)
    for (name, shape, what), us in seen.items():
        print(f"gemm_ceiling f32 {name} {shape} {what}: {min(us):.2f}-{max(us):.2f} us")
    if [_build.LAUNCHES[k] for k in counters] == before:
        raise RuntimeError("the f32 CP_WGMMA route was not taken by its candidates")


def ws_candidates(dev, full):
    """(shape, library, [(candidate, fn)]) for a build of the WS kernel: at
    960x1024->135 the WS weight gradient under ``tile_plan.ws_splits``
    ("ws") and 2 to 8 splits forced. With ``full``, beside them the route
    it had before WS_WGMMA ("mma.sync") and the CP_WGMMA kernel forced."""
    from ..ops.kernels import tile_plan as tp

    gen = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream(dev)
    B, In, Out = 960, 1024, 135
    x = torch.randn((B, In), generator=gen, device=dev)
    e = torch.randn((B, Out), generator=gen, device=dev) / math.sqrt(B)
    p, v = torch.zeros((In, Out), device=dev), torch.zeros((In, Out), device=dev)
    pl_, vl = p.clone(), v.clone()
    ab, bb = tp.copy_bytes(In, x.data_ptr()), tp.ws_rows_e_bytes(Out, e.data_ptr())

    def wsw(q):
        return lambda: SF._launch_f32_ws_wgmma(_build._lib, x, e, p, v, 1e-3, 0.9, q, stream)

    cands = [("ws", wsw(tp.cp_fixed(In, Out, B, tp.ROWS, tp.ws_splits(In, Out, B), ab, bb, 4,
                                    tp.WS_WGMMA)))]
    cands += [(f"ws {s}", wsw(tp.cp_fixed(In, Out, B, tp.ROWS, s, ab, bb, 4, tp.WS_WGMMA)))
              for s in (2, 3, 4, 5, 6, 8)]
    if full:
        def replaced():
            with without_ws():
                SF.wgrad_momentum_update(x, e, p, v, 1e-3, 0.9)

        cpq = tp.cp_fixed(In, Out, B, tp.CP_F32_TILE, tp.cp_f32_splits(In, Out, B), ab,
                          tp.copy_bytes(Out, e.data_ptr()), elem=4)
        cands += [("mma.sync", replaced),
                  ("cp", lambda: SF._launch_f32_cp_wgmma(_build._lib, x, e, p, v, 1e-3, 0.9,
                                                         cpq, stream))]
    return [(f"wgrad {B}x{In}->{Out}",
             lambda: pl_.add_(vl.addmm_(x.T, e, beta=0.9), alpha=-1e-3), cands)]


def ws_designs(libs, reps, variants) -> None:
    """Time ws_candidates with each build of ``variants`` (of WS_VARIANTS),
    in two turns (each candidate in a window of its own calls, beside the
    library's), and print each candidate's range over the turns."""
    dev = torch.device("cuda", 0)
    shapes = {name: ws_candidates(dev, name == "ws") for name in variants}
    before = _build.LAUNCHES["wgrad_momentum_update_f32_ws_wgmma"]
    seen = {}
    for turn in range(2):
        order = list(variants.items())
        for name, subs in (order if turn == 0 else reversed(order)):
            _build._lib = libs[repr((subs, ()))]
            for shape, library, cands in shapes[name]:
                lib_us = event_us(library, reps)
                seen.setdefault((name, shape, "library"), []).append(lib_us)
                row = [f"library {lib_us:.2f}"]
                for what, fn in (cands if turn == 0 else reversed(cands)):
                    us = event_us(fn, reps)
                    seen.setdefault((name, shape, what), []).append(us)
                    row.append(f"{what} {us:.2f}")
                print(f"gemm_ceiling ws turn {turn} {name} {shape}: " + "; ".join(row),
                      flush=True)
    for (name, shape, what), us in seen.items():
        print(f"gemm_ceiling ws {name} {shape} {what}: {min(us):.2f}-{max(us):.2f} us")
    if _build.LAUNCHES["wgrad_momentum_update_f32_ws_wgmma"] == before:
        raise RuntimeError("the WS_WGMMA route was not taken by its candidates")


def profiled_us(fns, pattern, reps):
    """Device us a call of the kernels whose name matches ``pattern``, by
    torch.profiler over ``reps`` rounds of ``fns`` called in order (after a
    warm-up round of the same); None where the profiler recorded none."""
    import re

    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a window with no device time at all is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for fn in fns:
                    fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
        if rows:
            mine = [e for e in rows if re.search(pattern, e.key)]
            total = sum(e.self_device_time_total for e in mine)
            return total / reps if total else None
    return None


CARVEOUT = "  return static_cast<int>(cudaFuncSetAttribute(\n      kernel, cudaFuncAttributeMax"
# the builds turns() times each window with, in turns: the kernels as they
# are (tile_gemm.cuh allow_smem sets no shared-memory carveout: CUDA picks
# one a kernel), and asking for the largest carveout, as cuBLAS's GEMMs run
# with
TURN_BUILDS = {"as built": [],
               "carveout max": [("tile_gemm.cuh", CARVEOUT,
                                 "  cudaFuncSetAttribute(kernel, "
                                 "cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n"
                                 + CARVEOUT)]}


def turn_libs(root):
    """TURN_BUILDS built in parallel and loaded: {name: lib}."""
    procs = {name: build_variant(f"turns_{i}", subs, root)
             for i, (name, subs) in enumerate(TURN_BUILDS.items())}
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = load(so)
    return libs


def events_us(fns, reps):
    """Device us a round of ``fns`` called in order, by CUDA events over
    ``reps`` rounds queued behind a sleep kernel (event_us's method)."""
    return event_us(lambda: [fn() for fn in fns], reps)


def turns(reps, libs, rounds=3) -> None:
    """Where a kernel that runs alone at t us runs slower in turns with its
    library call (chip_smoke.py phase 3's windows): each kernel of
    ``TURNS_CASES``, on its plan's route, timed by the profiler (device us
    a call) after each prelude: none (alone), the library call, its cuBLAS
    GEMM alone, a cuBLAS GEMM of 64x64 floats (shared memory in use, next
    to nothing in L2), a 4 KB elementwise pass, 256 MB written (L2
    flushed); then alone and after the library with one split forced and,
    on the CP_WGMMA route, with its split-K scratch held from call to call
    (no torch.empty a call); the library alone and after the kernel; the 4
    KB pass alone (the floor of a launch); and by CUDA events, the kernel
    alone, the library alone and the two in turns, whose difference is what
    the kernel adds to the pair. Each window with each build of ``libs``
    ({name: lib}, turn_libs), ``rounds`` times, builds and windows in
    rotation; each line the range over the rounds."""
    from ..ops.kernels import tile_plan as tp

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    small = torch.randn((1024,), generator=gen, device=dev)
    tiny = torch.randn((64, 64), generator=gen, device=dev)
    big = torch.empty(FLUSH_FLOATS, device=dev)
    saved = _build._lib
    try:
        for what, M, K, N, wgrad in TURNS_CASES:
            _turn_case(reps, rounds, libs, what, M, K, N, wgrad, tp, dev, stream, gen, small,
                       tiny, big)
    finally:
        _build._lib = saved


def _turn_case(reps, rounds, libs, what, M, K, N, wgrad, tp, dev, stream, gen, small, tiny,
               big) -> None:
    if wgrad:
        B, In, Out = M, K, N
        x = torch.randn((B, In), generator=gen, device=dev)
        e = torch.randn((B, Out), generator=gen, device=dev) / math.sqrt(B)
        p, v = torch.zeros((In, Out), device=dev), torch.zeros((In, Out), device=dev)
        pl_, vl = p.clone(), v.clone()
        plan = tp.plan(In, Out, B, In, Out, x.data_ptr(), e.data_ptr(), wgrad=True,
                       out_ptrs=(p.data_ptr(), v.data_ptr()))
        one = tp.cp_fixed(In, Out, B, plan.tile, 1, plan.a_bytes, plan.b_bytes, 4, plan.route)
        launch = {tp.CP_WGMMA: SF._launch_f32_cp_wgmma, tp.WS_WGMMA: SF._launch_f32_ws_wgmma}

        def kernel(q=plan):
            launch[q.route](_build._lib, x, e, p, v, 1e-3, 0.9, q, stream)

        def library():
            pl_.add_(vl.addmm_(x.T, e, beta=0.9), alpha=-1e-3)

        def cublas():
            vl.addmm_(x.T, e, beta=0.9)

        name = "wgrad_momentum"
        held = torch.empty(plan.blocks * plan.bm * plan.bn, device=dev)

        def kernel_held(q=plan):
            _build.check(_build._lib.wgrad_momentum_update_f32_cp_wgmma(
                x.data_ptr(), e.data_ptr(), p.data_ptr(), v.data_ptr(), held.data_ptr(),
                _build.counters(dev, stream).data_ptr(), 1e-3, 0.9, B, In, Out, 0,
                q.splits, q.k_chunk, q.a_bytes, q.b_bytes, stream.cuda_stream), "held")
    else:
        x = torch.randn((M, K), generator=gen, device=dev)
        w = torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)
        b = torch.randn((N,), generator=gen, device=dev)
        y = torch.empty((M, N), device=dev)
        plan = tp.plan(M, N, K, K, N, x.data_ptr(), w.data_ptr(), out_ptrs=(y.data_ptr(),))
        one = tp.cp_fixed(M, N, K, plan.tile, 1, plan.a_bytes, plan.b_bytes, 4, plan.route)
        def kernel(q=plan):
            MA._launch_cp_wgmma(_build._lib, x, w, b, y, "sigmoid", q, stream)

        def library():
            torch.addmm(b, x, w).sigmoid_()

        def cublas():
            torch.addmm(b, x, w)

        name = "matmul_act"
        held = torch.empty(plan.blocks * plan.bm * plan.bn, device=dev)

        def kernel_held(q=plan):
            _build.check(_build._lib.matmul_act_f32_cp_wgmma(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), M, N, K, 1,
                q.a_bytes, q.b_bytes, q.splits, q.k_chunk, held.data_ptr(),
                _build.counters(dev, stream).data_ptr(), stream.cuda_stream), "held")

    windows = {"alone": ([kernel], name), "after the library": ([library, kernel], name),
               "after its cuBLAS GEMM alone": ([cublas, kernel], name),
               "after a 64x64 cuBLAS GEMM": ([lambda: tiny @ tiny, kernel], name),
               "after a 4 KB elementwise pass": ([lambda: small.sigmoid_(), kernel], name),
               "after 256 MB written": ([lambda: big.fill_(1.0), kernel], name),
               "1 split, alone": ([lambda: kernel(one)], name),
               "1 split, after the library": ([library, lambda: kernel(one)], name),
               "library alone": ([library], NOT_OURS),
               "library after the kernel": ([kernel, library], NOT_OURS),
               "4 KB elementwise pass alone": ([lambda: small.sigmoid_()], NOT_OURS)}
    if plan.route == tp.CP_WGMMA and plan.splits > 1:
        windows["after the library, scratch held"] = ([library, kernel_held], name)
    timed = {"events: kernel alone": [kernel], "events: library alone": [library],
             "events: library + kernel": [library, kernel]}
    share = "events: the kernel's share of the pair"
    seen = {}
    builds = list(libs)
    for r in range(rounds):
        for build in builds[r % len(builds):] + builds[:r % len(builds)]:
            _build._lib = libs[build]
            order = list(windows.items())
            for label, (fns, pattern) in order[r % len(order):] + order[:r % len(order)]:
                us = profiled_us(fns, pattern, reps)
                if us is not None:
                    seen.setdefault((build, label), []).append(us)
            for label, fns in timed.items():
                seen.setdefault((build, label), []).append(events_us(fns, reps))
            seen.setdefault((build, share), []).append(
                seen[(build, "events: library + kernel")][-1]
                - seen[(build, "events: library alone")][-1])
    print(f"gemm_ceiling turns {what}: plan route {plan.route}, {plan.bm}x{plan.bn}, "
          f"{plan.splits} splits", flush=True)
    for build in builds:
        for label in [*windows, *timed, share]:
            us = seen.get((build, label))
            rng = "not measured" if not us else f"{min(us):.2f}-{max(us):.2f} us"
            print(f"gemm_ceiling turns [{build}] {what} {label}: {rng}", flush=True)


def dgrads(reps, rounds=3) -> None:
    """``--dgrad``: at each of ``DGRAD_CASES`` the f32 ``dgrad`` on its
    plan (which must be the WGMMA route) against a float64 product, beside
    ``torch.matmul``'s; then ``rounds`` rounds of the two in turns by the
    profiler (device us a call: the kernel's pre-pass and GEMM, the
    library's GEMM) and each alone by CUDA events; each line the range over
    the rounds, beside the bound."""
    from ..ops.kernels import tile_plan as tp

    _build.load_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    for what, B, In, Out in DGRAD_CASES:
        dz = torch.randn((B, Out), generator=gen, device=dev) / math.sqrt(Out)
        w = torch.randn((In, Out), generator=gen, device=dev)
        plan = tp.dgrad_plan(B, In, Out, dz.data_ptr(), w.data_ptr())
        if plan is None or plan.route != tp.WGMMA:
            raise RuntimeError(f"dgrad {what}: the plan leaves it to the library")
        before = _build.LAUNCHES["dgrad_f32_wgmma"]

        def kernel():
            MA.dgrad(dz, w)

        def library():
            torch.matmul(dz, w.T)

        ref = dz.double() @ w.double().T
        scale = ref.abs().max().item()
        errs = [((t.double() - ref).abs().max().item() / scale)
                for t in (MA.dgrad(dz, w), torch.matmul(dz, w.T))]
        del ref
        windows = {"kernel in turns": ([library, kernel], "dgrad_f32_"),
                   "its pre-pass in turns": ([library, kernel], "dgrad_f32_split"),
                   "its GEMM in turns": ([library, kernel], "dgrad_f32_wgmma_kernel"),
                   "library in turns": ([kernel, library], "^(?!.*dgrad_f32_)")}
        seen = {}
        for r in range(rounds):
            for label, (fns, pattern) in windows.items():
                us = profiled_us(fns, pattern, reps)
                if us is not None:
                    seen.setdefault(label, []).append(us)
            seen.setdefault("kernel alone (events)", []).append(event_us(kernel, reps))
            seen.setdefault("library alone (events)", []).append(event_us(library, reps))
        if _build.LAUNCHES["dgrad_f32_wgmma"] == before:
            raise RuntimeError(f"dgrad {what}: the kernel was not launched")
        bound = 2.0 * B * In * Out / 165e12 * 1e6
        # the pre-pass's own bound: dz read, its hi and lo written
        split_bound = 12.0 * B * Out / 3.35e12 * 1e6
        print(f"gemm_ceiling dgrad {what}: plan {plan.blocks} blocks of {plan.bm}x{plan.bn}, "
              f"{tp.tile_count(In, B, tp.BIG)} tiles; max |dx - f64| / max {errs[0]:.3e} "
              f"(cuBLAS {errs[1]:.3e}); bound {bound:.2f} us (ops), the pre-pass's "
              f"{split_bound:.2f} us (bytes)", flush=True)
        for label in [*windows, "kernel alone (events)", "library alone (events)"]:
            us = seen.get(label)
            b = split_bound if "pre-pass" in label else bound
            rng = ("not measured" if not us else
                   f"{min(us):.2f}-{max(us):.2f} us = {100 * b / max(us):.1f}-"
                   f"{100 * b / min(us):.1f}% of its bound")
            print(f"gemm_ceiling dgrad {what} {label}: {rng}", flush=True)


# (what, B, In, Out) of dgrads(): the production stack's hidden and output
# layers (two waves of 256 tiles), the SWB CD-DNN's (one wave of 128) and a
# 2x2 mesh rank's 512 rows of the production output layer (128)
DGRAD_CASES = (("production hidden 1024x4096->4096", 1024, 4096, 4096),
               ("production output 1024x4096->8192", 1024, 4096, 8192),
               ("SWB hidden 1024x2048->2048", 1024, 2048, 2048),
               ("SWB output 1024x2048->9304", 1024, 2048, 9304),
               ("mesh rank 512x4096->8192", 512, 4096, 8192))


# (what, M, K, N, wgrad) of turns(): the rows PERF.md lists as slower in
# turns with the library than alone: TIMIT's forward, MLP3's 598->1024
# weight gradient, and the weight gradient of 135 outputs
TURNS_CASES = (("affine 1024x368->500", 1024, 368, 500, False),
               ("wgrad 960x598->1024", 960, 598, 1024, True),
               ("wgrad 960x1024->135", 960, 1024, 135, True))
FLUSH_FLOATS = 64 << 20   # 256 MB written between calls: more than L2 holds
NOT_OURS = "^(?!.*(matmul_act|wgrad_momentum))"   # the library's kernels


if __name__ == "__main__":
    sys.exit(main())

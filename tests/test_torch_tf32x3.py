"""The arithmetic and the launch plan of the tensor-core GEMM kernels, on the CPU.

``csrc/tile_gemm.cuh`` multiplies f32 operands on TF32 tensor cores by
3xTF32: each element is split into hi = rna_tf32(a) and lo = rna_tf32(a - hi)
and the product accumulates lo*hi + hi*lo + hi*hi in f32 per k-step of 8 (the
mma.sync m16n8k8 depth). Here the split is emulated with integer operations
on the f32 bits and the products with f32 matmuls of depth 8; a TF32 product
of two TF32 values is exact in f32, so only the accumulation order differs
from the card. At the production depths (K = 4096 for ``x @ W``, a bunch of
1024 for ``x^T e``) the emulated 3xTF32 result is within the tolerances
``chip_smoke.py`` phase 3 holds the kernels to, against an f64 product, and a
single TF32 pass is not.

The f32 WGMMA route (``csrc/tf32_wgmma.cuh``) keeps that arithmetic with the
operands' roles turned: it computes y^T = W^T x^T and g^T = e^T x, so the
split operand taken first (lo * hi) is W or e, and the emulation at the same
depths holds it to the same tolerances.

The input gradient's kernel (``csrc/dgrad.cu``) computes dx^T = W dz^T on
the same route, W split in registers and taken first; the emulation with
those roles at the production depths (4096 and 8192) holds it to the
tolerance of ``chip_smoke.py`` phase 3's dgrad rows, and one TF32 pass
fails it.

The second half holds ``tile_plan.plan`` to the tile, split, copy path and
route of every shape the main paths launch, every production shape to the
f32 WGMMA route's plan (and to the MMA_SYNC BIG plan where TMA cannot
describe an operand), every SMALL-tile shape to the f32 CP_WGMMA route's
plan (``csrc/cp_tf32_wgmma.cuh``; tests/test_torch_cp_tf32.py holds its
layouts and arithmetic), and the blocks planned per SM, and the WGMMA
tiles, to the shared memory an SM has.
"""

import math

import numpy as np
import pytest
import torch

from nnet_asr_torch.ops.kernels import _build, tile_plan

torch.set_num_threads(2)


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 explicit mantissa bits), to nearest, ties away
    from zero, as cvt.rna.tf32.f32: add half of the 13 dropped bits to the
    magnitude, then clear them (a carry moves into the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def gemm_tf32(a, b, passes, stage=None):
    """a @ b as the kernel's mma sequence: f32 accumulation per depth-8 step
    of lo*hi, hi*lo, hi*hi (passes = 3) or of hi*hi alone (passes = 1);
    with ``stage``, each ``stage``-deep run of steps into a partial of its
    own, added to the sum after it (the dgrad kernel's promotion)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    total = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    acc = torch.zeros_like(total)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        if passes == 3:
            acc = acc + al[:, s] @ bh[s]
            acc = acc + ah[:, s] @ bl[s]
        acc = acc + ah[:, s] @ bh[s]
        if stage is not None and (k + 8) % stage == 0:
            total, acc = total + acc, torch.zeros_like(acc)
    return total + acc


def test_rna_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -12, 65504.0, 2.0 - 2 ** -23], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 1.0,
                         65504.0, 2.0])
    got = rna_tf32(x)
    assert torch.equal(got, want)
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    rng = np.random.default_rng(0)
    r = torch.from_numpy(rng.standard_normal(10000).astype(np.float32))
    hi, lo = split_tf32(r)
    assert (hi - r).abs().div(r.abs()).max().item() <= 2 ** -11
    # hi + lo carries 21 significant bits: within 2^-21 of the f32 value
    assert ((hi.double() + lo.double()) - r.double()).abs().div(r.abs()).max().item() \
        <= 2 ** -21


def _affine_case():
    """x (M, 4096) and W (4096, N) as chip_smoke.py makes them, z = x @ W."""
    rng = np.random.default_rng(1)
    M, K, N = 48, 4096, 40
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, N)) / math.sqrt(K)).astype(np.float32))
    return x, w, x.double() @ w.double()


def _wgrad_case():
    """x (1024, In), e (1024, Out) and v as chip_smoke.py makes them; the
    momentum step's corr = x^T e + 0.9 v."""
    rng = np.random.default_rng(2)
    B, In, Out = 1024, 40, 48
    x = torch.from_numpy(rng.standard_normal((B, In)).astype(np.float32))
    e = torch.from_numpy((rng.standard_normal((B, Out)) / math.sqrt(B)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((In, Out)).astype(np.float32))
    return x, e, v, x.double().T @ e.double() + 0.9 * v.double()


@pytest.mark.parametrize("passes", [3, 1])
def test_affine_at_depth_4096_within_phase3_tolerance_only_with_3xtf32(passes):
    x, w, ref = _affine_case()
    z = gemm_tf32(x, w, passes).double()
    err_z = (z - ref).abs().max().item()
    err_y = (torch.sigmoid(z) - torch.sigmoid(ref)).abs().max().item()
    tol_z = 1e-4 * max(ref.abs().max().item(), 1.0)     # matmul_act "none"
    tol_y = 1e-4                                         # affine_sigmoid y
    if passes == 3:
        assert err_z <= tol_z / 10 and err_y <= tol_y / 10
    else:
        assert err_z > tol_z and err_y > tol_y


@pytest.mark.parametrize("passes", [3, 1])
def test_wgrad_at_bunch_1024_within_phase3_tolerance_only_with_3xtf32(passes):
    x, e, v, ref = _wgrad_case()
    corr = gemm_tf32(x.T.contiguous(), e, passes).double() + 0.9 * v.double()
    err = (corr - ref).abs().max().item()
    tol = 1e-5 * ref.abs().max().item()                  # p and v within 1e-5 * max
    if passes == 3:
        assert err <= tol / 5
    else:
        assert err > 10 * tol


# The f32 WGMMA route: out^T = A^T B^T with A = W (forward) or e (weight
# gradient) split in registers and taken first in each k8 step
@pytest.mark.parametrize("which", ["forward", "wgrad"])
def test_f32_wgmma_route_terms_within_phase3_tolerance(which):
    if which == "forward":
        x, w, ref = _affine_case()
        z = gemm_tf32(w.T.contiguous(), x.T.contiguous(), 3).T.double()
        err_z = (z - ref).abs().max().item()
        err_y = (torch.sigmoid(z) - torch.sigmoid(ref)).abs().max().item()
        assert err_z <= 1e-4 * max(ref.abs().max().item(), 1.0) / 10 and err_y <= 1e-4 / 10
        # the roles matter: the order differs from the mma.sync route's
        assert not torch.equal(z, gemm_tf32(x, w, 3).double())
    else:
        x, e, v, ref = _wgrad_case()
        corr = gemm_tf32(e.T.contiguous(), x, 3).T.double() + 0.9 * v.double()
        assert (corr - ref).abs().max().item() <= 1e-5 * ref.abs().max().item() / 5


def _dgrad_case(Out):
    """dz (M, Out) and W (In, Out) as a layer's error and weight are
    scaled, dx = dz W^T."""
    rng = np.random.default_rng(3)
    M, In = 48, 40
    dz = torch.from_numpy((rng.standard_normal((M, Out)) / math.sqrt(Out)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((In, Out)).astype(np.float32))
    return dz, w, dz.double() @ w.double().T


# The input gradient's route: dx^T = W dz^T, W split in registers and taken
# first in each k8 step, each 128-deep run of steps summed apart and then
# added (the kernel's promotion), at the production dgrads' depths (Out 4096
# for the hidden layers, 8192 for the output layer)
@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("depth", [4096, 8192])
def test_dgrad_at_production_depth_within_phase3_tolerance_only_with_3xtf32(depth, passes):
    dz, w, ref = _dgrad_case(depth)
    dx = gemm_tf32(w, dz.T.contiguous(), passes, stage=128).T.double()
    err = (dx - ref).abs().max().item()
    tol = 1e-5 * ref.abs().max().item()                  # dx within 1e-5 * max
    if passes == 3:
        assert err <= tol / 5
        # the roles matter: the order differs from dz @ W^T's
        assert not torch.equal(dx, gemm_tf32(dz, w.T.contiguous(), 3).double())
    else:
        assert err > 10 * tol


# --------------------------------------------------------------------------
# the launch plan
# --------------------------------------------------------------------------

BIG, SMALL, WIDE, HALF = tile_plan.BIG, tile_plan.SMALL, tile_plan.WIDE, tile_plan.HALF
MMA_SYNC, WGMMA, CP_WGMMA = tile_plan.MMA_SYNC, tile_plan.WGMMA, tile_plan.CP_WGMMA
ROWS, WS_WGMMA = tile_plan.ROWS, tile_plan.WS_WGMMA

# (M, N, K, a_pitch, b_pitch, wgrad) -> (tile, splits, k_chunk, a_bytes,
# b_bytes, route)
MAIN_PATH_PLANS = {
    # affine_sigmoid x (M, K) @ W (K, N): pitches K and N, on the f32
    # CP_WGMMA route (3xTF32 wgmma fed by cp.async; mma.sync before). K is
    # split where the blocks still fit two an SM in one wave (80 and 128
    # tiles), not where that takes two waves (240 tiles); x's f32 rows of
    # 598 (2,392 bytes) take 8-byte copies
    "affine 960x598->1024 (MLP3)": ((960, 1024, 598, 598, 1024, False),
                                    (HALF, 1, 598, 8, 16, CP_WGMMA)),
    "affine 480x598->1024 (MLP3, a 2x2 mesh rank's rows)": ((480, 1024, 598, 598, 1024, False),
                                                            (HALF, 2, 320, 8, 16, CP_WGMMA)),
    "affine 284x598->1024 (one tmpe utterance)": ((284, 1024, 598, 598, 1024, False),
                                                  (HALF, 3, 224, 8, 16, CP_WGMMA)),
    "affine 1024x368->500 (TIMIT hidden)": ((1024, 500, 368, 368, 500, False),
                                            (HALF, 2, 192, 16, 16, CP_WGMMA)),
    # the production stack's f32 forward: 3xTF32 wgmma on the ping-pong
    # 128x128 tiles of a persistent grid, no split (the f32 WGMMA route;
    # the BIG mma.sync tile before)
    "affine 1024x1024->4096": ((1024, 4096, 1024, 1024, 4096, False),
                               (BIG, 1, 1024, 16, 16, WGMMA)),
    "affine 1024x4096->4096": ((1024, 4096, 4096, 4096, 4096, False),
                               (BIG, 1, 4096, 16, 16, WGMMA)),
    # wgrad x^T e: M = In, N = Out, K = bunch; pitches In and Out; the f32
    # CP_WGMMA route splits the bunch 3 ways at 160 tiles (4 on mma.sync,
    # whose blocks fit 3 an SM); 960x1024->135 (an odd Out) takes the
    # WS_WGMMA route, Out on wgmma's N (136 wide), 16 tiles of In each cut
    # 6 ways, e's rows copied as one 16-byte run a stage
    "wgrad 960x598->1024 (MLP3)": ((598, 1024, 960, 598, 1024, True),
                                   (HALF, 3, 320, 8, 16, CP_WGMMA)),
    "wgrad 960x1024->135 (MLP3)": ((1024, 135, 960, 1024, 135, True),
                                   (ROWS, 6, 160, 16, 16, WS_WGMMA)),
    # the production weight gradients: the ping-pong 128x128 tiles of the
    # f32 WGMMA route on a persistent grid (the BIG mma.sync tile before)
    "wgrad 1024x1024->4096": ((1024, 4096, 1024, 1024, 4096, True),
                              (BIG, 1, 1024, 16, 16, WGMMA)),
    "wgrad 1024x4096->4096": ((4096, 4096, 1024, 4096, 4096, True),
                              (BIG, 1, 1024, 16, 16, WGMMA)),
    "wgrad 1024x4096->8192": ((4096, 8192, 1024, 4096, 8192, True),
                              (BIG, 1, 1024, 16, 16, WGMMA)),
    # Seide et al.'s Switchboard CD-DNN (429->2048x7->9304, bunch 1024): its
    # 2048-wide forwards make 8x16 = 128 BIG tiles, one short of a wave of
    # 132 SMs, so they take the f32 CP_WGMMA route (256 blocks of 64x128),
    # the first layer's 429-float rows by 4-byte copies; its 2048->2048 and
    # 2048->9304 weight gradients fill the card on the WGMMA route, the
    # first layer's 429x2048 takes CP_WGMMA
    "affine 1024x429->2048 (SWB CD-DNN input)": ((1024, 2048, 429, 429, 2048, False),
                                                 (HALF, 1, 429, 4, 16, CP_WGMMA)),
    "affine 1024x2048->2048 (SWB CD-DNN hidden)": ((1024, 2048, 2048, 2048, 2048, False),
                                                   (HALF, 1, 2048, 16, 16, CP_WGMMA)),
    "wgrad 1024x429->2048 (SWB CD-DNN input)": ((429, 2048, 1024, 429, 2048, True),
                                                (HALF, 1, 1024, 4, 16, CP_WGMMA)),
    "wgrad 1024x2048->2048 (SWB CD-DNN hidden)": ((2048, 2048, 1024, 2048, 2048, True),
                                                  (BIG, 1, 1024, 16, 16, WGMMA)),
    "wgrad 1024x2048->9304 (SWB CD-DNN output)": ((2048, 9304, 1024, 2048, 9304, True),
                                                  (BIG, 1, 1024, 16, 16, WGMMA)),
}


@pytest.mark.parametrize("name", sorted(MAIN_PATH_PLANS))
def test_plan_of_main_path_shapes(name):
    (M, N, K, ap, bp, wgrad), want = MAIN_PATH_PLANS[name]
    p = tile_plan.plan(M, N, K, a_pitch=ap, b_pitch=bp, a_ptr=256, b_ptr=512, wgrad=wgrad)
    assert (p.tile, p.splits, p.k_chunk, p.a_bytes, p.b_bytes, p.route) == want
    assert (p.bm, p.bn) == tile_plan.TILES[p.tile]
    tiles = tile_plan.tile_count(M, N, p.tile)
    if p.route == WGMMA:
        # a persistent grid: a block an SM, walking the tiles
        assert p.blocks == min(tiles, tile_plan.SM_COUNT)
    else:
        assert p.blocks == tiles * p.splits
    # BIG and WGMMA plans only where the 128x128 tiles fill the card
    assert tile_plan.tile_count(M, N, BIG) >= tile_plan.SM_COUNT or p.tile in (SMALL, HALF, ROWS)
    if p.tile != BIG:
        # the split leaves the busiest SM no more work than the whole tiles
        busiest = -(-p.blocks // tile_plan.SM_COUNT) / p.splits
        assert busiest <= -(-p.blocks // p.splits // tile_plan.SM_COUNT)
    # the splits cover the contraction exactly once, in whole BK steps
    assert p.k_chunk * (p.splits - 1) < K <= p.k_chunk * p.splits
    if p.splits > 1:
        assert p.k_chunk % tile_plan.BK == 0
        assert p.k_chunk >= tile_plan.MIN_K_STEPS * tile_plan.BK
        # a counter per tile: the tiles fit the wrappers' counters buffer
        assert tile_plan.tile_count(M, N, p.tile) <= _build.COUNTERS


# every production shape (and the f32 forward at 1024x4096->8192) takes the
# f32 WGMMA route: no split, 128x128 tiles on a persistent grid of a block
# an SM; the same shapes with an operand one float off a 16-byte boundary
# keep the MMA_SYNC plan they had: the BIG tile, no split, the tile grid
PRODUCTION_PLANS = {
    (1024, 4096, 1024, 1024, 4096, False): 132, (1024, 4096, 4096, 4096, 4096, False): 132,
    (1024, 4096, 1024, 1024, 4096, True): 132, (4096, 4096, 1024, 4096, 4096, True): 132,
    (4096, 8192, 1024, 4096, 8192, True): 132, (1024, 8192, 4096, 4096, 8192, False): 132}
MMA_SYNC_GRIDS = {
    (1024, 4096, 1024, 1024, 4096, False): 256, (1024, 4096, 4096, 4096, 4096, False): 256,
    (1024, 4096, 1024, 1024, 4096, True): 256, (4096, 4096, 1024, 4096, 4096, True): 1024,
    (4096, 8192, 1024, 4096, 8192, True): 2048, (1024, 8192, 4096, 4096, 8192, False): 512}


@pytest.mark.parametrize("shape", sorted(PRODUCTION_PLANS))
def test_production_plans_unchanged(shape):
    M, N, K, ap, bp, wgrad = shape
    p = tile_plan.plan(M, N, K, a_pitch=ap, b_pitch=bp, a_ptr=1 << 20, b_ptr=1 << 21,
                       wgrad=wgrad, out_ptrs=(1 << 22,))
    assert p == tile_plan.Plan(BIG, 128, 128, 1, K, 16, 16, WGMMA, PRODUCTION_PLANS[shape])
    # the bf16 route's plan: the same for the weight gradient, 128x256
    # tiles on the tile grid for the forward
    pb = tile_plan.plan(M, N, K, ap, bp, 1 << 20, 1 << 21, wgrad=wgrad, elem=2,
                        out_ptrs=(1 << 22,))
    assert pb == (p if wgrad else tile_plan.Plan(WIDE, 128, 256, 1, K, 16, 16, WGMMA,
                                                 tile_plan.tile_count(M, N, WIDE)))
    for ptrs in ((1 << 20 | 4, 1 << 21, ()), (1 << 20, 1 << 21 | 4, ()),
                 (1 << 20, 1 << 21, (1 << 22 | 8,))):
        q = tile_plan.plan(M, N, K, ap, bp, ptrs[0], ptrs[1], wgrad=wgrad, out_ptrs=ptrs[2])
        assert q[:2] == (BIG, 128) and q.route == MMA_SYNC and q.splits == 1
        assert q.blocks == MMA_SYNC_GRIDS[shape]


# f32 shapes of the BIG tile's size whose operands TMA cannot describe stay
# on MMA_SYNC: a pitch that is not a multiple of 4 floats (K = 4098, N =
# 4098), or, for the weight gradient, a bunch that is not (the pitch of the
# pre-pass's transposed copy of x)
@pytest.mark.parametrize("shape", [(1024, 4096, 4098, 4098, 4096, False),
                                   (1024, 4098, 4096, 4096, 4098, False),
                                   (4096, 4098, 1024, 4096, 4098, True),
                                   (4096, 4096, 1022, 4096, 4096, True),
                                   (1022, 4096, 4096, 4096, 4096, False)])
def test_f32_wgmma_route_needs_tma_pitches(shape):
    M, N, K, ap, bp, wgrad = shape
    p = tile_plan.plan(M, N, K, ap, bp, 1 << 20, 1 << 21, wgrad=wgrad, out_ptrs=(1 << 22,))
    want = MMA_SYNC if K % 4 or ap % 4 or bp % 4 else WGMMA
    assert p.route == want and (p.route == WGMMA) == (M == 1022)
    if p.route == MMA_SYNC:
        assert (p.tile, p.splits, p.blocks) == (BIG, 1, tile_plan.tile_count(M, N, BIG))


# Every SMALL-tile shape of the main paths, with aligned operands and
# pitches TMA could describe (so only the tile count keeps it off the f32
# WGMMA route), takes the f32 CP_WGMMA route on its tile (CP_F32_TILE: 64
# rows by 128 columns): TIMIT's
# forward and output weight, the RBM recipe's 960x1024->1024, a 2x1 mesh
# rank's production rows (128 BIG tiles, under the 132 SMs), MLP3's and
# tmpe's rows, TIMIT's output layer, but for the weight gradients of an
# odd Out: MLP3's 135 takes the WS_WGMMA route (tile_plan.ws_f32_takes),
# TIMIT's 39 keeps its MMA_SYNC plan (tile_plan.cp_f32_keeps_mma_sync). Its split (cp_f32_splits: waves of two
# blocks an SM) is the mma.sync plan's but at MLP3's 598->1024 weight
# gradient (3 splits, 4 before) and the 128-tile forwards (TIMIT's and a
# mesh rank's: 2, whole before); copy widths and grids follow. With both
# routes switched off each keeps the MMA_SYNC plan it had.
# Plan fields: tile, bm, bn, splits, k_chunk, a_bytes, b_bytes, route,
# blocks.
SMALL_PLANS = {
    (1024, 500, 368, 368, 500, False): (HALF, 64, 128, 2, 192, 16, 16, CP_WGMMA, 128),
    (1024, 500, 368, 368, 500, True): (HALF, 64, 128, 2, 192, 16, 16, CP_WGMMA, 128),
    (960, 1024, 1024, 1024, 1024, False): (HALF, 64, 128, 1, 1024, 16, 16, CP_WGMMA, 120),
    (1024, 1024, 960, 1024, 1024, True): (HALF, 64, 128, 1, 960, 16, 16, CP_WGMMA, 128),
    (512, 4096, 1024, 1024, 4096, False): (HALF, 64, 128, 1, 1024, 16, 16, CP_WGMMA, 256),
    (512, 4096, 4096, 4096, 4096, False): (HALF, 64, 128, 1, 4096, 16, 16, CP_WGMMA, 256),
    (960, 1024, 598, 598, 1024, False): (HALF, 64, 128, 1, 598, 8, 16, CP_WGMMA, 120),
    (598, 1024, 960, 598, 1024, True): (HALF, 64, 128, 3, 320, 8, 16, CP_WGMMA, 240),
    (1024, 135, 960, 1024, 135, True): (ROWS, 64, 136, 6, 160, 16, 16, WS_WGMMA, 96),
    (284, 1024, 598, 598, 1024, False): (HALF, 64, 128, 3, 224, 8, 16, CP_WGMMA, 120),
    (480, 1024, 598, 598, 1024, False): (HALF, 64, 128, 2, 320, 8, 16, CP_WGMMA, 128),
    (1024, 39, 500, 500, 39, False): (HALF, 64, 128, 4, 128, 16, 4, CP_WGMMA, 64),
    (500, 39, 1024, 500, 39, True): (SMALL, 64, 64, 8, 128, 16, 4, MMA_SYNC, 64),
}
# the MMA_SYNC plans these shapes had before the route, and have under
# mma_sync_f32 (the f32 route's element size switched off)
MMA_SYNC_SMALL_PLANS = {
    (1024, 500, 368, 368, 500, False): (SMALL, 64, 64, 1, 368, 16, 16, MMA_SYNC, 128),
    (1024, 500, 368, 368, 500, True): (SMALL, 64, 64, 1, 368, 16, 16, MMA_SYNC, 128),
    (960, 1024, 1024, 1024, 1024, False): (SMALL, 64, 64, 1, 1024, 16, 16, MMA_SYNC, 240),
    (1024, 1024, 960, 1024, 1024, True): (SMALL, 64, 64, 1, 960, 16, 16, MMA_SYNC, 256),
    (512, 4096, 1024, 1024, 4096, False): (SMALL, 64, 64, 1, 1024, 16, 16, MMA_SYNC, 512),
    (512, 4096, 4096, 4096, 4096, False): (SMALL, 64, 64, 1, 4096, 16, 16, MMA_SYNC, 512),
    (960, 1024, 598, 598, 1024, False): (SMALL, 64, 64, 1, 598, 8, 16, MMA_SYNC, 240),
    (598, 1024, 960, 598, 1024, True): (SMALL, 64, 64, 4, 256, 8, 16, MMA_SYNC, 640),
    (1024, 135, 960, 1024, 135, True): (SMALL, 64, 64, 5, 192, 16, 4, MMA_SYNC, 240),
    (284, 1024, 598, 598, 1024, False): (SMALL, 64, 64, 3, 224, 8, 16, MMA_SYNC, 240),
    (480, 1024, 598, 598, 1024, False): (SMALL, 64, 64, 1, 598, 8, 16, MMA_SYNC, 128),
    (1024, 39, 500, 500, 39, False): (SMALL, 64, 64, 4, 128, 16, 4, MMA_SYNC, 64),
    (500, 39, 1024, 500, 39, True): (SMALL, 64, 64, 8, 128, 16, 4, MMA_SYNC, 64),
}


@pytest.mark.parametrize("shape", sorted(SMALL_PLANS))
def test_small_route_shapes_keep_their_plan(shape):
    M, N, K, ap, bp, wgrad = shape
    p = tile_plan.plan(M, N, K, ap, bp, 1 << 20, 1 << 21, wgrad=wgrad, out_ptrs=(1 << 22,))
    assert tuple(p) == SMALL_PLANS[shape]
    saved = tile_plan.CP_WGMMA_ELEMS, tile_plan.WS_ELEMS
    try:
        tile_plan.CP_WGMMA_ELEMS, tile_plan.WS_ELEMS = (2,), ()
        q = tile_plan.plan(M, N, K, ap, bp, 1 << 20, 1 << 21, wgrad=wgrad, out_ptrs=(1 << 22,))
    finally:
        tile_plan.CP_WGMMA_ELEMS, tile_plan.WS_ELEMS = saved
    assert tuple(q) == MMA_SYNC_SMALL_PLANS[shape]
    # the same copy widths either way, but e's on the WS_WGMMA route: its
    # stage is whole rows, one run, so the base alone decides
    assert q.a_bytes == p.a_bytes
    assert q.b_bytes == p.b_bytes or (p.route == WS_WGMMA and p.b_bytes == 16)


# the WGMMA tiles' shared memory (each schedule's SMEM_BYTES) fits a block's
# 227 KB beside the runtime's reservation; the f32 ring of both kernels: 4
# stages of W or e 32x128 raw and x's hi and lo 128x32 (PingPong)
@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("wgrad", [False, True])
def test_wgmma_tiles_fit_the_shared_memory_of_a_block(elem, wgrad):
    smem = tile_plan.wgmma_smem_bytes(elem, wgrad)
    assert smem <= 227 * 1024
    assert smem + tile_plan.BLOCK_SMEM_RESERVED <= tile_plan.SM_SMEM
    if elem == 4:
        assert smem == 4 * 48 * 1024 + 128 + 1024
        assert 4 * tile_plan.WGMMA_BK[4] * (128 + 2 * 128) == 48 * 1024   # a stage


def test_plan_copy_path_follows_pitch_and_alignment():
    for ptr, width in ((0, 16), (16, 16), (4, 4), (8, 8), (12, 4), (1 << 40, 16)):
        p = tile_plan.plan(512, 512, 512, a_pitch=512, b_pitch=512, a_ptr=ptr, b_ptr=0)
        assert (p.a_bytes, p.b_bytes) == (width, 16)
    for pitch in (598, 135, 1023, 2, 1):
        assert tile_plan.copy_bytes(pitch, 0) < 16
    assert tile_plan.copy_bytes(1024, 4096) == 16


@pytest.mark.parametrize("ptr,want", [(0, 8), (8, 8), (24, 8), (4, 4), (12, 4)])
def test_plan_copy_width_of_598_wide_rows(ptr, want):
    # f32 rows of 598 (2,392 bytes: a multiple of 8, not of 16) take 8-byte
    # copies from an 8-aligned base, 4-byte ones from a 4-aligned one; the
    # same rows at bf16 (1,196 bytes) take 4-byte copies
    assert tile_plan.copy_bytes(598, ptr) == want
    assert tile_plan.plan(960, 1024, 598, 598, 1024, a_ptr=ptr).a_bytes == want
    assert tile_plan.plan(598, 1024, 960, 598, 1024, a_ptr=ptr, wgrad=True).a_bytes == want
    assert tile_plan.copy_bytes(598, ptr, elem=2) == 4
    # the BIG tile's kernels have no 8-byte path: 4-byte copies there
    assert tile_plan.plan(4096, 4096, 598, 598, 4096, a_ptr=ptr).a_bytes == 4


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("a_kmajor", [True, False])
def test_planned_blocks_fit_the_shared_memory_of_an_sm(elem, a_kmajor):
    # the SMALL blocks the plan counts on per SM, each with its dynamic
    # shared memory (the ring, at least the staged f32 output tile), the
    # reduction flag and the runtime's reservation
    need = tile_plan.smem_bytes(SMALL, elem, a_kmajor) + 16 + tile_plan.BLOCK_SMEM_RESERVED
    assert tile_plan.SMALL_PER_SM * need <= tile_plan.SM_SMEM
    assert tile_plan.smem_bytes(SMALL, elem, a_kmajor) >= 4 * 64 * 72
    # the largest SMALL grid (under SM_COUNT BIG tiles) has a counter a tile
    assert 4 * (tile_plan.SM_COUNT - 1) <= _build.COUNTERS
    # one BIG block an SM at least
    assert tile_plan.smem_bytes(BIG, elem, a_kmajor) + tile_plan.BLOCK_SMEM_RESERVED \
        <= tile_plan.SM_SMEM


def test_plan_splits_only_when_asked_and_idle():
    # both kernels split a SMALL grid whose load a split evens: the forward
    # as the weight gradient (48 tiles: 5 splits leave 2 blocks of 6 steps
    # on the busiest SM, against one of 30); the weight gradient on its
    # WS_WGMMA route by that route's rule (16 tiles of 136 columns, 6 ways)
    assert tile_plan.plan(1024, 135, 960, 1024, 135).splits == 5
    assert tile_plan.plan(1024, 135, 960, 1024, 135, wgrad=True).splits == 6
    assert tile_plan.split_count(48, 30) == 5
    # one tile an SM, or two, stays whole: no split evens 128 or 264 tiles
    assert [tile_plan.split_count(t, 30) for t in (128, 132, 240, 264)] == [1, 1, 1, 1]
    p = tile_plan.plan(1536, 704, 598, 598, 704)
    assert (p.tile, p.splits, p.blocks) == (HALF, 1, 144)
    # 272 tiles leave 3 on the busiest SM whole, 9/4 in 4 splits with three
    # blocks an SM at a time (mma.sync); in waves of two blocks an SM (the
    # f32 CP_WGMMA route, whose plan this is) 3 splits cost least
    assert tile_plan.split_count(272, 19) == 4
    assert tile_plan.plan(1088, 1024, 598, 598, 1024).splits == 3
    assert tile_plan.cp_f32_splits(1088, 1024, 598) == 3
    # 160 tiles over 30 steps: 4 splits of 3xTF32 (5 blocks of 7.5 steps in
    # two waves on the busiest SM), 2 of bf16, whose steps are cheaper
    # against a block's fixed cost (3 blocks of 15 steps in one wave)
    assert tile_plan.split_count(160, 30) == 4
    assert tile_plan.split_count(160, 30, elem=2) == 2
    # never under MIN_K_STEPS steps a split
    assert tile_plan.split_count(1, 7) == 1 and tile_plan.split_count(1, 8) == 2
    # a contraction too short for two splits of MIN_K_STEPS stays whole
    p = tile_plan.plan(64, 64, 200, 64, 64, wgrad=True)
    assert (p.splits, p.k_chunk) == (1, 200)
    # tiny shapes still get one block
    p = tile_plan.plan(1, 1, 1, 1, 1, wgrad=True)
    assert (p.tile, p.splits, p.k_chunk) == (SMALL, 1, 1)
    with pytest.raises(ValueError):
        tile_plan.plan(0, 4, 4, 4, 4)


# The input gradient dx = dz W^T, (B, In, Out): the production stack's four
# dgrads (3 of 4096->4096, the output layer's 4096->8192) take the f32
# WGMMA route (csrc/dgrad.cu) on a persistent grid of a block an SM, no
# split, K = Out; so do grids of one wave that leave at most 1/16 of the
# SMs idle (DGRAD_ONE_WAVE); every other dx stays with torch.matmul (None):
# MLP3's 960x1024->135 (540-byte pitches), TIMIT's 1024x500->39, a 2x2 mesh
# rank's rows of MLP3 (480), one tmpe utterance's, the RBM recipe's
# 960x1024->1024 (64 tiles)
DGRAD_ROUTED = {"hidden 1024x4096->4096": (1024, 4096, 4096),
                "output 1024x4096->8192": (1024, 4096, 8192)}
DGRAD_LIBRARY = {"MLP3 960x1024->135": (960, 1024, 135), "TIMIT 1024x500->39": (1024, 500, 39),
                 "MLP3 mesh rank 480x1024->135": (480, 1024, 135),
                 "tmpe utterance 284x1024->135": (284, 1024, 135),
                 "RBM recipe 960x1024->1024": (960, 1024, 1024)}
# (B, In, Out, tiles of dx^T): one wave of 128 tiles (the SWB CD-DNN's
# layers, a 2x2 mesh rank's 512 rows of the production stack) and the
# rule's edge, 124 tiles (15/16 of the 132 SMs, rounded up) taken and 123
# left to the library
DGRAD_ONE_WAVE = {"SWB CD-DNN hidden 1024x2048->2048": (1024, 2048, 2048, 128),
                  "SWB CD-DNN output 1024x2048->9304": (1024, 2048, 9304, 128),
                  "production mesh rank 512x4096->4096": (512, 4096, 4096, 128),
                  "production mesh rank 512x4096->8192": (512, 4096, 8192, 128),
                  "edge 512x3968->4096": (512, 3968, 4096, 124),
                  "under the edge 384x5248->4096": (384, 5248, 4096, 123)}


@pytest.mark.parametrize("name", sorted(DGRAD_ROUTED))
def test_dgrad_plan_of_production_shapes(name):
    B, In, Out = DGRAD_ROUTED[name]
    p = tile_plan.dgrad_plan(B, In, Out, 1 << 20, 1 << 21, out_ptrs=(1 << 22,))
    assert p == tile_plan.Plan(BIG, 128, 128, 1, Out, 16, 16, WGMMA, tile_plan.SM_COUNT)
    assert tile_plan.tile_count(In, B, BIG) == 256
    # the same shape at bf16, or with any operand one float off a 16-byte
    # boundary, stays with torch.matmul
    assert tile_plan.dgrad_plan(B, In, Out, 1 << 20, 1 << 21, elem=2) is None
    for ptrs in ((1 << 20 | 4, 1 << 21, ()), (1 << 20, 1 << 21 | 4, ()),
                 (1 << 20, 1 << 21, (1 << 22 | 8,))):
        assert tile_plan.dgrad_plan(B, In, Out, ptrs[0], ptrs[1], out_ptrs=ptrs[2]) is None


@pytest.mark.parametrize("name", sorted(DGRAD_LIBRARY))
def test_dgrad_plan_leaves_small_shapes_to_the_library(name):
    B, In, Out = DGRAD_LIBRARY[name]
    assert tile_plan.dgrad_plan(B, In, Out, 1 << 20, 1 << 21, out_ptrs=(1 << 22,)) is None


@pytest.mark.parametrize("name", sorted(DGRAD_ONE_WAVE))
def test_dgrad_plan_takes_one_wave_grids(name):
    B, In, Out, tiles = DGRAD_ONE_WAVE[name]
    assert tile_plan.tile_count(In, B, BIG) == tiles
    p = tile_plan.dgrad_plan(B, In, Out, 1 << 20, 1 << 21, out_ptrs=(1 << 22,))
    if tiles >= 124:
        # one block a tile, the whole contraction (a K tail at Out = 9304)
        assert p == tile_plan.Plan(BIG, 128, 128, 1, Out, 16, 16, WGMMA, tiles)
    else:
        assert p is None


# pitches TMA cannot describe (Out or In not a multiple of 4 floats) keep
# torch.matmul at a shape whose tiles fill the card; the rule is the f32
# WGMMA route's, so switching that route off (mma_sync_f32) or the dgrad's
# alone (library_dgrad) leaves every dx to the library
@pytest.mark.parametrize("shape", [(1024, 4096, 4098), (1024, 4098, 4096), (1022, 4096, 4096)])
def test_dgrad_plan_needs_tma_pitches(shape):
    B, In, Out = shape
    p = tile_plan.dgrad_plan(B, In, Out, 1 << 20, 1 << 21)
    assert (p is None) == bool(Out % 4 or In % 4)


def test_dgrad_plan_follows_the_route_switches():
    from nnet_asr_torch.tools.gemm_ceiling import library_dgrad, mma_sync_f32

    args = (1024, 4096, 4096, 1 << 20, 1 << 21)
    assert tile_plan.dgrad_plan(*args) is not None
    for switch in (library_dgrad, mma_sync_f32):
        with switch():
            assert tile_plan.dgrad_plan(*args) is None
        assert tile_plan.dgrad_plan(*args) is not None
    with library_dgrad():
        # the other f32 routes stay on
        assert tile_plan.plan(1024, 4096, 4096, 4096, 4096).route == WGMMA


# on the CPU the wrapper is torch.matmul, bit for bit, at both dtypes'
# roundings (bf16: bf16_matmul), and launches nothing
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dgrad_on_the_cpu_is_the_library_product(dtype):
    from nnet_asr_torch.ops.kernels import matmul_act as MA

    rng = np.random.default_rng(4)
    dz = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((40, 48)).astype(np.float32)).to(dtype)
    before = MA.dgrad.launches
    dx = MA.dgrad(dz, w)
    assert MA.dgrad.launches == before and dx.dtype == dtype
    want = MA.bf16_matmul(dz, w.T) if dtype == torch.bfloat16 else torch.matmul(dz, w.T)
    assert torch.equal(dx, want)

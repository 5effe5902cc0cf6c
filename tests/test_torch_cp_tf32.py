"""The f32 CP_WGMMA route (``csrc/cp_tf32_wgmma.cuh``) on the CPU.

The kernels run only on the card; what surrounds them is held here:

- ``tile_plan.plan``'s f32 CP_WGMMA plan at every recipe shape (tile,
  splits, k_chunk, copy widths, grid), and the rule that picks the route;
- the ring's shared memory against a block's and an SM's;
- the byte layouts, emulated with numpy from the kernel's index
  arithmetic: ``cp.async`` runs of 4, 8 or 16 bytes into the swizzled
  stages, the forward's in-place split of x and the weight gradient's
  transposing split, read back through the layout wgmma's descriptors
  read, give the bits of ``rna_tf32`` and of the f32 WGMMA route's
  pre-pass; the A fragments a thread loads are the columns the epilogue
  writes; a warp's shared-memory accesses fall in distinct banks;
- the arithmetic: ``out^T = A B`` with the register operand (W or e)
  split, ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` a k8 step, the split-K
  partials summed in split order, within the tolerances ``chip_smoke.py``
  phase 3 holds the kernels to, at depths 368, 598, 960 and 1024.
"""

import math
import os

import numpy as np
import pytest
import torch

from nnet_asr_torch.ops.kernels import _build, tile_plan
from nnet_asr_torch.tools.gemm_ceiling import mma_sync_f32

torch.set_num_threads(2)

SMALL, HALF, CP, MMA_SYNC = tile_plan.SMALL, tile_plan.HALF, tile_plan.CP_WGMMA, tile_plan.MMA_SYNC
WS = tile_plan.WS_WGMMA
BK, A_LINE, B_ROW = 32, 256, 128       # cp_tf32_wgmma.cuh BK, A_LINE, B_ROW


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

# (M, N, K, a_pitch, b_pitch, wgrad, a_ptr) -> (splits, k_chunk, a_bytes,
# b_bytes, blocks), all on tiles of 64 rows by 128 columns (the splits of
# the 64x64 grid: 240 tiles of that grid at MLP3's forward, whole, 120
# blocks). The forward at MLP3's rows (x of 2,392 bytes: 8-byte copies,
# 4-byte ones from a base 4 bytes off), TIMIT's (16-byte copies of x and
# W; 2 splits), a 2x2 mesh rank's (2 splits), one tmpe utterance's (3
# splits of 7, 7 and 5 steps), the RBM recipe's second layer and
# TIMIT's output layer (39 columns: 4-byte copies); the weight gradients of
# MLP3's hidden layer (160 tiles: 3 splits) and TIMIT's (48 tiles over 32
# steps: 5 splits). The weight gradients of an odd Out (MLP3's 135, TIMIT's
# 39) keep mma.sync: test_f32_cp_route_rule.
F32_CP_PLANS = {
    (960, 1024, 598, 598, 1024, False, 0): (1, 598, 8, 16, 120),
    (960, 1024, 598, 598, 1024, False, 4): (1, 598, 4, 16, 120),
    (1024, 500, 368, 368, 500, False, 0): (2, 192, 16, 16, 128),
    (480, 1024, 598, 598, 1024, False, 0): (2, 320, 8, 16, 128),
    (284, 1024, 598, 598, 1024, False, 0): (3, 224, 8, 16, 120),
    (307, 1024, 598, 598, 1024, False, 0): (3, 224, 8, 16, 120),
    (960, 1024, 1024, 1024, 1024, False, 0): (1, 1024, 16, 16, 120),
    (1024, 39, 500, 500, 39, False, 0): (4, 128, 16, 4, 64),
    (598, 1024, 960, 598, 1024, True, 0): (3, 320, 8, 16, 240),
    (368, 500, 1024, 368, 500, True, 0): (5, 224, 16, 16, 120),
}


@pytest.mark.parametrize("shape", sorted(F32_CP_PLANS))
def test_f32_cp_plan_of_recipe_shapes(shape):
    M, N, K, ap, bp, wgrad, a_ptr = shape
    p = tile_plan.plan(M, N, K, ap, bp, (1 << 20) + a_ptr, 1 << 21, wgrad=wgrad,
                       out_ptrs=(1 << 22,))
    splits, k_chunk, a_bytes, b_bytes, blocks = F32_CP_PLANS[shape]
    assert p == tile_plan.Plan(HALF, 64, 128, splits, k_chunk, a_bytes, b_bytes, CP, blocks)
    tiles = tile_plan.tile_count(M, N, HALF)
    assert blocks == tiles * splits and tiles <= _build.COUNTERS
    assert splits == tile_plan.cp_f32_splits(M, N, K)
    # whole BK steps a split, every k once, at least MIN_K_STEPS steps a split
    assert k_chunk * (splits - 1) < K <= k_chunk * splits
    if splits > 1:
        assert k_chunk % BK == 0 and k_chunk >= tile_plan.MIN_K_STEPS * BK
    # a copy run never straddles the matrix's edge: the width divides the
    # pitch and the base
    for pitch, ptr, width in ((ap, a_ptr, a_bytes), (bp, 0, b_bytes)):
        assert (4 * pitch) % width == 0 and ptr % width == 0


# the route: f32 products whose BIG tiles would leave SMs idle, forward and
# weight gradient, whatever their pitches, but the weight gradient of an
# odd Out (e rows of no whole 8-byte units), which takes the WS_WGMMA route
# where its N width is built (135) and else keeps its mma.sync plan;
# f32 products the BIG tile fills keep the f32 WGMMA route or, off TMA, the
# BIG mma.sync plan; mma_sync_f32 forces the MMA_SYNC plans of all
@pytest.mark.parametrize("shape,route", [
    ((960, 1024, 598, 598, 1024), CP), ((1, 2, 1, 1, 2), CP), ((67, 136, 598, 598, 136), CP),
    ((67, 135, 598, 598, 135), CP), ((1024, 4096, 1024, 1024, 4096), tile_plan.WGMMA),
    ((1024, 4096, 598, 598, 4096), MMA_SYNC),
    ((512, 4096, 4096, 4096, 4096), CP)])
@pytest.mark.parametrize("wgrad", [False, True])
def test_f32_cp_route_rule(shape, route, wgrad):
    M, N, K, ap, bp = shape
    p = tile_plan.plan(M, N, K, ap, bp, 1 << 20, 1 << 21, wgrad=wgrad)
    kept = tile_plan.cp_f32_keeps_mma_sync(wgrad, bp)
    assert kept == (wgrad and bp % 2 == 1)
    # an odd Out the WS_WGMMA route takes (135 rounds up to its 136), else
    # the mma.sync plan it had
    ws = kept and route == CP and tile_plan.ws_f32_takes(M, N, K, wgrad, bp)
    kept = kept and not ws
    assert p.route == (WS if ws else MMA_SYNC if kept and route == CP else route)
    assert (p.route == CP) == (tile_plan.tile_count(M, N, tile_plan.BIG) < tile_plan.SM_COUNT
                               and not kept and not ws)
    if kept and route == CP:   # the plan it had: the SMALL mma.sync tile and its split rule
        tiles = tile_plan.tile_count(M, N, SMALL)
        assert (p.tile, p.splits) == (SMALL, tile_plan.split_count(tiles, -(-K // BK)))
    with mma_sync_f32():
        q = tile_plan.plan(M, N, K, ap, bp, 1 << 20, 1 << 21, wgrad=wgrad)
    assert q.route == MMA_SYNC
    assert tile_plan.plan(M, N, K, ap, bp, 1 << 20, 1 << 21, wgrad=wgrad) == p   # restored
    # bf16 operands keep their own rule: the forward off TMA on 64x64 tiles,
    # the weight gradient on the tile of its own rule
    b = tile_plan.plan(M, N, K, ap, bp, 1 << 20, 1 << 21, wgrad=wgrad, elem=2)
    if b.route == CP:
        assert b.tile == (tile_plan.cp_wgrad_tile(N, ap, bp, 1 << 20, 1 << 21) if wgrad
                          else SMALL)


# --------------------------------------------------------------------------
# shared memory
# --------------------------------------------------------------------------

def _ring(wg, nb, stages, wgrad):
    """CpF32Tile's ring bytes from its slots: A (BK k-lines of 64 WG
    floats) STAGES - 2 of them; the forward's hi STAGES, lo 3; the weight
    gradient's hi and lo 3 each, raw x STAGES - 2."""
    a, b = BK * 4 * 64 * wg, nb * B_ROW
    return (stages - 2) * a + ((3 + 3 + stages - 2) if wgrad else (stages + 3)) * b


@pytest.mark.parametrize("wgrad", [False, True])
def test_f32_cp_ring_fits_a_block_and_two_an_sm(wgrad):
    smem = tile_plan.cp_f32_smem_bytes(wgrad)
    assert tile_plan.CP_F32_TILE == HALF
    assert smem == _ring(2, 64, tile_plan.CP_F32_STAGES, wgrad) + 1024
    assert smem == (88 if not wgrad else 96) * 1024 + 1024
    assert smem <= 227 * 1024
    # CP_F32_PER_SM blocks an SM, each with the reduction flag and the
    # runtime's reservation
    need = smem + 16 + tile_plan.BLOCK_SMEM_RESERVED
    assert tile_plan.CP_F32_PER_SM == 2 and 2 * need <= tile_plan.SM_SMEM
    # the candidates gemm_ceiling builds fit a block: 5 and 6 stages, 64x64
    # (one warpgroup; two blocks an SM by shared memory, 255 registers a
    # thread) and 128x64 at 4
    for tile, wg, nb, stages in ((HALF, 2, 64, 5), (HALF, 2, 64, 6),
                                 (SMALL, 1, 64, 4), (tile_plan.TALL, 1, 128, 4)):
        got = tile_plan.cp_f32_smem_bytes(wgrad, tile, stages)
        assert got == _ring(wg, nb, stages, wgrad) + 1024 <= 227 * 1024
    # slots start on 1024-byte boundaries (the swizzle's phase)
    assert (BK * 4 * 64) % 1024 == 0 and (64 * B_ROW) % 1024 == 0


# --------------------------------------------------------------------------
# layouts, emulated from the kernel's index arithmetic
# --------------------------------------------------------------------------

def rna_tf32(x):
    """cvt.rna.tf32.f32 on f32 bits (tile_gemm.cuh rna_tf32)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(np.asarray(x, np.float32) - hi)


def copy_kmajor(smem, src, ldb, nrows, b0, k0, k_end, nb, width):
    """load_b_kmajor: runs of ``width`` bytes of rows b0.. of src (flat
    f32), row r's 16-byte unit u at r * B_ROW + (u ^ (r % 8)) * 16."""
    runs = B_ROW // width
    for idx in range(nb * runs):
        r, byte = idx // runs, (idx % runs) * width
        k = k0 + byte // 4
        dst = r * B_ROW + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15))
        ok = b0 + r < nrows and k < k_end
        run = src[(b0 + r) * ldb + k:(b0 + r) * ldb + k + width // 4] if ok else 0.0
        smem[dst // 4:dst // 4 + width // 4] = run


def copy_raw(smem, src, ldb, ncols, b0, k0, k_end, nb, width):
    """load_b_raw: k-lines k0.. of src, columns b0 .. b0 + nb, as they are."""
    runs = 4 * nb // width
    for idx in range(BK * runs):
        r, byte = idx // runs, (idx % runs) * width
        col = b0 + byte // 4
        ok = k0 + r < k_end and col < ncols
        run = src[(k0 + r) * ldb + col:(k0 + r) * ldb + col + width // 4] if ok else 0.0
        smem[(r * 4 * nb + byte) // 4:(r * 4 * nb + byte) // 4 + width // 4] = run


def copy_a(smem, src, lda, ncols, a0, k0, k_end, wg, width):
    """load_a: k-lines k0.. of src, columns a0 .. a0 + 64 wg; warpgroup s's
    k-line r at s * A_SUB + r * A_LINE, 16-byte unit u at u ^ 2 (r % 4)."""
    runs = 4 * 64 * wg // width
    for idx in range(BK * runs):
        r, byte = idx // runs, (idx % runs) * width
        inb, col = byte % A_LINE, a0 + byte // 4
        unit = (inb >> 4) ^ ((r & 3) << 1)
        dst = (byte // A_LINE) * BK * A_LINE + r * A_LINE + ((unit << 4) | (inb & 15))
        ok = k0 + r < k_end and col < ncols
        run = src[(k0 + r) * lda + col:(k0 + r) * lda + col + width // 4] if ok else 0.0
        smem[dst // 4:dst // 4 + width // 4] = run


def split_stage(sh, sl, sr, mode, nb, threads=128):
    """split_stage: FWD in place, a 16-byte unit a thread; WGRAD the unit u
    of row j from k 4u .. 4u + 3 of raw column j. Returns, per warp and
    pass, the raw words read and the 16-byte units written (for the banks)."""
    reads, writes = [], []
    for l in range(nb * 8 // threads):
        for warp in range(threads // 32):
            rw, ww = [], []
            for lane in range(32):
                idx = warp * 32 + lane + l * threads
                if mode == "fwd":
                    v = sh[4 * idx:4 * idx + 4].copy()
                    off = 16 * idx
                else:
                    j, u = idx % nb, idx // nb
                    words = [(4 * u + q) * nb + j for q in range(4)]
                    rw.append(words)
                    v = sr[words]
                    off = j * B_ROW + ((u ^ (j & 7)) << 4)
                hi, lo = split_tf32(v)
                sh[off // 4:off // 4 + 4] = hi
                sl[off // 4:off // 4 + 4] = lo
                ww.append(off)
            reads.append(rw)
            writes.append(ww)
    return reads, writes


def read_kmajor(s, nb):
    """B (nb rows of BK k) as wgmma's descriptor reads it: row j's k at j *
    B_ROW + ((k / 4) ^ (j % 8)) * 16 + (k % 4) * 4 (128-byte swizzle)."""
    out = np.empty((nb, BK), np.float32)
    for j in range(nb):
        for k in range(BK):
            out[j, k] = s[(j * B_ROW + (((k // 4) ^ (j & 7)) << 4) + (k % 4) * 4) // 4]
    return out


def _tile_data(rows, cols, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, cols)) * 3).astype(np.float32)


# the forward: x (M, K) K-major, rows b0.. of the tile, k from k0, copies of
# 8 bytes (598 columns) or 16 (368), the tail of K (598 - 576 = 22 columns)
# and of M zero-filled
@pytest.mark.parametrize("M,K,b0,k0,width", [(100, 598, 64, 576, 8), (100, 598, 0, 32, 8),
                                              (130, 368, 64, 352, 16), (70, 598, 64, 0, 4)])
def test_forward_in_block_split_gives_the_prepass_bits(M, K, b0, k0, width):
    nb = 64
    x = _tile_data(M, K, M + K)
    sh, sl = np.full(nb * BK, np.nan, np.float32), np.full(nb * BK, np.nan, np.float32)
    copy_kmajor(sh, x.ravel(), K, M, b0, k0, K, nb, width)
    split_stage(sh, sl, None, "fwd", nb)
    # the f32 WGMMA route's pre-pass (matmul_act_f32_split_kernel): hi and
    # lo of x itself
    want = np.zeros((nb, BK), np.float32)
    rows, cols = min(nb, M - b0), min(BK, K - k0)
    want[:rows, :cols] = x[b0:b0 + rows, k0:k0 + cols]
    hi, lo = split_tf32(want)
    assert np.array_equal(read_kmajor(sh, nb).view(np.uint32), hi.view(np.uint32))
    assert np.array_equal(read_kmajor(sl, nb).view(np.uint32), lo.view(np.uint32))
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()


# the weight gradient: x (B, In) MN-major, its k-lines (the bunch) k0..,
# columns b0..; transposed and split, B row j is x's column b0 + j over the
# bunch, the bits of the pre-pass's (wgrad_momentum_f32_split_kernel)
# transposed copies; columns past In and rows past the bunch zero-filled
@pytest.mark.parametrize("B,In,b0,k0,width", [(960, 598, 576, 928, 8), (960, 1024, 64, 0, 16),
                                              (100, 61, 0, 96, 4)])
def test_wgrad_in_block_transpose_and_split_give_the_prepass_bits(B, In, b0, k0, width):
    nb = 64
    x = _tile_data(B, In, B + In)
    sr = np.full(BK * nb, np.nan, np.float32)
    sh, sl = np.full(nb * BK, np.nan, np.float32), np.full(nb * BK, np.nan, np.float32)
    copy_raw(sr, x.ravel(), In, In, b0, k0, B, nb, width)
    reads, writes = split_stage(sh, sl, sr, "wgrad", nb)
    xt = np.zeros((nb, BK), np.float32)           # the pre-pass's (In, B) copy, this tile
    cols, ks = min(nb, In - b0), min(BK, B - k0)
    xt[:cols, :ks] = x[k0:k0 + ks, b0:b0 + cols].T
    hi, lo = split_tf32(xt)
    assert np.array_equal(read_kmajor(sh, nb).view(np.uint32), hi.view(np.uint32))
    assert np.array_equal(read_kmajor(sl, nb).view(np.uint32), lo.view(np.uint32))
    # banks: each of a warp's four raw reads takes 32 neighbouring words (32
    # banks); each quarter-warp's 16-byte writes fall in 8 distinct units
    # of the 128-byte bank cycle
    for rw, ww in zip(reads, writes):
        for q in range(4):
            assert len({words[q] % 32 for words in rw}) == 32
        for quarter in range(4):
            assert len({(off // 16) % 8 for off in ww[8 * quarter:8 * quarter + 8]}) == 8


# the A operand (W of the forward, e of the wgrad: (K, MA) row-major, raw):
# the fragment thread (w, g, t) loads at k-lines t and t + 4 holds the
# columns 16w + 2g and 16w + 2g + 1 of its warpgroup's 64, the A rows g and
# g + 8 of its warp that the epilogue writes as those columns; a
# half-warp's 8-byte loads fall in 8 distinct 16-byte units of the bank
# cycle; copies of 4 (135 columns), 8 and 16 bytes
@pytest.mark.parametrize("MA,K,a0,k0,width,wg", [(1024, 598, 960, 576, 16, 1),
                                                 (135, 960, 128, 928, 4, 1),
                                                 (500, 368, 384, 352, 8, 2)])
def test_a_fragments_are_the_epilogue_columns(MA, K, a0, k0, width, wg):
    a = _tile_data(K, MA, MA + K)
    sa = np.full(wg * BK * A_LINE // 4, np.nan, np.float32)
    copy_a(sa, a.ravel(), MA, MA, a0, k0, K, wg, width)
    full = np.zeros((BK, 64 * wg), np.float32)
    ks, cols = min(BK, K - k0), min(64 * wg, MA - a0)
    full[:ks, :cols] = a[k0:k0 + ks, a0:a0 + cols]
    for wgi in range(wg):
        for w in range(4):
            for half in range(2):
                units = set()
                for lane in range(16 * half, 16 * half + 16):
                    g, t = lane >> 2, lane & 3
                    off = (wgi * BK * A_LINE + t * A_LINE
                           + ((((4 * w + (g >> 1)) ^ (t << 1)) << 4) | ((g & 1) << 3)))
                    units.add((off // 16) % 8)
                    for kk in range(BK // 8):
                        for dk in (0, 4):
                            o = (off + (8 * kk + dk) * A_LINE) // 4
                            col = 64 * wgi + 16 * w + 2 * g   # A rows g and g + 8
                            assert sa[o] == full[8 * kk + dk + t, col]
                            assert sa[o + 1] == full[8 * kk + dk + t, col + 1]
                assert len(units) == 8


# --------------------------------------------------------------------------
# the arithmetic
# --------------------------------------------------------------------------

def cp_gemm(a, b, k_chunk):
    """out^T = a @ b as the kernel sums it: a the register operand (rows of
    out^T), split in registers; each k8 step a_lo b_hi, a_hi b_lo, a_hi
    b_hi into the f32 accumulator; split-K partials over chunks of k_chunk
    summed in split order, each sum rounded on its own."""
    ah, al = (torch.from_numpy(v) for v in split_tf32(a.numpy()))
    bh, bl = (torch.from_numpy(v) for v in split_tf32(b.numpy()))
    parts = []
    for c0 in range(0, a.shape[1], k_chunk):
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
        for k in range(c0, min(c0 + k_chunk, a.shape[1]), 8):
            s = slice(k, min(k + 8, c0 + k_chunk))
            acc = acc + al[:, s] @ bh[s]
            acc = acc + ah[:, s] @ bl[s]
            acc = acc + ah[:, s] @ bh[s]
        parts.append(acc)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


# depth -> (which, the recipe shape whose plan gives the split); narrow
# widths here, the recipe's contraction and split
DEPTHS = {368: ("forward", (1024, 500, 368)), 598: ("forward", (284, 1024, 598)),
          960: ("wgrad", (598, 1024, 960)), 1024: ("wgrad", (368, 500, 1024))}


@pytest.mark.parametrize("depth", sorted(DEPTHS))
def test_term_order_within_phase3_tolerance(depth):
    which, (M, N, K) = DEPTHS[depth]
    p = tile_plan.plan(M, N, K, M if which == "wgrad" else K, N, 1 << 20, 1 << 21,
                       wgrad=which == "wgrad")
    assert p.route == CP and K == depth
    rng = np.random.default_rng(depth)
    if which == "forward":
        x = torch.from_numpy(rng.standard_normal((40, K)).astype(np.float32))
        w = torch.from_numpy((rng.standard_normal((K, 48)) / math.sqrt(K)).astype(np.float32))
        ref = x.double() @ w.double()
        z = cp_gemm(w.T.contiguous(), x.T.contiguous(), p.k_chunk).T.double()
        assert (z - ref).abs().max().item() <= 1e-4 * max(ref.abs().max().item(), 1.0) / 10
        assert (torch.sigmoid(z) - torch.sigmoid(ref)).abs().max().item() <= 1e-4 / 10
    else:
        x = torch.from_numpy(rng.standard_normal((K, 40)).astype(np.float32))
        e = torch.from_numpy((rng.standard_normal((K, 48)) / math.sqrt(K)).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal((40, 48)).astype(np.float32))
        ref = x.double().T @ e.double() + 0.9 * v.double()
        corr = cp_gemm(e.T.contiguous(), x, p.k_chunk).T.double() + 0.9 * v.double()
        assert (corr - ref).abs().max().item() <= 1e-5 * ref.abs().max().item() / 5
    if p.splits > 1:   # the split order is part of the sum: one chunk differs
        assert p.k_chunk < K


# --------------------------------------------------------------------------
# the WS_WGMMA route: the warp-specialised ring (cp_tf32_wgmma.cuh)
# --------------------------------------------------------------------------

WS_NB = 136   # the weight gradient's N width (tile_plan.WS_ROWS_WIDTHS)


# the ring as built (4 stages) and gemm_ceiling's ws_rows_ring3 candidate
@pytest.mark.parametrize("stages", [tile_plan.WS_ROWS_STAGES, 3])
def test_ws_ring_fits_a_block_and_one_an_sm(stages):
    smem = tile_plan.ws_f32_smem_bytes(WS_NB, stages)
    nb = WS_NB
    stage = BK * A_LINE + 2 * nb * B_ROW
    assert smem == stages * stage + (stages - 1) * nb * B_ROW + 16 * stages + 1024
    assert smem <= 227 * 1024
    assert smem + 16 + tile_plan.BLOCK_SMEM_RESERVED <= tile_plan.SM_SMEM
    # the consumers' stash of partials (128 threads x nb / 2 floats) fits
    # the ring; every slot starts on a 1024-byte boundary
    assert 128 * (nb // 2) * 4 <= stages * stage
    assert stage % 1024 == 0 and (nb * B_ROW) % 1024 == 0
    assert tile_plan.ws_f32_smem_bytes() == tile_plan.ws_f32_smem_bytes(
        tile_plan.TILES[tile_plan.ROWS][1], tile_plan.WS_ROWS_STAGES)


# each substitution of gemm_ceiling's WS builds finds its text once in the
# sources, and the ring candidate swaps the stage count the plan knows
@pytest.mark.parametrize("name", ["ws", "ws_rows_ring3", "ws_batch2", "ws_mainloop"])
def test_ws_variants_find_their_lines(name):
    from nnet_asr_torch.tools.gemm_ceiling import WS_ROWS_TILE, WS_VARIANTS

    for fname, old, new in WS_VARIANTS[name]:
        with open(os.path.join(_build.CSRC, fname)) as f:
            assert f.read().count(old) == 1 and new != old
    assert WS_ROWS_TILE == (f"using WsF32Rows = WsF32Tile<{WS_NB}, "
                            f"{tile_plan.WS_ROWS_STAGES}>;")


def copy_rows(smem, src, ncols, k0, k_end, width):
    """load_b_rows: k-lines k0 .. k0 + BK of src (ncols floats a row, no
    padding) as one run of bytes in units of ``width``, the rest of the
    stage zero (a unit past k_end keeps none of its bytes)."""
    units = BK * ncols * 4 // width
    run = (min(k_end, k0 + BK) - k0) * ncols * 4
    base = k0 * ncols
    for u in range(units):
        off = u * width
        valid = max(0, min(width, run - off))
        seg = np.zeros(width // 4, np.float32)
        seg[:valid // 4] = src[base + off // 4:base + off // 4 + valid // 4]
        smem[off // 4:off // 4 + width // 4] = seg


def ws_split_rows(sh, sl, sr, pitch, nb, producers=128):
    """ws_split in ROWS: the producer's thread idx takes unit u of B row j
    (k 4u .. 4u + 3 of raw column j, raw k-lines at ``pitch``); returns,
    for each warp's pass, the (u, raw words) of each lane, for the banks."""
    units = nb * 8
    reads = []
    for l in range(-(-units // producers)):
        for warp in range(producers // 32):
            rw = []
            for lane in range(32):
                idx = warp * 32 + lane + l * producers
                if idx >= units:
                    continue
                j, u = idx % nb, idx // nb
                words = [(4 * u + q) * pitch + j for q in range(4)]
                rw.append((u, words))
                hi, lo = split_tf32(sr[words])
                off = j * B_ROW + ((u ^ (j & 7)) << 4)
                sh[off // 4:off // 4 + 4] = hi
                sl[off // 4:off // 4 + 4] = lo
            reads.append(rw)
    return reads


# e (B, Out) of the weight gradient, one tile of 136 columns: a whole stage,
# the bunch's last 32 rows, a stage the bunch ends inside (283 - 256 = 27
# rows), 4-byte units (an unaligned base); Out 135, 39 and 130
@pytest.mark.parametrize("B,Out,k0,width", [(960, 135, 0, 16), (960, 135, 928, 16),
                                            (283, 39, 256, 16), (300, 130, 288, 4),
                                            (67, 135, 64, 8)])
def test_ws_rows_run_and_transposing_split_give_the_prepass_bits(B, Out, k0, width):
    e = _tile_data(B, Out, B + Out)
    sr = np.full(WS_NB * BK, np.nan, np.float32)   # the raw slot: 136 k-lines' worth
    copy_rows(sr, e.ravel(), Out, k0, B, width)
    sh, sl = np.full(WS_NB * BK, np.nan, np.float32), np.full(WS_NB * BK, np.nan, np.float32)
    reads = ws_split_rows(sh, sl, sr, Out, WS_NB)
    # every word read lies in the raw slot; a warp's loads fall in 32
    # distinct banks (neighbouring columns of one k-line), but where its 32
    # units straddle two k-groups (136 columns are no multiple of 32): at
    # most two lanes a bank there
    assert max(w for rw in reads for _, words in rw for w in words) < WS_NB * BK
    for rw in (rw for rw in reads if rw):
        straddles = len({u for u, _ in rw}) > 1
        for q in range(4):
            banks = [words[q] % 32 for _, words in rw]
            worst = max(banks.count(b) for b in banks)
            assert worst == 1 or (straddles and worst <= 2)
    # the pre-pass's bits, e^T split, zero past the bunch; columns past Out
    # (the padded N) read whatever lies there and are dropped by the epilogue
    rows = min(BK, B - k0)
    want = np.zeros((Out, BK), np.float32)
    want[:, :rows] = e[k0:k0 + rows].T
    hi, lo = split_tf32(want)
    np.testing.assert_array_equal(read_kmajor(sh, WS_NB)[:Out], hi)
    np.testing.assert_array_equal(read_kmajor(sl, WS_NB)[:Out], lo)


def test_ws_stash_slots_are_the_fragments(nb=WS_NB):
    """ws_stash writes float4 i of consumer thread tid at i * 128 + tid, and
    the thread's acc[4i + 2h + e] is out^T at A row (as col_of deals them)
    16 w + 2 g + h, B column 8 i + 2 t + e; ws_sum's slot of row pair q and
    (i, t) must read that same element."""
    consumers = 128
    frag = {}
    for tid in range(consumers):
        w, g, t = tid // 32, (tid % 32) // 4, tid % 4
        for i in range(nb // 8):
            for h in (0, 1):
                for e in (0, 1):
                    frag[(i * consumers + tid) * 4 + 2 * h + e] = (16 * w + 2 * g + h,
                                                                  8 * i + 2 * t + e)
    epi = {}
    for q in range(32):
        for i in range(nb // 8):
            for t in range(4):
                for h in (0, 1):
                    for e in (0, 1):
                        epi[(i * consumers + 4 * q + t) * 4 + 2 * h + e] = (2 * q + h,
                                                                           8 * i + 2 * t + e)
    assert epi == frag and len(frag) == consumers * nb // 2
    assert len(set(frag.values())) == len(frag)   # every element of the tile once


@pytest.mark.parametrize("lines", [32, 68])
def test_ws_cluster_shares_cover_every_line_once(lines):
    """Each of a cluster's S blocks writes lines [r per, min(L, (r + 1)
    per)), per = ceil(L / S): together every line once, for 1 to 8 splits."""
    for splits in range(1, 9):
        per = -(-lines // splits)
        got = [k for r in range(splits) for k in range(r * per, min(lines, (r + 1) * per))]
        assert got == list(range(lines))


# ws_update_pv over a cluster of S blocks: block r takes row pairs [r per,
# min(32, (r + 1) per)) of the tile's 64 rows of p, each across the 68
# column pairs of 136 columns; every element of p within In x Out once, the
# columns past Out (and rows past In) dropped
@pytest.mark.parametrize("In,Out", [(1024, 135), (500, 39), (61, 129), (1, 1), (300, 136)])
def test_ws_update_writes_every_element_of_p_once(In, Out):
    pairs, slots = 32, WS_NB // 2
    for splits in (1, 2, 6):
        seen = []
        per = -(-pairs // splits)
        for in0 in range(0, In, 64):
            for rank in range(splits):
                lo = rank * per
                for k in range(max(0, min(pairs, lo + per) - lo) * slots):
                    q, slot = lo + k // slots, k % slots
                    r0, c0 = in0 + 2 * q, 2 * slot
                    seen += [(r0 + c // 2, c0 + c % 2) for c in range(4)
                             if r0 + c // 2 < In and c0 + c % 2 < Out]
        assert sorted(seen) == [(r, c) for r in range(In) for c in range(Out)]


# (M, N, K, wgrad) -> (route, tile, splits, N width) of every recipe shape
# of the f32 kernels: MLP3's forward and both weight gradients, TIMIT's
# forward and weight gradients, a 2x2 mesh rank's and one tmpe utterance's
# rows, the RBM recipe's 960x1024->1024. The weight gradient of 135 outputs
# takes the WS_WGMMA route with Out on wgmma's N, 135 rounded up to 136;
# TIMIT's 39 (40 wide: no kernel built for it) keeps mma.sync
RECIPE_ROUTES = {
    (960, 1024, 598, False): (CP, HALF, 1, None),
    (598, 1024, 960, True): (CP, HALF, 3, None),
    (1024, 135, 960, True): (WS, tile_plan.ROWS, 6, 136),
    (1024, 500, 368, False): (CP, HALF, 2, None),
    (368, 500, 1024, True): (CP, HALF, 5, None),
    (500, 39, 1024, True): (MMA_SYNC, SMALL, 8, None),
    (480, 1024, 598, False): (CP, HALF, 2, None),
    (284, 1024, 598, False): (CP, HALF, 3, None),
    (960, 1024, 1024, False): (CP, HALF, 1, None),
}


@pytest.mark.parametrize("shape", sorted(RECIPE_ROUTES))
def test_ws_route_rule_at_recipe_shapes(shape):
    from nnet_asr_torch.tools.gemm_ceiling import without_ws

    M, N, K, wgrad = shape
    a_pitch = M if wgrad else K
    p = tile_plan.plan(M, N, K, a_pitch, N, 1 << 20, 1 << 21, wgrad=wgrad,
                       out_ptrs=(1 << 22, 1 << 23))
    route, tile, splits, width = RECIPE_ROUTES[shape]
    assert (p.route, p.tile, p.splits) == (route, tile, splits)
    assert (p.route == WS) == tile_plan.ws_f32_takes(M, N, K, wgrad, N)
    with without_ws():
        q = tile_plan.plan(M, N, K, a_pitch, N, 1 << 20, 1 << 21, wgrad=wgrad,
                           out_ptrs=(1 << 22, 1 << 23))
    if p.route != WS:   # a shape the route refuses keeps its plan
        assert q == p
        return
    # an odd Out: N rounded up to a multiple of 8, one tile across it; the
    # route it replaces is the mma.sync plan it had
    assert N % 2 == 1 and p.bn == width == tile_plan.ws_rows_width(N) and width % 8 == 0
    assert width - 8 < N <= width and tile_plan.tile_count(M, N, p.tile) == -(-M // 64)
    assert q.route == MMA_SYNC and tile_plan.cp_f32_keeps_mma_sync(wgrad, N)
    assert p.splits == tile_plan.ws_splits(M, N, K) <= tile_plan.WS_MAX_SPLITS
    assert p.blocks == tile_plan.tile_count(M, N, p.tile) * p.splits
    assert p.k_chunk % BK == 0 and p.k_chunk * (p.splits - 1) < K <= p.k_chunk * p.splits
    # e's stage is BK whole rows, one run from a 16-byte aligned base
    assert p.b_bytes == tile_plan.ws_rows_e_bytes(N, 1 << 21) == 16


@pytest.mark.parametrize("out", [1, 7, 8, 9, 39, 127, 129, 135, 136, 137, 1024])
def test_ws_rows_width_and_copy(out):
    width = tile_plan.ws_rows_width(out)
    assert width % 8 == 0 and width - 8 < out <= width
    takes = tile_plan.ws_f32_takes(1024, out, 960, True, out)
    assert takes == (out % 2 == 1 and width in tile_plan.WS_ROWS_WIDTHS)
    assert not tile_plan.ws_f32_takes(1024, out, 960, False, out)   # never the forward
    # the route only where one 136-wide tile spans Out; e's copy width by
    # the base alone (the stage is one run starting on a 128-byte multiple)
    assert not takes or out <= WS_NB
    for base, want in ((1 << 20, 16), ((1 << 20) + 8, 8), ((1 << 20) + 4, 4)):
        assert tile_plan.ws_rows_e_bytes(out, base) == want

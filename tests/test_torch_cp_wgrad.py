"""The bf16 CP_WGMMA weight gradient (``csrc/cp_wgmma.cuh``'s
``wgrad_mainloop``, ``csrc/sgd_fused.cu``'s
``wgrad_momentum_bf16_cp_wgmma_kernel``) on the CPU.

The kernel runs only on the card; what surrounds it is held here:

- ``tile_plan.plan``'s plan of it at the recipes' shapes and the shapes
  the card tests use (tile, splits, k_chunk, copy widths, grid), and its
  split rule: one wave of blocks, a cluster of at most
  ``CP_WGRAD_MAX_CLUSTER``;
- the ring's shared memory against a block's and an SM's, for the tiles
  built and the ring ``tools/gemm_ceiling.py --small --bf16-wgrad`` builds;
- the byte layouts, emulated with numpy from the kernel's index
  arithmetic: x's ``cp.async`` runs into the M-major box, e's stage of
  whole rows copied as one run and realigned into the N-major boxes of the
  ROWS tile, read back through the layout wgmma's descriptors read; the
  fragments' stash and the update's chunks, over a cluster's shares, reach
  every element of p once and read g where the fragments left it; a warp's
  shared-memory accesses and their banks.
"""

import os

import numpy as np
import pytest

from nnet_asr_torch.ops.kernels import _build, tile_plan
from nnet_asr_torch.tools.gemm_ceiling import CPW_ROWS, cpw_variants

SMALL, ROWS, CP = tile_plan.SMALL, tile_plan.ROWS, tile_plan.CP_WGMMA
BK, LINE, BOX = 64, 128, 8192          # cp_wgmma.cuh BK, LINE, BOX
THREADS = 128


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

# (In, Out, B) -> (tile, splits, k_chunk, x bytes, e bytes, blocks), x and e
# from aligned bases. MLP3's 598->1024: 160 tiles of 64x64, 4 blocks an SM
# by shared memory, so 3 splits of 5 steps in one wave (480 blocks of
# 528); x's rows of 1,196 bytes take 4-byte copies. MLP3's 1024->135: 16
# ROWS tiles, one block an SM, a cluster of at most 6 splits: k_chunk of 3
# steps, which 5 splits cover. The rest: the card tests' ragged shapes (a
# bunch of one or two steps stays whole; 961 rows, 16 steps of 64: 6
# splits of 3 steps, the last one row), the 1,002-wide e of 4-byte units
# on column tiles.
CPW_PLANS = {
    (598, 1024, 960): (SMALL, 3, 320, 4, 16, 480),
    (1024, 135, 960): (ROWS, 5, 192, 16, 16, 80),
    (598, 1, 64): (ROWS, 1, 64, 4, 16, 10),
    (598, 8, 100): (ROWS, 1, 100, 4, 16, 10),
    (1000, 135, 961): (ROWS, 6, 192, 16, 16, 96),
    (598, 136, 960): (ROWS, 5, 192, 4, 16, 50),
    (598, 1024, 100): (SMALL, 1, 100, 4, 16, 160),
    (1000, 1002, 283): (SMALL, 2, 192, 16, 4, 512),
}


@pytest.mark.parametrize("shape", sorted(CPW_PLANS))
def test_bf16_cp_wgrad_plan(shape):
    In, Out, B = shape
    p = tile_plan.plan(In, Out, B, In, Out, 1 << 20, 1 << 21, wgrad=True, elem=2,
                       out_ptrs=(1 << 22, 1 << 23))
    tile, splits, k_chunk, a_bytes, b_bytes, blocks = CPW_PLANS[shape]
    assert p == tile_plan.Plan(tile, *tile_plan.TILES[tile], splits, k_chunk, a_bytes, b_bytes,
                               CP, blocks)
    # whole CP_BK steps a split, the splits covering the bunch
    assert k_chunk * (splits - 1) < B <= k_chunk * splits
    assert splits == 1 or k_chunk % tile_plan.CP_BK == 0


# The split rule at both of MLP3's weights and every bunch of 64 to 1024
# rows: the blocks of one launch fit one wave at the blocks an SM the
# tile's shared memory allows, a cluster holds at most CP_WGRAD_MAX_CLUSTER
# splits, each split two steps at least; and one split more would break
# one of them
@pytest.mark.parametrize("In,Out", [(598, 1024), (1024, 135), (1000, 1), (66, 8)])
def test_bf16_cp_wgrad_split_rule(In, Out):
    tile = tile_plan.cp_wgrad_tile(Out, In, Out, 0, 0)
    per_sm = tile_plan.SM_SMEM // (tile_plan.cp_wgrad_smem_bytes(tile)
                                   + tile_plan.BLOCK_SMEM_RESERVED)
    tiles = tile_plan.tile_count(In, Out, tile)
    for B in range(64, 1025, 37):
        s = tile_plan.cp_wgrad_splits(In, Out, B, tile)
        steps = -(-B // tile_plan.CP_BK)

        def ok(k):
            return (tiles * k <= per_sm * tile_plan.SM_COUNT
                    and k <= tile_plan.CP_WGRAD_MAX_CLUSTER and -(-steps // k) >= 2)

        assert ok(s) or s == 1
        assert not ok(s + 1)


# The route leaves every f32 plan and every bf16 forward and production plan
# as it was: with the weight gradient's tile rule refusing everything, the
# plans of the main paths' shapes are the same
@pytest.mark.parametrize("shape", [(960, 598, 1024), (960, 1024, 135), (1024, 1024, 4096),
                                   (1024, 4096, 4096), (1024, 4096, 8192), (1024, 368, 500),
                                   (1024, 500, 39), (284, 598, 1024), (480, 598, 1024)])
@pytest.mark.parametrize("elem", [2, 4])
def test_bf16_cp_wgrad_leaves_other_plans_alone(shape, elem, monkeypatch):
    B, In, Out = shape
    for M, N, K, ap, bp, wgrad in ((B, Out, In, In, Out, False), (In, Out, B, In, Out, True)):
        got = tile_plan.plan(M, N, K, ap, bp, 256, 512, wgrad=wgrad, elem=elem)
        with monkeypatch.context() as mp:
            mp.setattr(tile_plan, "cp_wgrad_tile", lambda *a, **k: None)
            before = tile_plan.plan(M, N, K, ap, bp, 256, 512, wgrad=wgrad, elem=elem)
        if elem == 2 and wgrad and before.route == tile_plan.MMA_SYNC:
            assert got.route == CP   # MLP3's two weights: the route's own
        else:
            assert got == before


# --------------------------------------------------------------------------
# shared memory
# --------------------------------------------------------------------------

def _ring(bn, stages):
    """CpWgradTile's ring: stages of x's box (64 k-lines of 64 In) and e's
    N-major boxes (the ROWS tile's 136 columns in three), the ROWS tile's
    stages - 2 raw slots of 64 rows of 136 bf16."""
    b = -(-bn // 64) * BOX
    return stages * (BOX + b) + ((stages - 2) * BK * bn * 2 if bn == 136 else 0)


# the tiles built (64x64 at 3 stages, ROWS at 4) and gemm_ceiling's ROWS at
# 5: the ring and its slack fit a block, as many blocks an SM as the split
# rule counts on (MIN_BLOCKS of the tile: 4, 1); the stash of f32 partials
# fits the ring; stages start on 1024-byte boundaries (the swizzle's phase)
@pytest.mark.parametrize("tile,stages,per_sm", [(SMALL, 3, 4), (ROWS, 4, 1), (ROWS, 5, 1)])
def test_bf16_cp_wgrad_ring_fits(tile, stages, per_sm):
    bm, bn = tile_plan.TILES[tile]
    smem = tile_plan.cp_wgrad_smem_bytes(tile, stages)
    assert smem == _ring(bn, stages) + 1024 <= 227 * 1024
    assert tile_plan.SM_SMEM // (smem + tile_plan.BLOCK_SMEM_RESERVED) == per_sm
    assert 228 * 1024 // (smem + 1024) == per_sm          # the kernel's MIN_BLOCKS
    assert bm * (bn + 8) * 4 <= _ring(bn, stages)          # the stash at pitch SP
    assert (BOX + -(-bn // 64) * BOX) % 1024 == 0
    if stages == tile_plan.CP_WGRAD_STAGES[tile]:
        assert smem == tile_plan.cp_wgrad_smem_bytes(tile)


# the shipped tiles are the plan's; each substitution of gemm_ceiling's
# builds finds its line once in the sources
@pytest.mark.parametrize("name", sorted(cpw_variants()))
def test_cpw_variants_find_their_lines(name):
    with open(os.path.join(_build.CSRC, "sgd_fused.cu")) as f:
        src = f.read()
    cols = tile_plan.CP_WGRAD_TILE
    assert (f"using CpWgradCols = nnet_cpw::CpWgradTile<{tile_plan.TILES[cols][1]}, "
            f"{tile_plan.CP_WGRAD_STAGES[cols]}>;") in src
    assert CPW_ROWS == (f"using CpWgradRows = nnet_cpw::CpWgradTile<136, "
                        f"{tile_plan.CP_WGRAD_STAGES[ROWS]}>;")
    subs, attrs = cpw_variants()[name]
    for fname, old, new in subs:
        with open(os.path.join(_build.CSRC, fname)) as f:
            assert f.read().count(old) == 1 and new != old
    assert set(attrs) <= {"CP_WGRAD_STAGES"}


# --------------------------------------------------------------------------
# layouts, emulated from the kernel's index arithmetic
# --------------------------------------------------------------------------

def _bf16_bits(rows, cols, seed):
    """Random nonzero 16-bit patterns: a byte moved or zeroed shows."""
    return np.random.default_rng(seed).integers(1, 1 << 16, (rows, cols), dtype=np.uint16)


def load_mn(smem, src, ncols, n0, k0, k_end, width, bytes_):
    """load_mn<WIDTH, 128, BYTES>: k-lines k0.. of src (pitch ncols bf16),
    columns n0 .. n0 + width, into smem (uint16) by 128 threads."""
    runs = 2 * width // bytes_
    for idx in range(BK * runs):
        r, byte = idx // runs, (idx % runs) * bytes_
        n, in_box = n0 + byte // 2, byte % LINE
        dst = (byte // LINE) * BOX + r * LINE + (((in_box >> 4) ^ (r & 7)) << 4) + (in_box & 15)
        ok = k0 + r < k_end and n < ncols
        for h in range(bytes_ // 2):
            smem[dst // 2 + h] = src[k0 + r, n + h] if ok else 0


def read_mn(smem, width):
    """What an MN-major descriptor (128-byte swizzle, LBO one box) reads:
    element (k, n) at box n / 64, line k, unit ((n % 64) / 8) ^ (k % 8)."""
    out = np.zeros((BK, width), np.uint16)
    for k in range(BK):
        for n in range(width):
            off = (n // 64) * BOX + k * LINE + ((((n % 64) // 8) ^ (k % 8)) << 4) + 2 * (n % 8)
            out[k, n] = smem[off // 2]
    return out


# x of the weight gradient, M-major: 4-byte copies of 598-wide rows (the
# last box ragged: 598 - 576 = 22 columns), 16-byte of 1024; a stage the
# split ends inside
@pytest.mark.parametrize("In,m0,k0,k_end,bytes_", [(598, 576, 0, 960, 4), (598, 0, 896, 960, 4),
                                                   (1024, 960, 128, 150, 16), (66, 64, 0, 64, 4)])
def test_x_stage_is_the_m_major_box(In, m0, k0, k_end, bytes_):
    x = _bf16_bits(960, In, In)
    smem = np.full(BOX // 2, 0xFFFF, np.uint16)
    load_mn(smem, x, In, m0, k0, k_end, 64, bytes_)
    want = np.zeros((BK, 64), np.uint16)
    rows, cols = max(0, min(BK, k_end - k0)), min(64, In - m0)
    want[:rows, :cols] = x[k0:k0 + rows, m0:m0 + cols]
    np.testing.assert_array_equal(read_mn(smem, 64), want)


def load_run(raw, e, out, k0, k_end):
    """load_run: BK rows of e (out bf16 a row) from row k0 as one run of
    16-byte copies into raw (uint16), zero past k_end."""
    flat = e.ravel()
    units = BK * out // 8
    run = (min(k_end, k0 + BK) - k0) * out * 2
    for u in range(units):
        off, valid = 16 * u, max(0, min(16, run - 16 * u))
        seg = np.zeros(8, np.uint16)
        seg[:valid // 2] = flat[k0 * out + off // 2:k0 * out + off // 2 + valid // 2]
        raw[off // 2:off // 2 + 8] = seg


def realign_rows(sb, raw, out, bn=136):
    """realign_rows: unit idx of a thread is (r = idx / 17, c = idx % 17),
    the 8 bf16 of k-line r from column 8c, read as 4 words of raw (5,
    shifted by a half, where the unit starts mid-word), columns past out
    zero, into box c / 8, line r, unit (c % 8) ^ (r % 8); returns each
    warp's (raw words a lane reads, B byte offset it writes)."""
    words = np.zeros(len(raw) // 2 + 8, np.uint32)
    words[:len(raw) // 2] = raw[0::2].astype(np.uint32) | (raw[1::2].astype(np.uint32) << 16)
    cu = bn // 8
    units, warps = BK * cu, []
    for l in range(-(-units // THREADS)):
        for w in range(THREADS // 32):
            acc = []
            for lane in range(32):
                idx = w * 32 + lane + l * THREADS
                if idx >= units:
                    continue
                r, c = idx // cu, idx % cu
                h0 = r * out + 8 * c
                q = [h0 // 2 + j for j in range(5 if h0 & 1 else 4)]
                v = [int(words[i]) for i in q] + [0]
                halves = []
                for j in range(4):
                    word = ((v[j] >> 16) | (v[j + 1] << 16)) & 0xFFFFFFFF if h0 & 1 else v[j]
                    halves += [word & 0xFFFF, word >> 16]
                halves = [hv if 8 * c + j < out else 0 for j, hv in enumerate(halves)]
                off = (c // 8) * BOX + r * LINE + (((c % 8) ^ (r & 7)) << 4)
                sb[off // 2:off // 2 + 8] = halves
                acc.append((q, off))
            if acc:
                warps.append(acc)
    return warps


# e's stage on the ROWS tile, N-major: the raw rows realigned into the
# boxes wgmma reads with Out on its N (136 columns, the third box holding
# 8); MLP3's 135 columns (odd k-lines start mid-word), a stage the bunch
# ends inside, Out 1, 8 and 136
@pytest.mark.parametrize("B,Out,k0", [(960, 135, 0), (960, 135, 896), (961, 135, 960),
                                      (100, 1, 64), (700, 8, 640), (960, 136, 128)])
def test_rows_run_realigned_give_e_n_major(B, Out, k0):
    e = _bf16_bits(B, Out, B + Out)
    raw = np.full(BK * 136, 0xFFFF, np.uint16)     # the raw slot (RAW_BYTES)
    load_run(raw, e, Out, k0, B)
    sb = np.full(3 * BOX // 2, 0xFFFF, np.uint16)
    warps = realign_rows(sb, raw, Out)
    want = np.zeros((BK, 136), np.uint16)
    rows = min(BK, B - k0)
    want[:rows, :Out] = e[k0:k0 + rows]
    np.testing.assert_array_equal(read_mn(sb, 136), want)
    # every word read lies in the raw slot (its 8,704 words); a warp's
    # loads of one word position, 32 units 16 bytes apart, touch each bank
    # at most four times (the wavefronts of one 16-byte load a lane); its
    # stores take at most six wavefronts for 512 bytes (four at best)
    assert max(i for w in warps for q, _ in w for i in q) < BK * 136 // 2
    for w in warps:
        for j in range(4):
            banks = [wd % 32 for wd in {q[j] for q, _ in w}]
            assert max(banks.count(b) for b in banks) <= 4
        banks = [((off // 4) + q) % 32 for _, off in w for q in range(4)]
        assert max(banks.count(b) for b in banks) <= 6


def fragment(tid, i, h, e_):
    """(row, column) of the tile that acc[4i + 2h + e] of thread tid holds
    (wgmma's m64nNk16 accumulator layout)."""
    lane = tid % 32
    return 16 * (tid // 32) + lane // 4 + 8 * h, 8 * i + 2 * (lane % 4) + e_


# stash_acc and cp_update: the fragments into the stash (a column tile at
# pitch SP, the ROWS tile flat at r * Out + c, columns past Out dropped),
# then a cluster of S blocks each updating chunks [r per, (r + 1) per) of 4
# elements; every element of p within In x Out once, and each reads g
# where the fragments put it
@pytest.mark.parametrize("tile,In,Out,m0,n0", [(SMALL, 598, 1024, 576, 960),
                                               (SMALL, 1000, 1002, 960, 960),
                                               (ROWS, 1024, 135, 0, 0), (ROWS, 598, 135, 576, 0),
                                               (ROWS, 100, 1, 64, 0), (ROWS, 66, 136, 64, 0)])
def test_stash_and_update_chunks_cover_the_tile_once(tile, In, Out, m0, n0):
    bm, bn = tile_plan.TILES[tile]
    rows_tile = tile == ROWS
    sp = bn + 8
    stash = {}
    for tid in range(THREADS):
        for i in range(bn // 8):
            for h in (0, 1):
                for e_ in (0, 1):
                    r, c = fragment(tid, i, h, e_)
                    if rows_tile and c >= Out:
                        continue
                    stash[r * Out + c if rows_tile else r * sp + c] = (r, c)
    assert len(stash) == bm * (min(bn, Out) if rows_tile else bn)
    rows, cols = min(bm, In - m0), min(bn, Out - n0)
    chunks = -(-rows * Out // 4) if rows_tile else bm * (bn // 4)
    for splits in (1, 3, 5, 6):
        per = -(-chunks // splits)
        seen = []
        for rank in range(splits):
            lo = min(chunks, rank * per)
            for k in range(lo, min(chunks, lo + per)):
                if rows_tile:
                    so, go, n = 4 * k, m0 * Out + 4 * k, min(4, rows * Out - 4 * k)
                else:
                    r, c = k // (bn // 4), 4 * (k % (bn // 4))
                    if not (r < rows and c < cols):
                        continue
                    so, go, n = r * sp + c, (m0 + r) * Out + n0 + c, min(4, cols - c)
                for j in range(n):
                    r, c = stash[so + j]
                    assert (m0 + r) * Out + n0 + c == go + j   # g where p is
                    seen.append(go + j)
        assert sorted(seen) == sorted((m0 + r) * Out + n0 + c
                                      for r in range(rows) for c in range(cols))


# a column tile's stash stores: each half-warp's float2 stores (words r *
# SP + c and c + 1 for its 4 rows of 4 column pairs) fall in 32 distinct
# banks at SP = 72 (64x64)
@pytest.mark.parametrize("bn", [64])
def test_column_stash_stores_fall_in_distinct_banks(bn):
    sp = bn + 8
    for tid0 in range(0, THREADS, 16):
        for i in range(bn // 8):
            for h in (0, 1):
                words = []
                for tid in range(tid0, tid0 + 16):
                    r, c = fragment(tid, i, h, 0)
                    words += [r * sp + c, r * sp + c + 1]
                assert sorted(w % 32 for w in words) == list(range(32))

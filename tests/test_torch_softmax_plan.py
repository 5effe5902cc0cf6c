"""The softmax-CE kernel's launch plan and its arithmetic, on the CPU.

``softmax_plan.plan`` fixes how ``csrc/softmax_ce.cu`` cuts a (B, C) batch
of logits; the kernel itself runs only on the card, where
tests/test_torch_cuda.py holds it to the plain version. Here:

- every C from 1 to 600 and some wider rows, at base offsets of 0-3 floats,
  get a plan whose column partition covers each column of a row exactly
  once, with 16-byte accesses only for C % 4 == 0 and an aligned base, and
  whose rows are shared out among the blocks exactly once;
- the main path's shapes get the variants the design names;
- a numpy emulation of the kernel's arithmetic in float32, in its fixed
  reduction order (within a thread, each warp's butterfly, one butterfly
  over the warps; the rows of a row group in order, the groups of a block
  in order; in the last block, thread t's partials t, t + T, ..., then the
  butterflies), matches ``softmax_xent_plain``: err within 1e-6, xent
  within 1e-5 relative, correct equal, NaN rows included (NaN err, NaN
  xent when labelled, no hit).
"""

import numpy as np
import pytest
import torch

from nnet_asr_torch.ops.kernels import softmax_plan as SP
from nnet_asr_torch.ops.kernels.softmax_ce import softmax_xent_plain

torch.set_num_threads(2)

F = np.float32
ALIGNED = 1 << 20          # a 16-byte aligned base address
WIDTHS = list(range(1, 601)) + [1025, 3001, 8192, 40000]


@pytest.mark.parametrize("offset", range(4))
def test_plan_partitions_each_row(offset):
    for C in WIDTHS:
        p = SP.plan(7, C, ALIGNED + 4 * offset)
        cols = SP.thread_columns(p, C)
        taken = np.sort(cols[cols >= 0])
        assert np.array_equal(taken, np.arange(C)), C
        assert cols.shape[0] == p.row_threads
        whole = p.variant != SP.NARROW or p.vpt % 4 == 0
        assert p.vec == (C % 4 == 0 and offset == 0 and whole), C
        if C <= SP.NARROW_MAX:
            assert (p.variant, p.threads, p.row_threads) == (SP.NARROW, 128, 32)
            assert p.vpt in SP.NARROW_VPT and 32 * p.vpt >= C
            assert p.vpt == 1 or 16 * p.vpt < C                   # the fewest
        elif C <= SP.ROWS_MAX:
            assert p.variant == SP.ROWS and p.vpt == SP.ROWS_VPT
            assert p.threads in (64, 128, 256, 512) and p.threads * p.vpt >= C
            assert p.threads == 64 or p.threads * p.vpt < 2 * C
        else:
            assert (p.variant, p.threads) == (SP.WIDE, SP.WIDE_THREADS)
            assert p.vpt == SP.WIDE_UNROLL * (4 if p.vec else 1)


@pytest.mark.parametrize("B,C", [(1, 1), (37, 135), (960, 135), (5000, 64), (300, 8192),
                                 (1024, 8192), (2000, 1000), (270, 9000)])
def test_plan_shares_out_each_row_once(B, C):
    p = SP.plan(B, C, ALIGNED)
    rows = [r for b in range(p.blocks) for g in SP.block_rows(p, B, b) for r in g]
    assert sorted(rows) == list(range(B))
    assert 1 <= p.blocks <= SP.SM_COUNT * max(1, SP.SM_THREADS // p.threads)
    assert all(len(SP.block_rows(p, B, b)) == p.rows_per_block for b in range(p.blocks))


def test_main_path_shapes_get_their_variants():
    # MLP3's output layer: one warp a row, 4-byte accesses (540-byte rows)
    p = SP.plan(960, 135, ALIGNED)
    assert (p.variant, p.threads, p.vpt, p.vec, p.blocks) == (SP.NARROW, 128, 8, False, 240)
    # the production stack's: the row in a block's registers, 16-byte accesses,
    # two blocks of 512 threads an SM
    p = SP.plan(1024, 8192, ALIGNED)
    assert (p.variant, p.threads, p.vpt, p.vec, p.blocks) == (SP.ROWS, 512, 16, True, 264)
    assert not SP.plan(1024, 8192, ALIGNED + 4).vec
    # past the register limit: two walks (the SWB CD-DNN's 9,304 senones
    # too, 16-byte accesses, two blocks of 512 threads an SM)
    assert SP.plan(1024, 16384, ALIGNED).variant == SP.WIDE
    p = SP.plan(1024, 9304, ALIGNED)
    assert (p.variant, p.threads, p.vpt, p.vec, p.blocks) == (SP.WIDE, 512, 16, True, 264)
    assert SP.plan(1000, 3001, ALIGNED).variant == SP.ROWS


def test_plan_rejects_empty():
    with pytest.raises(ValueError):
        SP.plan(0, 5)
    with pytest.raises(ValueError):
        SP.plan(5, 0)


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated in float32
# ---------------------------------------------------------------------------

LANES = np.arange(32)


def _butterfly(a):
    """Each warp's butterfly sum over the last axis of 32 lanes (the same
    bits end in every lane; lane 0's is returned)."""
    a = np.asarray(a)
    for o in (16, 8, 4, 2, 1):
        a = a + a[..., LANES ^ o]
    return a[..., 0]


def _block_sum(per_thread, one_warp):
    """row_sum_min / block_sum / finish: each warp's butterfly, then (over a
    block) one more over the warps' sums, lane w holding warp w's."""
    warps = _butterfly(per_thread.reshape(-1, 32))
    if one_warp:
        return warps[0]
    lanes = np.zeros(32, per_thread.dtype)
    lanes[:len(warps)] = warps
    return _butterfly(lanes)


def _row_in_registers(x, label, p):
    """NARROW and ROWS: (err row, xent term, hit) as the kernel forms them."""
    C = x.shape[0]
    cols = SP.thread_columns(p, C)                        # (T, VPT)
    v = np.where(cols >= 0, x[np.maximum(cols, 0)], F(-np.inf))
    m = F(np.nan) if np.isnan(x).any() else x.max()
    with np.errstate(invalid="ignore"):
        e = np.exp(v - m)                                 # slots past C: 0
    s = np.zeros(cols.shape[0], F)
    for i in range(cols.shape[1]):                        # each thread, in order
        s = s + e[:, i]
    S = _block_sum(s, p.variant == SP.NARROW)
    inv = F(1) / S
    err = np.empty(C, F)
    err[cols[cols >= 0]] = (e * inv)[cols >= 0]
    picks = 0 <= label < C
    if picks:
        err[label] = np.exp(x[label] - m) * inv - F(1)
    first = C if np.isnan(m) else int(np.argmax(x))
    return err, _xent_term(x, label, m, S) if picks else F(0), int(label >= 0 and first == label)


def _row_wide(x, label, p):
    """WIDE: walk 1's per-thread NaN-propagating max and online sum, then walk 2."""
    C = x.shape[0]
    width = 4 if p.vec else 1
    cols = SP.thread_columns(p, C)                        # (T, steps * U * width)
    T, step = cols.shape[0], SP.WIDE_UNROLL * width
    m = np.full(T, -np.inf, F)
    s = np.zeros(T, F)
    with np.errstate(invalid="ignore"):
        for b in range(0, cols.shape[1], step):
            c = cols[:, b:b + step]
            val = np.where(c >= 0, x[np.maximum(c, 0)], F(0))
            old = m.copy()
            for j in range(step):
                m = np.where(c[:, j] >= 0, np.maximum(m, val[:, j]), m)
            live = m != -np.inf
            s = np.where(live & (m != old), s * np.exp(old - m), s)
            for j in range(step):
                s = np.where(live & (c[:, j] >= 0), s + np.exp(val[:, j] - m), s)
        M = F(np.nan) if np.isnan(x).any() else x.max()
        S = _block_sum(np.where(m == M, s, s * np.exp(m - M)), False)
        inv = F(1) / S
        err = np.exp(x - M) * inv
    picks = 0 <= label < C
    if picks:
        err[label] -= F(1)
    first = C if np.isnan(M) else int(np.argmax(x))
    return err, _xent_term(x, label, M, S) if picks else F(0), int(label >= 0 and first == label)


def _xent_term(x, label, m, s):
    lp = x[label] - m - np.log(s)
    return -(F(-1e10) if lp < F(-1e10) else lp)


def emulate(logits, labels, p):
    """(err, xent, correct) of one launch of plan ``p``."""
    B = logits.shape[0]
    row = _row_wide if p.variant == SP.WIDE else _row_in_registers
    err = np.empty_like(logits)
    part_x, part_c = np.zeros(p.blocks, F), np.zeros(p.blocks, np.int64)
    for b in range(p.blocks):
        for g in SP.block_rows(p, B, b):                 # the block's row groups
            gx, gh = F(0), 0
            for r in g:                                   # a group's rows, in order
                err[r], term, hit = row(logits[r], int(labels[r]), p)
                gx, gh = gx + term, gh + hit
            part_x[b], part_c[b] = part_x[b] + gx, part_c[b] + gh
    acc = np.zeros(p.threads, F)                          # the last block's threads
    for i in range(p.blocks):
        acc[i % p.threads] += part_x[i]
    return err, _block_sum(acc, False), int(part_c.sum())


def _ce_inputs(seed, B, C, labelled_nan):
    """Random logits with a label -1 row that holds a NaN, two tied-max rows,
    and, if asked, a NaN in a row whose label is the first max of its other
    columns (B >= 6, C >= 10)."""
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((B, C))).astype(F)
    labels = rng.integers(0, C, B).astype(np.int32)
    labels[1] = -1
    logits[1, C // 2] = np.nan
    logits[2, 3] = logits[2, C - 2] = logits[2].max() + 1
    labels[2] = C - 2                                     # first max (col 3): a miss
    logits[4, 0] = logits[4, 5] = logits[4].max() + 2
    labels[4] = 0                                         # first max is the label: a hit
    if labelled_nan:
        logits[5, 1] = logits[5].max() + 1
        labels[5] = 1
        logits[5, C - 1] = np.nan
    return logits, labels


# one case per variant, with 4- and 16-byte accesses, a B that is no
# multiple of NARROW's 4 rows a block, and B past the grid (a block walks
# two rows)
@pytest.mark.parametrize("B,C", [(37, 135), (38, 136), (20, 1025), (9, 8192), (300, 8192),
                                 (6, 9000), (270, 9000), (6, 20000)])
@pytest.mark.parametrize("labelled_nan", [False, True])
def test_emulated_kernel_matches_plain(B, C, labelled_nan):
    logits, labels = _ce_inputs(B + C, B, C, labelled_nan)
    p = SP.plan(B, C, ALIGNED)
    if (B, C) == (300, 8192) or (B, C) == (270, 9000):
        assert p.blocks < B
    err, xent, correct = emulate(logits, labels, p)
    perr, pxent, pcorr = (t.numpy() for t in softmax_xent_plain(torch.from_numpy(logits),
                                                                 torch.from_numpy(labels)))
    nan = np.isnan(perr)
    assert np.array_equal(np.isnan(err), nan)
    assert nan.any(1).sum() == 1 + labelled_nan
    assert np.abs(err - perr)[~nan].max() <= 1e-6
    assert int(correct) == int(pcorr)
    if labelled_nan:
        assert np.isnan(xent) and np.isnan(pxent)
    else:
        assert abs(xent - pxent) <= 1e-5 * abs(pxent)
    if labelled_nan:
        # the NaN row counts no hit although its label is the first max of the rest
        labels_off = labels.copy()
        labels_off[5] = -1
        assert emulate(logits, labels_off, p)[2] == correct

"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it runs on a machine with the card and without
JAX (tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The GEMM kernels run 3xTF32 on the tensor cores, f32-accurate (one TF32
pass would not meet these tolerances; tests/test_torch_tf32x3.py shows it on
the CPU). The shapes cover both tiles, split-K in one launch for the
forward and the weight gradient (the recipes' shapes, ragged last splits
at K = 598 and 368, two launches equal bit for bit, the tile counters left
at zero), the 8- and 4-byte copy paths (widths 598 and 135) and operands
whose base is not 16-byte aligned (``offset``: a contiguous tensor that
starts that many floats into its buffer).

Tolerances: forward outputs differ by summation order only (no plain TF32);
the fused update's f32 outputs within 1e-5 of the plain version's largest
value, its bf16 velocity within that plus one bf16 step at the element (the
f32 sum, taken in another order, may round to the neighbouring bf16 value;
near zero the sum's own error exceeds a bf16 step).

The f32 WGMMA route (``csrc/tf32_wgmma.cuh``: 3xTF32 on ``wgmma``, the
production shapes and others whose 128x128 tiles fill the card and whose
pitches are multiples of 4 floats) is held to the same tolerances at the
production shapes and at ragged M, N and K tails, with f32 and bf16
velocity at momentum 0 and 0.9, its launches asserted by its entry
points' counts in ``_build.LAUNCHES``; small integers make every sum
exact, so a wrong fragment, descriptor or swizzle shows as a wrong element.

The f32 input gradient ``dx = dz W^T`` on its WGMMA kernel (``csrc/dgrad.cu``:
W read K-major by ldmatrix and split in registers, dz split by a pre-pass)
is held to an f64 product within 1e-5 of its largest element (cuBLAS's
FFMA product meets it too; one TF32 pass would not, nor the route's sums
without their promotion) at the production stack's two dgrad shapes, at
ragged ones and on one-wave grids of 128 tiles, a block each (the SWB
CD-DNN's two shapes, K's tail at 9304 among them, and a 2x2 mesh rank's
512 rows of the production output layer), three calls equal bit for bit,
small integers exact, and its launches counted under ``dgrad_f32_wgmma``:
4 a production f32 step, 7 an SWB step (whose products the profiler's
counters show off the library but the output forward), none at bf16 or at
the shapes and operands the plan leaves to ``torch.matmul``; a
production step's gradients through autograd within the benchmark's
``grad_diff`` lower reading of the same step with every dgrad on cuBLAS.

The bf16 variants (one bf16 ``mma.sync`` pass, f32 accumulation) are held to
their plain versions within one bf16 step: both round an f32 value that
differs only by summation order. Their shapes add the 2-byte copy path (an
odd bf16 pitch, or a base that is not 4-byte aligned), and the WGMMA route
(``csrc/wgmma_gemm.cuh``: TMA and ``wgmma``, pitches of 16-byte multiples),
asserted by the per-route entry points' counts: a minimal tile (128x256 for the
forward, two 128x128 ones for the ping-pong weight gradient), K not a
multiple of 64, ragged M and N, a persistent grid walking several tiles a
block, and each operand layout alone with small integers, where every sum
is exact.
"""

import contextlib

import numpy as np
import pytest
import torch

from nnet_asr_torch.ops.kernels import _build
from nnet_asr_torch.ops.kernels import matmul_act as MA
from nnet_asr_torch.ops.kernels import sgd_fused as SF
from nnet_asr_torch.ops.kernels import softmax_ce as SC
from nnet_asr_torch.ops.kernels import softmax_plan, tile_plan

torch.set_num_threads(2)

# the entry points of each wrapper and dtype, every route
MA_F32 = ("matmul_act_f32", "matmul_act_f32_wgmma", "matmul_act_f32_cp_wgmma")
MA_BF16 = ("matmul_act_bf16", "matmul_act_bf16_wgmma", "matmul_act_bf16_cp_wgmma")
WG_F32 = ("wgrad_momentum_update_f32", "wgrad_momentum_update_f32_wgmma",
          "wgrad_momentum_update_f32_cp_wgmma", "wgrad_momentum_update_f32_ws_wgmma")
WG_BF16 = ("wgrad_momentum_update_bf16", "wgrad_momentum_update_bf16_wgmma",
           "wgrad_momentum_update_bf16_cp_wgmma")


def _count(*names: str) -> int:
    """The calls of these entry points that ran (``_build.LAUNCHES``: a
    replay of the Trainer's step graph counts, its capture does not)."""
    return sum(_build.LAUNCHES[n] for n in names)


def _affine_inputs(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, K)) / np.sqrt(K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    g = rng.standard_normal((M, N)).astype(np.float32)
    return x, w, b, g


def _on_card(a, dev, offset=0, dtype=torch.float32):
    """``a`` on the card at ``dtype``, contiguous, ``offset`` elements into
    its buffer (base not 16-byte aligned unless offset * size % 16 == 0)."""
    buf = torch.empty(a.size + offset, dtype=dtype, device=dev)
    t = buf[offset:].view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t.detach()


def _ce_inputs(seed, B, C):
    """Random logits with a label -1 row and two tied-max rows (B >= 5, C >= 6)."""
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((B, C))).astype(np.float32)
    labels = rng.integers(0, C, B).astype(np.int32)
    labels[1] = -1
    logits[2, 3] = logits[2, C - 2] = logits[2].max() + 1.0
    labels[2] = C - 2
    logits[4, 0] = logits[4, 5] = logits[4].max() + 2.0
    labels[4] = 0
    return logits, labels


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 1), (67, 598, 135), (130, 33, 70), (960, 598, 1024),
                                   (1024, 1024, 4096), (200, 256, 132, 1), (64, 128, 520, 2)])
def test_cuda_matmul_act_matches_plain(cuda, shape):
    M, K, N, offset = (*shape, 0)[:4]
    x, w, b, g = _affine_inputs(6, M, K, N)
    ts = [_on_card(a, cuda, offset).requires_grad_(True) for a in (x, w, b)]
    if offset:
        assert ts[0].data_ptr() % 16 and ts[1].data_ptr() % 16
    before = _count(*MA_F32)
    y = MA.affine_sigmoid(*ts)
    y.backward(torch.from_numpy(g).to(cuda))
    assert _count(*MA_F32) == before + 1
    ps = [torch.from_numpy(a).to(cuda).requires_grad_(True) for a in (x, w, b)]
    yp = MA.matmul_act_plain(*ps)
    yp.backward(torch.from_numpy(g).to(cuda))
    torch.cuda.synchronize()
    assert (y - yp).abs().max().item() <= 1e-5
    for t, p in zip(ts, ps):
        scale = p.grad.abs().max().item() or 1.0
        assert (t.grad - p.grad).abs().max().item() <= 1e-4 * scale
    z = MA.matmul_act(ts[0].detach(), ts[1].detach(), ts[2].detach(), "none")
    zp = MA.matmul_act_plain(ps[0].detach(), ps[1].detach(), ps[2].detach(), "none")
    assert (z - zp).abs().max().item() <= 1e-4 * (zp.abs().max().item() or 1.0)


# (M, K, N) of the bf16 forward on the WGMMA route: one 128x256 tile, K
# not a multiple of 64, ragged M and N (pitches still 16-byte multiples),
# the production stack's first layer
WGMMA_AFFINE = ((128, 64, 256), (256, 1000, 512), (1000, 1000, 4104), (1024, 1024, 4096))


# bf16 x, w, b: y within one bf16 step of the plain version's (both round
# the f32 result once; _bf16_tol); the JAX _bwd gradients (dz rounded to bf16, f32
# GEMMs, each rounded once) within two bf16 steps of the largest, against
# the same formula on the plain y. Shapes: both mma.sync tiles, 16-, 4- and
# 2-byte copies (K = 135 and a 1-element offset have no 4-byte rows), the
# WGMMA route (WGMMA_AFFINE) and the CP_WGMMA route (pitches and bases in
# whole 4-byte units that TMA cannot read: 598 columns, a 2-element offset)
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 1), (67, 598, 135), (130, 33, 70), (960, 598, 1024),
                                   (1024, 1024, 4096), (67, 135, 70), (200, 256, 132, 1),
                                   (64, 128, 520, 2), (128, 64, 256), (256, 1000, 512),
                                   (1000, 1000, 4104)])
def test_cuda_matmul_act_bf16_matches_plain(cuda, shape):
    M, K, N, offset = (*shape, 0)[:4]
    x, w, b, g = _affine_inputs(16, M, K, N)
    ts = [_on_card(a, cuda, offset, dtype=torch.bfloat16).requires_grad_(True) for a in (x, w, b)]
    pl = tile_plan.plan(M, N, K, a_pitch=K, b_pitch=N, a_ptr=ts[0].data_ptr(),
                        b_ptr=ts[1].data_ptr(), elem=2)
    if K == 135 or offset == 1:
        assert pl.a_bytes == 2
    route = (tile_plan.WGMMA if shape in WGMMA_AFFINE else
             tile_plan.CP_WGMMA if K % 2 == N % 2 == offset % 2 == 0 else tile_plan.MMA_SYNC)
    assert pl.route == route
    wgmma, cp = route == tile_plan.WGMMA, route == tile_plan.CP_WGMMA
    before = (_count(*MA_F32), _count(*MA_BF16),
              _count("matmul_act_bf16_wgmma"), _count("matmul_act_bf16_cp_wgmma"))
    y = MA.affine_sigmoid(*ts)
    gt = _on_card(g, cuda, dtype=torch.bfloat16)
    y.backward(gt)
    assert (_count(*MA_F32), _count(*MA_BF16),
            _count("matmul_act_bf16_wgmma"), _count("matmul_act_bf16_cp_wgmma")) == (
        before[0], before[1] + 1, before[2] + wgmma, before[3] + cp)
    assert y.dtype == torch.bfloat16 and all(t.grad.dtype == torch.bfloat16 for t in ts)
    xs, ws, bs = (t.detach() for t in ts)
    yp = MA.matmul_act_plain(xs, ws, bs)
    torch.cuda.synchronize()
    assert bool(((y.float() - yp.float()).abs() <= _bf16_tol(y, yp)).all())
    yf = yp.float()
    dz = gt.float() * yf * (1.0 - yf)
    dzc = dz.to(torch.bfloat16).float()
    want = (dzc @ ws.float().T, xs.float().T @ dzc, dz.sum(0))
    for t, ref in zip(ts, want):
        scale = ref.abs().max().item() or 1.0
        assert (t.grad.float() - ref).abs().max().item() <= 2 ** -7 * scale
    z = MA.matmul_act(xs, ws, bs, "none")
    zp = MA.matmul_act_plain(xs, ws, bs, "none")
    assert bool(((z.float() - zp.float()).abs() <= _bf16_tol(z, zp)).all())


def _bf16_tol(t, ref):
    """One bf16 step at each element, plus 1e-5 of the largest value: the
    f32 sums, taken in another order, may round to neighbouring bf16
    values, and near zero (cancellation) their own difference exceeds a
    bf16 step."""
    big = torch.maximum(t.float().abs(), ref.float().abs())
    return bf16_ulp(big) + 1e-5 * ref.float().abs().max()


def _bits(t):
    """The tensor's bits, so that NaNs compare equal to themselves."""
    return t.reshape(-1).view(torch.int32)


def _check_softmax_xent(lt, lb, variant, nan_rows=()):
    """Kernel against plain: err within 1e-6 (NaN where plain has NaN),
    xent within 1e-5 relative (or NaN with plain's), correct equal; one
    launch a call; a second run equal bit for bit."""
    p = softmax_plan.plan(*lt.shape, lt.data_ptr())
    assert p.variant == variant
    before = _count("softmax_xent_f32")
    err, xent, corr = SC.softmax_xent(lt, lb)
    assert _count("softmax_xent_f32") == before + 1
    perr, pxent, pcorr = SC.softmax_xent_plain(lt, lb)
    torch.cuda.synchronize()
    nan = torch.isnan(perr)
    assert torch.equal(torch.isnan(err), nan)
    assert bool(nan.any(1).cpu()[list(nan_rows)].all()) and int(nan.any(1).sum()) == len(nan_rows)
    assert (err - perr)[~nan].abs().max().item() <= 1e-6
    if torch.isnan(pxent):
        assert torch.isnan(xent)
    else:
        assert abs(xent.item() - pxent.item()) <= 1e-5 * max(abs(pxent.item()), 1.0)
    assert corr.item() == pcorr.item()
    # bit-for-bit repeatable: no float atomics, whichever block ends last
    err2, xent2, corr2 = SC.softmax_xent(lt, lb)
    assert _count("softmax_xent_f32") == before + 2
    assert torch.equal(_bits(err), _bits(err2))
    assert torch.equal(_bits(xent), _bits(xent2)) and corr.item() == corr2.item()
    return err, xent, corr


# every variant of the plan: NARROW at B not a multiple of its 4 rows a
# block, ROWS with 4- and 16-byte accesses, WIDE past the register limit,
# and each with more rows than its grid has blocks (a block walks several
# rows); ``offset`` starts the logits that many floats into their buffer
@pytest.mark.cuda
@pytest.mark.parametrize("B,C,offset,variant", [
    (1, 1, 0, softmax_plan.NARROW), (37, 135, 0, softmax_plan.NARROW),
    (38, 512, 0, softmax_plan.NARROW), (37, 136, 1, softmax_plan.NARROW),
    (5000, 64, 0, softmax_plan.NARROW),
    (20, 1025, 0, softmax_plan.ROWS), (33, 3001, 0, softmax_plan.ROWS),
    (64, 8192, 0, softmax_plan.ROWS), (9, 8192, 2, softmax_plan.ROWS),
    (600, 8192, 0, softmax_plan.ROWS),
    (6, 8193, 0, softmax_plan.WIDE), (5, 40000, 0, softmax_plan.WIDE),
    (5, 40000, 3, softmax_plan.WIDE), (300, 9000, 0, softmax_plan.WIDE)])
def test_cuda_softmax_xent_matches_plain(cuda, B, C, offset, variant):
    logits, labels = _ce_inputs(7, max(B, 5), max(C, 6))
    logits = np.ascontiguousarray(logits[:B, :C])
    labels = np.minimum(labels[:B], C - 1)
    lt = _on_card(logits, cuda, offset)
    if offset:
        assert lt.data_ptr() % 16 and not softmax_plan.plan(B, C, lt.data_ptr()).vec
    lb = torch.from_numpy(labels).to(cuda)
    _check_softmax_xent(lt, lb, variant)


# rows with a NaN: NaN err, NaN xent when labelled, and no hit even where
# the label is the first max of the other columns (fmaxf would count one)
@pytest.mark.cuda
@pytest.mark.parametrize("B,C,variant", [(37, 135, softmax_plan.NARROW),
                                         (12, 8192, softmax_plan.ROWS),
                                         (6, 9000, softmax_plan.WIDE)])
def test_cuda_softmax_xent_nan_rows_count_as_plain(cuda, B, C, variant):
    logits, labels = _ce_inputs(9, B, C)
    logits[1, C // 2] = np.nan                        # label -1: xent stays finite
    lt = torch.from_numpy(logits).to(cuda)
    lb = torch.from_numpy(labels).to(cuda)
    _, xent, _ = _check_softmax_xent(lt, lb, variant, nan_rows=(1,))
    assert torch.isfinite(xent)
    logits[5, 1] = logits[5].max() + 1.0              # the label is the first max ...
    labels[5] = 1
    logits[5, C - 1] = np.nan                         # ... of a row with a NaN
    lt = torch.from_numpy(logits).to(cuda)
    lb = torch.from_numpy(labels).to(cuda)
    _, xent, corr = _check_softmax_xent(lt, lb, variant, nan_rows=(1, 5))
    assert torch.isnan(xent)
    lb[5] = -1
    _, _, corr_unlabelled = SC.softmax_xent(lt, lb)
    assert corr.item() == corr_unlabelled.item()      # row 5 never counted


# the last-block ticket is kept per stream: launches on two streams at once
# each sum their own partials
@pytest.mark.cuda
def test_cuda_softmax_xent_on_two_streams(cuda):
    ins = [_ce_inputs(seed, 600, 8192) for seed in (10, 11)]
    ts = [(torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)) for x, y in ins]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in ts]
    outs = []
    for _ in range(3):
        for st, (lt, lb) in zip(streams, ts):
            with torch.cuda.stream(st):
                outs.append(SC.softmax_xent(lt, lb))
    torch.cuda.synchronize()
    for k, (err, xent, corr) in enumerate(outs):
        perr, pxent, pcorr = SC.softmax_xent_plain(*ts[k % 2])
        assert (err - perr).abs().max().item() <= 1e-6
        assert abs(xent.item() - pxent.item()) <= 1e-5 * abs(pxent.item())
        assert corr.item() == pcorr.item()
        assert torch.equal(xent, outs[k % 2][1])

def bf16_ulp(t):
    """One bf16 step at each element's magnitude (8 significant bits)."""
    mag = t.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1, 1), (67, 61, 135), (960, 598, 1024),
                                   (960, 1024, 135), (1024, 1024, 4096), (300, 256, 520, 1),
                                   (960, 1024, 135, 3), (598, 598, 1024), (368, 368, 500)])
def test_cuda_wgrad_momentum_update_matches_plain(cuda, shape, vdt):
    B, In, Out, offset = (*shape, 0)[:4]
    rng = np.random.default_rng(8)
    x, e = (rng.standard_normal((B, n)).astype(np.float32) for n in (In, Out))
    p, v = (rng.standard_normal((In, Out)).astype(np.float32) for _ in range(2))
    xs, es = (_on_card(a, cuda, offset) for a in (x, e))
    pl = tile_plan.plan(In, Out, B, a_pitch=In, b_pitch=Out, a_ptr=xs.data_ptr(),
                        b_ptr=es.data_ptr(), wgrad=True)
    if offset:
        assert pl.a_bytes < 16 and pl.b_bytes < 16
    pk, pp = (torch.from_numpy(p).to(cuda) for _ in range(2))
    vk, vp = (torch.from_numpy(v).to(cuda, vdt) for _ in range(2))
    before = _count(*WG_F32)
    SF.wgrad_momentum_update(xs, es, pk, vk, 0.003, 0.9)
    assert _count(*WG_F32) == before + 1
    SF.wgrad_momentum_update_plain(xs, es, pp, vp, 0.003, 0.9)
    torch.cuda.synchronize()
    assert vk.dtype == vdt and pk.dtype == torch.float32
    assert (pk - pp).abs().max().item() <= 1e-5 * pp.abs().max().item()
    if vdt == torch.float32:
        assert (vk - vp).abs().max().item() <= 1e-5 * vp.abs().max().item()
    else:
        big = torch.maximum(vk.float().abs(), vp.float().abs())
        tol = bf16_ulp(big) + 1e-5 * vp.float().abs().max()
        assert bool(((vk.float() - vp.float()).abs() <= tol).all())
    # bit-for-bit repeatable, split-K included: no float atomics
    pk2, vk2 = (torch.from_numpy(p).to(cuda), torch.from_numpy(v).to(cuda, vdt))
    SF.wgrad_momentum_update(xs, es, pk2, vk2, 0.003, 0.9)
    torch.cuda.synchronize()
    assert torch.equal(pk, pk2) and torch.equal(vk, vk2)
    if shape[:3] == (960, 1024, 135):
        assert pl.splits > 1


def _kernels_of(fn, calls=1, tries=3):
    """The names of the device kernels ``calls`` calls of ``fn`` launch. A
    window in which the profiler recorded no device event at all (it
    happens now and then on the card; chip_smoke.device_rows) is taken
    again, up to ``tries`` windows."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if getattr(e, "device_type", None)
                 == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return []


# The forward at the recipes' small shapes (TIMIT's hidden layer, one tmpe
# utterance, MLP3 and a 2x2 mesh rank's rows) and one with K = 368 cut 3
# ways (N = 1004: 2,008-byte rows): one launch a call (a split reduced in
# it); two launches equal bit for bit (the partials are summed in split
# order); within the tolerances of the tests above. f32 runs the f32
# CP_WGMMA kernel with the splits below (the split ones leave their last
# split ragged: 150 rows of 598, 112 of 368, 176 of 368 and 278 of 598),
# bf16 the bf16 CP_WGMMA
# kernel with the splits of its own plan.
SMALL_FORWARD_SPLITS = {(1024, 368, 500): 2, (284, 598, 1024): 3, (960, 598, 1024): 1,
                        (480, 598, 1024): 2, (284, 368, 1004): 3}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(SMALL_FORWARD_SPLITS))
def test_cuda_matmul_act_split_k_one_launch_bit_equal(cuda, shape, dtype):
    M, K, N = shape
    x, w, b, _ = _affine_inputs(7, M, K, N)
    xs, ws, bs = (_on_card(a, cuda, dtype=dtype) for a in (x, w, b))
    pl = tile_plan.plan(M, N, K, a_pitch=K, b_pitch=N, a_ptr=xs.data_ptr(), b_ptr=ws.data_ptr(),
                        elem=xs.element_size())
    if dtype == torch.float32:
        assert pl.route == tile_plan.CP_WGMMA and pl.splits == SMALL_FORWARD_SPLITS[shape]
        kernel = "matmul_act_f32_cp_wgmma_kernel"
    else:
        assert pl.route == tile_plan.CP_WGMMA
        assert (pl.tile, pl.splits) == (tile_plan.SMALL, tile_plan.cp_splits(M, N, K))
        kernel = "matmul_act_cp_wgmma_kernel"
    if pl.splits > 1:
        assert pl.k_chunk * (pl.splits - 1) < K < pl.k_chunk * pl.splits   # ragged last split
    names = _kernels_of(lambda: MA.matmul_act(xs, ws, bs))
    assert len(names) == 1 and kernel in names[0]
    y1, y2 = MA.matmul_act(xs, ws, bs), MA.matmul_act(xs, ws, bs)
    yp = MA.matmul_act_plain(xs, ws, bs)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    if dtype == torch.float32:
        assert (y1 - yp).abs().max().item() <= 1e-5
    else:
        assert bool(((y1.float() - yp.float()).abs() <= _bf16_tol(y1, yp)).all())


# The CP_WGMMA route (bf16 forward, cp.async into wgmma's swizzled layout)
# against the plain version at the recipes' four shapes and ragged ones (M,
# N and K no tile multiples, K no multiple of 16, a 2-element offset),
# under the plan's split and 1 to 4 splits forced: y within one bf16 step
# (_bf16_tol), act "none" too; two launches equal bit for bit; the route's
# counter moves once a call; the split counters left at zero.
CP_SHAPES = [(960, 598, 1024), (1024, 368, 500), (284, 598, 1024), (480, 598, 1024),
             (67, 598, 70), (130, 34, 262), (1, 2, 2), (200, 1000, 130, 2)]


def _cp_plan(M, N, K, splits, xs, ws):
    """The plan of ``tile_plan.plan``, with the split forced unless None."""
    pl = tile_plan.plan(M, N, K, a_pitch=K, b_pitch=N, a_ptr=xs.data_ptr(),
                        b_ptr=ws.data_ptr(), elem=2)
    assert pl.route == tile_plan.CP_WGMMA and pl.tile == tile_plan.SMALL
    if splits is None:
        return pl
    return tile_plan.cp_fixed(M, N, K, pl.tile, splits, pl.a_bytes, pl.b_bytes)


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [None, 1, 2, 3, 4])
@pytest.mark.parametrize("shape", CP_SHAPES)
def test_cuda_matmul_act_bf16_cp_wgmma_matches_plain(cuda, shape, forced):
    from nnet_asr_torch.ops.kernels import _build

    M, K, N, offset = (*shape, 0)[:4]
    x, w, b, _ = _affine_inputs(31, M, K, N)
    xs, ws, bs = (_on_card(a, cuda, offset, dtype=torch.bfloat16) for a in (x, w, b))
    pl = _cp_plan(M, N, K, forced, xs, ws)
    stream = torch.cuda.current_stream(cuda)

    def run(act):
        y = torch.empty((M, N), dtype=torch.bfloat16, device=cuda)
        if forced is None:
            return MA.matmul_act(xs, ws, bs, act)
        MA._launch_cp_wgmma(_build.load_library(), xs, ws, bs, y, act, pl, stream)
        return y

    for act in ("sigmoid", "none"):
        before = (_count(*MA_BF16), _count("matmul_act_bf16_cp_wgmma"),
                  _count("matmul_act_bf16_wgmma"))
        y1, y2 = run(act), run(act)
        assert (_count(*MA_BF16), _count("matmul_act_bf16_cp_wgmma"),
                _count("matmul_act_bf16_wgmma")) == (before[0] + 2, before[1] + 2, before[2])
        yp = MA.matmul_act_plain(xs, ws, bs, act)
        torch.cuda.synchronize()
        assert torch.equal(y1, y2)
        assert bool(((y1.float() - yp.float()).abs() <= _bf16_tol(y1, yp)).all())
    assert not _build.counters(cuda, stream).any().item()


# Small integers make every f32 sum exact, so y equals the plain version's
# bits (both round the same f32 value once): a wrong swizzle, descriptor,
# zero fill or split sum moves whole elements. K = 598 leaves the last k16
# slice 6 columns deep; whole and split, each copy width (x 4 or 16 bytes,
# W 16 or 8).
@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("shape", [(200, 598, 1024), (300, 368, 500)])
def test_cuda_cp_wgmma_layouts_exact(cuda, shape, splits):
    from nnet_asr_torch.ops.kernels import _build

    M, K, N = shape
    rng = np.random.default_rng(22)
    bf = torch.bfloat16
    x = torch.from_numpy(rng.integers(-1, 2, (M, K)).astype(np.float32)).to(cuda, bf)
    w = torch.from_numpy(rng.integers(-1, 2, (K, N)).astype(np.float32)).to(cuda, bf)
    b = torch.from_numpy(rng.integers(-2, 3, N).astype(np.float32)).to(cuda, bf)
    pl = _cp_plan(M, N, K, splits, x, w)
    assert (pl.a_bytes, pl.b_bytes) == ((4, 16) if K == 598 else (16, 8))
    y = torch.empty((M, N), dtype=bf, device=cuda)
    MA._launch_cp_wgmma(_build.load_library(), x, w, b, y, "none", pl,
                        torch.cuda.current_stream(cuda))
    exact = (x.double() @ w.double() + b.double()).float().to(bf)
    torch.cuda.synchronize()
    assert torch.equal(y, exact)


# The weight gradient's split-K reduced in its one launch: no second kernel
# (f32 on the f32 CP_WGMMA route but at Out = 135, which the plan sends to
# the WS_WGMMA route; bf16 on the bf16 CP_WGMMA route)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(960, 598, 1024), (960, 1024, 135), (598, 598, 1024)])
def test_cuda_wgrad_split_k_one_launch(cuda, shape, dtype):
    B, In, Out = shape
    rng = np.random.default_rng(9)
    x, e = (rng.standard_normal((B, n)).astype(np.float32) for n in (In, Out))
    xs, es = (_on_card(a, cuda, dtype=dtype) for a in (x, e))
    pl = tile_plan.plan(In, Out, B, a_pitch=In, b_pitch=Out, a_ptr=xs.data_ptr(),
                        b_ptr=es.data_ptr(), wgrad=True, elem=xs.element_size())
    assert pl.splits > 1
    p = torch.zeros((In, Out), device=cuda)
    v = torch.zeros((In, Out), device=cuda)
    names = _kernels_of(lambda: SF.wgrad_momentum_update(xs, es, p, v, 1e-3, 0.9))
    bf16 = dtype == torch.bfloat16
    kernel = {tile_plan.CP_WGMMA: ("wgrad_momentum_bf16_cp_wgmma_kernel" if bf16
                                   else "wgrad_momentum_f32_cp_wgmma_kernel"),
              tile_plan.WS_WGMMA: "wgrad_momentum_f32_ws_wgmma_kernel"}.get(
                  pl.route, "wgrad_momentum_kernel")
    assert (pl.route == tile_plan.CP_WGMMA) == (bf16 or Out % 2 == 0)
    assert len(names) == 1 and kernel in names[0]


# A chain of launches of every split shape, both kernels, f32 and bf16, on
# two streams, leaves every tile counter at zero: the last block of each
# tile resets its counter, and each stream has its own
@pytest.mark.cuda
def test_cuda_split_k_counters_left_at_zero(cuda):
    from nnet_asr_torch.ops.kernels import _build

    streams = [torch.cuda.current_stream(cuda), torch.cuda.Stream(cuda)]
    for st in streams:
        with torch.cuda.stream(st):
            for dtype in (torch.float32, torch.bfloat16):
                for M, K, N in ((1024, 368, 500), (284, 598, 1024), (284, 368, 1004)):
                    x, w, b, _ = _affine_inputs(M, M, K, N)
                    MA.matmul_act(*(_on_card(a, cuda, dtype=dtype) for a in (x, w, b)))
                for B, In, Out in ((960, 598, 1024), (960, 1024, 135), (368, 368, 500)):
                    rng = np.random.default_rng(B + In)
                    x, e = (rng.standard_normal((B, n)).astype(np.float32) for n in (In, Out))
                    p = torch.zeros((In, Out), device=cuda)
                    SF.wgrad_momentum_update(_on_card(x, cuda, dtype=dtype),
                                             _on_card(e, cuda, dtype=dtype), p,
                                             torch.zeros_like(p), 1e-3, 0.9)
    torch.cuda.synchronize()
    for st in streams:
        assert not _build.counters(cuda, st).any().item()


# (B, In, Out) of the bf16 wgrad on the WGMMA route: two 128x128 tiles
# (a block each, the second consumer idle) in one 64-row step, a bunch not a multiple of 64, ragged
# In and Out (pitches still 16-byte multiples; 297 tiles on 132 blocks, so
# some walk an odd count), the production stack's first layer
WGMMA_WGRAD = ((64, 128, 256), (1000, 128, 256), (1000, 1032, 4104), (1024, 1024, 4096))


# bf16 x and e: g accumulated in f32 and rounded to bf16 once, in both
# versions, so p and v within one bf16 step of g (the f32 sums, taken in
# another order, may round to neighbouring bf16 values) plus v's own bf16
# step; two runs equal bit for bit; the WGMMA route at WGMMA_WGRAD
@pytest.mark.cuda
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1, 1), (67, 61, 135), (960, 598, 1024),
                                   (960, 1024, 135), (1024, 1024, 4096), (300, 256, 520, 1),
                                   (960, 1024, 135, 2), (64, 128, 256), (1000, 128, 256),
                                   (1000, 1032, 4104), (598, 598, 1024), (368, 368, 500)])
def test_cuda_wgrad_momentum_update_bf16_matches_plain(cuda, shape, vdt):
    B, In, Out, offset = (*shape, 0)[:4]
    rng = np.random.default_rng(18)
    x, e = (rng.standard_normal((B, n)).astype(np.float32) for n in (In, Out))
    p, v = (rng.standard_normal((In, Out)).astype(np.float32) for _ in range(2))
    xs, es = (_on_card(a, cuda, offset, dtype=torch.bfloat16) for a in (x, e))
    pl = tile_plan.plan(In, Out, B, a_pitch=In, b_pitch=Out, a_ptr=xs.data_ptr(),
                        b_ptr=es.data_ptr(), wgrad=True, elem=2)
    if Out == 135:   # a stage of whole rows as one run, or mma.sync's 2-byte loads
        assert pl.b_bytes == (16 if pl.route == tile_plan.CP_WGMMA else 2)
    wgmma = shape in WGMMA_WGRAD
    assert (pl.route == tile_plan.WGMMA) == wgmma
    pk, pp = (torch.from_numpy(p).to(cuda) for _ in range(2))
    vk, vp = (torch.from_numpy(v).to(cuda, vdt) for _ in range(2))
    counters = (WG_F32, WG_BF16, ("wgrad_momentum_update_bf16_wgmma",))
    before = [_count(*k) for k in counters]
    a, m = 0.003, 0.9
    SF.wgrad_momentum_update(xs, es, pk, vk, a, m)
    assert [_count(*k) for k in counters] == [before[0], before[1] + 1, before[2] + wgmma]
    SF.wgrad_momentum_update_plain(xs, es, pp, vp, a, m)
    torch.cuda.synchronize()
    assert vk.dtype == vdt and pk.dtype == torch.float32
    g = xs.float().T @ es.float()
    tol_v = bf16_ulp(g) + 1e-5 * vp.float().abs().max()
    if vdt == torch.bfloat16:
        tol_v = tol_v + bf16_ulp(torch.maximum(vk.float().abs(), vp.float().abs()))
    assert bool(((vk.float() - vp.float()).abs() <= tol_v).all())
    assert bool(((pk - pp).abs() <= a * tol_v + 1e-6 * pp.abs().max()).all())
    pk2, vk2 = (torch.from_numpy(p).to(cuda), torch.from_numpy(v).to(cuda, vdt))
    SF.wgrad_momentum_update(xs, es, pk2, vk2, a, m)
    torch.cuda.synchronize()
    assert torch.equal(pk, pk2) and torch.equal(vk, vk2)
    if shape[:3] == (960, 1024, 135):
        assert pl.splits > 1


# g is rounded to bf16 once, after the whole split-K sum: with integer
# inputs every f32 sum is exact in any order, so the kernel's g (read back
# from an f32 velocity at momentum 0) equals the exact sum rounded once, bit
# for bit, and differs from the sum of each split's rounded partial
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(960, 1024, 135), (960, 598, 1024)])
def test_cuda_wgrad_bf16_rounds_g_after_the_split_k_sum(cuda, shape):
    B, In, Out = shape
    rng = np.random.default_rng(19)
    xs = torch.from_numpy(rng.integers(0, 3, (B, In)).astype(np.float32)).to(cuda, torch.bfloat16)
    es = torch.from_numpy(rng.integers(0, 8, (B, Out)).astype(np.float32)).to(cuda, torch.bfloat16)
    pl = tile_plan.plan(In, Out, B, a_pitch=In, b_pitch=Out, a_ptr=xs.data_ptr(),
                        b_ptr=es.data_ptr(), wgrad=True, elem=2)
    assert pl.splits > 1
    p = torch.zeros((In, Out), device=cuda)
    v = torch.zeros((In, Out), device=cuda)
    SF.wgrad_momentum_update(xs, es, p, v, 1.0, 0.0)
    torch.cuda.synchronize()
    exact = xs.double().T @ es.double()
    assert torch.equal(v, exact.float().to(torch.bfloat16).float())
    assert torch.equal(p, -v)
    per_split = sum(
        (xs[k:k + pl.k_chunk].double().T @ es[k:k + pl.k_chunk].double()).float()
        .to(torch.bfloat16).float() for k in range(0, B, pl.k_chunk))
    assert not torch.equal(v, per_split)


# Each wgmma operand layout alone, with small integers so that every f32
# sum is exact and y or g is a bf16 value: x K-major and W N-major (the
# forward, act "none"), x M-major and e N-major (the weight gradient at
# momentum 0, read back from an f32 velocity). A wrong shared-memory
# descriptor or swizzle moves whole blocks of the result.
@pytest.mark.cuda
@pytest.mark.parametrize("which", ["forward K-major x, N-major W", "wgrad M-major x, N-major e"])
def test_cuda_wgmma_layouts_exact(cuda, which):
    rng = np.random.default_rng(21)
    bf = torch.bfloat16
    if which.startswith("forward"):
        M, K, N = 128, 128, 256
        x = torch.from_numpy(rng.integers(-1, 2, (M, K)).astype(np.float32)).to(cuda, bf)
        w = torch.from_numpy(rng.integers(-1, 2, (K, N)).astype(np.float32)).to(cuda, bf)
        b = torch.from_numpy(rng.integers(-2, 3, N).astype(np.float32)).to(cuda, bf)
        before = _count("matmul_act_bf16_wgmma")
        y = MA.matmul_act(x, w, b, "none")
        assert _count("matmul_act_bf16_wgmma") == before + 1
        exact = x.double() @ w.double() + b.double()
        assert torch.equal(y.double(), exact)
    else:
        B, In, Out = 128, 128, 256
        x = torch.from_numpy(rng.integers(-1, 2, (B, In)).astype(np.float32)).to(cuda, bf)
        e = torch.from_numpy(rng.integers(-1, 2, (B, Out)).astype(np.float32)).to(cuda, bf)
        p = torch.zeros((In, Out), device=cuda)
        v = torch.zeros((In, Out), device=cuda)
        before = _count("wgrad_momentum_update_bf16_wgmma")
        SF.wgrad_momentum_update(x, e, p, v, 1.0, 0.0)
        assert _count("wgrad_momentum_update_bf16_wgmma") == before + 1
        exact = x.double().T @ e.double()
        assert torch.equal(v.double(), exact) and torch.equal(p, -v)


# The persistent grid: 2048 output tiles of 128x128 on 132 blocks, each
# walking 15 or 16 tiles through one ring, its two consumer warpgroups
# taking turns (an odd count leaves the first one more). Integer inputs
# make g exact, so g (read back from an f32 velocity at momentum 0) equals
# the exact sum rounded once to bf16 on every tile; three runs give the
# same bits in p and v.
@pytest.mark.cuda
def test_cuda_wgrad_bf16_wgmma_persistent_exact_and_repeatable(cuda):
    B, In, Out = 192, 4096, 8192
    rng = np.random.default_rng(22)
    xs = torch.from_numpy(rng.integers(-3, 4, (B, In)).astype(np.float32)).to(cuda, torch.bfloat16)
    es = torch.from_numpy(rng.integers(-5, 6, (B, Out)).astype(np.float32)).to(cuda, torch.bfloat16)
    pl = tile_plan.plan(In, Out, B, a_pitch=In, b_pitch=Out, a_ptr=xs.data_ptr(),
                        b_ptr=es.data_ptr(), wgrad=True, elem=2)
    assert pl.route == tile_plan.WGMMA and pl.splits == 1
    assert pl.blocks == tile_plan.SM_COUNT < tile_plan.tile_count(In, Out, pl.tile)
    runs = []
    for _ in range(3):
        p = torch.zeros((In, Out), device=cuda)
        v = torch.zeros((In, Out), device=cuda)
        SF.wgrad_momentum_update(xs, es, p, v, 1.0, 0.0)
        runs.append((p, v))
    torch.cuda.synchronize()
    exact = (xs.double().T @ es.double()).float().to(torch.bfloat16).float()
    assert torch.equal(runs[0][1], exact) and torch.equal(runs[0][0], -exact)
    for p, v in runs[1:]:
        assert torch.equal(p, runs[0][0]) and torch.equal(v, runs[0][1])


# The bf16 CP_WGMMA weight gradient (csrc/cp_wgmma.cuh's wgrad_mainloop: g =
# x^T e by bf16 wgmma fed by cp.async, In on its M and Out on its N) against
# the plain version: MLP3's two weights, then ragged In (598, 1000), Out (1,
# 8, 135, 136 on the ROWS tile; 1024 on column tiles) and bunches (64, 100,
# 960, 961), all off TMA, f32 and bf16 velocity, momentum 0 and 0.9, under
# the plan's split and every split the rule can pick, forced (a cluster of
# at most CP_WGRAD_MAX_CLUSTER). Tolerance as
# check_wgrad_momentum_bf16's (v within one bf16 step of g, plus its own
# step for bf16 v; p within a times that); two launches equal bit for bit;
# one launch a call on the route's counter.
BF16_CP_WGRAD = [(960, 598, 1024), (960, 1024, 135), (64, 598, 1), (100, 598, 8),
                 (961, 1000, 135), (960, 598, 136), (100, 598, 1024), (961, 1000, 1)]


def _bf16_cp_wgrad_plan(In, Out, B, splits, xs, es):
    """The bf16 CP_WGMMA plan of g = x^T e (In, Out, the bunch B): the
    plan's, with ``splits`` forced unless None."""
    pl = tile_plan.plan(In, Out, B, In, Out, xs.data_ptr(), es.data_ptr(), wgrad=True, elem=2)
    assert pl.route == tile_plan.CP_WGMMA
    if splits is None:
        return pl
    return tile_plan.cp_fixed(In, Out, B, pl.tile, splits, pl.a_bytes, pl.b_bytes)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [0.0, 0.9])
@pytest.mark.parametrize("forced", [None, 1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BF16_CP_WGRAD)
def test_cuda_wgrad_bf16_cp_wgmma_matches_plain(cuda, shape, vdt, forced, m):
    from nnet_asr_torch.ops.kernels import _build

    B, In, Out = shape
    rng = np.random.default_rng(B + In + Out)
    x, e = (rng.standard_normal((B, n)).astype(np.float32) for n in (In, Out))
    p, v = (rng.standard_normal((In, Out)).astype(np.float32) for _ in range(2))
    xs, es = (_on_card(t, cuda, dtype=torch.bfloat16) for t in (x, e))
    pl = _bf16_cp_wgrad_plan(In, Out, B, forced, xs, es)
    assert pl.tile == (tile_plan.ROWS if Out <= 136 else tile_plan.CP_WGRAD_TILE)
    stream = torch.cuda.current_stream(cuda)
    a = 0.003

    def run(pk, vk):
        if forced is None:
            SF.wgrad_momentum_update(xs, es, pk, vk, a, m)
        else:
            SF._launch_bf16_cp_wgmma(_build.load_library(), xs, es, pk, vk, a, m, pl, stream)

    pk, pp, pk2 = (torch.from_numpy(p).to(cuda) for _ in range(3))
    vk, vp, vk2 = (torch.from_numpy(v).to(cuda, vdt) for _ in range(3))
    counters = (WG_BF16, ("wgrad_momentum_update_bf16_cp_wgmma",),
                ("wgrad_momentum_update_bf16_wgmma",))
    before = [_count(*k) for k in counters]
    run(pk, vk)
    assert [_count(*k) - b for k, b in zip(counters, before)] == [1, 1, 0]
    run(pk2, vk2)
    SF.wgrad_momentum_update_plain(xs, es, pp, vp, a, m)
    torch.cuda.synchronize()
    assert torch.equal(pk, pk2) and torch.equal(vk, vk2)
    g = xs.float().T @ es.float()
    tol_v = bf16_ulp(g) + 1e-5 * vp.float().abs().max()
    if vdt == torch.bfloat16:
        tol_v = tol_v + bf16_ulp(torch.maximum(vk.float().abs(), vp.float().abs()))
    assert bool(((vk.float() - vp.float()).abs() <= tol_v).all())
    assert bool(((pk - pp).abs() <= a * tol_v + 1e-6 * pp.abs().max()).all())
    assert not _build.counters(cuda, stream).any().item()


# Small integers make every f32 sum exact in any order, so g (read back
# from an f32 velocity at momentum 0) is the exact sum rounded once to
# bf16, bit for bit: a wrong swizzle, descriptor, transpose of e's run,
# zero fill, stash slot or split sum moves whole elements. Column tiles
# (x at 4- and 16-byte copies, e at 16 and 4, p's rows of 4,008 bytes
# an element at a time) and the ROWS tile (135
# columns, odd: the run's rows straddle 4-byte words; 129; 8), whole and
# split, the bunch ragged.
@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3, 6])
@pytest.mark.parametrize("shape", [(960, 1024, 135), (300, 598, 1024), (283, 1000, 1002),
                                   (200, 598, 129), (700, 66, 8), (961, 598, 136)])
def test_cuda_bf16_cp_wgmma_layouts_exact(cuda, shape, splits):
    from nnet_asr_torch.ops.kernels import _build

    rng = np.random.default_rng(31)
    B, In, Out = shape
    bf = torch.bfloat16
    x = torch.from_numpy(rng.integers(-2, 3, (B, In)).astype(np.float32)).to(cuda, bf)
    e = torch.from_numpy(rng.integers(-2, 3, (B, Out)).astype(np.float32)).to(cuda, bf)
    p, v = torch.zeros((In, Out), device=cuda), torch.zeros((In, Out), device=cuda)
    SF._launch_bf16_cp_wgmma(_build.load_library(), x, e, p, v, 1.0, 0.0,
                             _bf16_cp_wgrad_plan(In, Out, B, splits, x, e),
                             torch.cuda.current_stream(cuda))
    torch.cuda.synchronize()
    g = (x.double().T @ e.double()).float().to(bf).float()
    assert torch.equal(v, g) and torch.equal(p, -g)


# The ROWS tile spans at most 136 columns from a 16-byte aligned e, and a
# tile's splits are a cluster of at most CP_WGRAD_MAX_CLUSTER: a wider Out,
# e off 16 bytes or 8 splits is refused by the launch, not computed in part
@pytest.mark.cuda
@pytest.mark.parametrize("Out,offset,splits", [(137, 0, 1), (135, 4, 1), (135, 0, 8)])
def test_cuda_bf16_cp_wgmma_rows_refuses(cuda, Out, offset, splits):
    from nnet_asr_torch.ops.kernels import _build

    B, In = 960, 64
    x = torch.ones((B, In), device=cuda, dtype=torch.bfloat16)
    e = _on_card(np.ones((B, Out), np.float32), cuda, offset, dtype=torch.bfloat16)
    p, v = torch.zeros((In, Out), device=cuda), torch.zeros((In, Out), device=cuda)
    pl = tile_plan.cp_fixed(In, Out, B, tile_plan.ROWS, splits, 16, 16)
    assert pl.splits == splits
    with pytest.raises(RuntimeError):
        SF._launch_bf16_cp_wgmma(_build.load_library(), x, e, p, v, 1.0, 0.0, pl,
                                 torch.cuda.current_stream(cuda))


# (M, K, N) of the f32 forward on the f32 WGMMA route: the production
# stack's two widths, then ragged M, N and K (multiples of 4 floats, not of
# the 128x128 tile or the 32-deep stage), K one stage and a tail
F32_WGMMA_AFFINE = ((1024, 1024, 4096), (1024, 4096, 4096), (1000, 1000, 4104),
                    (1020, 4092, 4100), (516, 36, 4228))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", F32_WGMMA_AFFINE)
def test_cuda_matmul_act_f32_wgmma_matches_plain(cuda, shape):
    M, K, N = shape
    x, w, b, _ = _affine_inputs(26, M, K, N)
    xs, ws, bs = (_on_card(a, cuda) for a in (x, w, b))
    pl = tile_plan.plan(M, N, K, a_pitch=K, b_pitch=N, a_ptr=xs.data_ptr(), b_ptr=ws.data_ptr())
    assert pl.route == tile_plan.WGMMA and pl.blocks == tile_plan.SM_COUNT
    before = (_count(*MA_F32), _count("matmul_act_f32_wgmma"))
    y = MA.matmul_act(xs, ws, bs)
    assert (_count(*MA_F32), _count("matmul_act_f32_wgmma")) == (before[0] + 1,
                                                                          before[1] + 1)
    y2 = MA.matmul_act(xs, ws, bs)
    z = MA.matmul_act(xs, ws, bs, "none")
    yp, zp = MA.matmul_act_plain(xs, ws, bs), MA.matmul_act_plain(xs, ws, bs, "none")
    torch.cuda.synchronize()
    # y: the 1e-5 of the test above up to its depth of 1024; chip_smoke.py
    # phase 3's 1e-4 at depth 4096, where both f32 sums round 4x the products
    assert (y - yp).abs().max().item() <= (1e-5 if K <= 1024 else 1e-4)
    assert (z - zp).abs().max().item() <= 1e-4 * (zp.abs().max().item() or 1.0)
    assert torch.equal(y, y2)


# (B, In, Out) of the f32 weight gradient on the f32 WGMMA route: the
# production stack's three, ragged In, Out and bunch (multiples of 4), a
# bunch of one stage and a tail
F32_WGMMA_WGRAD = ((1024, 1024, 4096), (1024, 4096, 4096), (1024, 4096, 8192),
                   (1000, 1032, 4104), (36, 1028, 4228))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [0.0, 0.9])
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", F32_WGMMA_WGRAD)
def test_cuda_wgrad_f32_wgmma_matches_plain(cuda, shape, vdt, m):
    B, In, Out = shape
    rng = np.random.default_rng(27)
    x, e = (rng.standard_normal((B, n)).astype(np.float32) for n in (In, Out))
    p, v = (rng.standard_normal((In, Out)).astype(np.float32) for _ in range(2))
    xs, es = (_on_card(a, cuda) for a in (x, e))
    pk, pp, p2 = (torch.from_numpy(p).to(cuda) for _ in range(3))
    vk, vp, v2 = (torch.from_numpy(v).to(cuda, vdt) for _ in range(3))
    pl = tile_plan.plan(In, Out, B, a_pitch=In, b_pitch=Out, a_ptr=xs.data_ptr(),
                        b_ptr=es.data_ptr(), wgrad=True, out_ptrs=(pk.data_ptr(), vk.data_ptr()))
    assert pl.route == tile_plan.WGMMA
    before = (_count(*WG_F32), _count("wgrad_momentum_update_f32_wgmma"))
    SF.wgrad_momentum_update(xs, es, pk, vk, 0.003, m)
    assert (_count(*WG_F32),
            _count("wgrad_momentum_update_f32_wgmma")) == (before[0] + 1, before[1] + 1)
    SF.wgrad_momentum_update(xs, es, p2, v2, 0.003, m)
    SF.wgrad_momentum_update_plain(xs, es, pp, vp, 0.003, m)
    torch.cuda.synchronize()
    assert (pk - pp).abs().max().item() <= 1e-5 * pp.abs().max().item()
    if vdt == torch.float32:
        assert (vk - vp).abs().max().item() <= 1e-5 * vp.abs().max().item()
    else:
        big = torch.maximum(vk.float().abs(), vp.float().abs())
        tol = bf16_ulp(big) + 1e-5 * vp.float().abs().max()
        assert bool(((vk.float() - vp.float()).abs() <= tol).all())
    assert torch.equal(pk, p2) and torch.equal(vk, v2)


# Both f32 WGMMA kernels with small integers: every product and sum is exact
# in f32 (and each integer's lo half is 0), so y and g equal the exact
# result bit for bit; a wrong A fragment, B descriptor, swizzle or the
# permuted columns of the epilogue would move whole blocks of it
@pytest.mark.cuda
@pytest.mark.parametrize("which", ["forward", "wgrad"])
def test_cuda_f32_wgmma_layouts_exact(cuda, which):
    rng = np.random.default_rng(28)

    def ints(*shape):
        return torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32)).to(cuda)

    if which == "forward":
        M, K, N = 512, 520, 4224                   # 132 tiles, a stage's tail
        x, w, b = ints(M, K), ints(K, N), ints(N)
        before = _count("matmul_act_f32_wgmma")
        y = MA.matmul_act(x, w, b, "none")
        assert _count("matmul_act_f32_wgmma") == before + 1
        assert torch.equal(y.double(), x.double() @ w.double() + b.double())
    else:
        B, In, Out = 264, 1028, 4224
        x, e = ints(B, In), ints(B, Out)
        p = torch.zeros((In, Out), device=cuda)
        v = torch.zeros((In, Out), device=cuda)
        before = _count("wgrad_momentum_update_f32_wgmma")
        SF.wgrad_momentum_update(x, e, p, v, 1.0, 0.0)
        assert _count("wgrad_momentum_update_f32_wgmma") == before + 1
        assert torch.equal(v.double(), x.double().T @ e.double()) and torch.equal(p, -v)


# One call on the f32 WGMMA route launches the pre-pass and the GEMM, named
# for the profiler groups of chip_smoke.py; an operand one float off a
# 16-byte boundary keeps the shape on MMA_SYNC, one kernel a call. Counted
# over 10 calls (a window of one call may lose its first kernel's event)
@pytest.mark.cuda
def test_cuda_f32_wgmma_kernels_a_call(cuda):
    def per_call(fn, prefix):
        names = _kernels_of(fn, calls=10)
        assert all(prefix in n for n in names)
        return round(len(names) / 10), len(set(names))

    x, w, b, _ = _affine_inputs(29, 1024, 1024, 4096)
    xs, ws, bs = (_on_card(a, cuda) for a in (x, w, b))
    assert per_call(lambda: MA.matmul_act(xs, ws, bs), "matmul_act_f32_") == (2, 2)
    xm = _on_card(x, cuda, offset=1)
    assert tile_plan.plan(1024, 4096, 1024, 1024, 4096, xm.data_ptr(),
                          ws.data_ptr()).route == tile_plan.MMA_SYNC
    assert per_call(lambda: MA.matmul_act(xm, ws, bs), "matmul_act_kernel") == (1, 1)
    rng = np.random.default_rng(29)
    xw, ew = (_on_card(rng.standard_normal((1024, n)).astype(np.float32), cuda)
              for n in (1024, 4096))
    p, v = torch.zeros((1024, 4096), device=cuda), torch.zeros((1024, 4096), device=cuda)
    assert per_call(lambda: SF.wgrad_momentum_update(xw, ew, p, v, 1e-3, 0.9),
                    "wgrad_momentum_f32_") == (2, 2)


# (B, In, Out) of the f32 input gradient on its WGMMA kernel: the
# production stack's 4096->4096 and 4096->8192 layers, then ragged bunch,
# In and Out (multiples of 4 floats, not of the 128x128 tile or the 32-deep
# stage), and a contraction of one stage and a tail
DGRAD_SHAPES = ((1024, 4096, 4096), (1024, 4096, 8192), (1000, 4100, 4104), (516, 4228, 36))


# one-wave grids of 128 tiles of dx^T on 128 blocks: the SWB CD-DNN's
# hidden layers and its output layer (Out = 9304: 290 stages of 32 and a
# tail of 24 zero-filled by TMA, M * Out = 1024 * 9304 floats a split
# half), a 2x2 mesh rank's 512 rows of the production output layer
DGRAD_ONE_WAVE = ((1024, 2048, 2048), (1024, 2048, 9304), (512, 4096, 8192))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DGRAD_SHAPES)
def test_cuda_dgrad_f32_wgmma_matches_f64(cuda, shape):
    _dgrad_matches_f64(cuda, *shape, tile_plan.SM_COUNT)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DGRAD_ONE_WAVE)
def test_cuda_dgrad_one_wave_grids_match_f64(cuda, shape):
    _dgrad_matches_f64(cuda, *shape, 128)


def _dgrad_matches_f64(cuda, B, In, Out, blocks):
    rng = np.random.default_rng(30)
    dz = _on_card((rng.standard_normal((B, Out)) / np.sqrt(Out)).astype(np.float32), cuda)
    w = _on_card(rng.standard_normal((In, Out)).astype(np.float32), cuda)
    p = tile_plan.dgrad_plan(B, In, Out, dz.data_ptr(), w.data_ptr())
    assert p.route == tile_plan.WGMMA and p.blocks == blocks
    before = _count("dgrad_f32_wgmma")
    dx = [MA.dgrad(dz, w) for _ in range(3)]
    assert _count("dgrad_f32_wgmma") == before + 3
    ref = dz.double() @ w.double().T
    torch.cuda.synchronize()
    # chip_smoke.py phase 3's tolerance, which cuBLAS's FFMA product meets
    # too; the tensor cores' truncating sums without the kernel's promotion
    # (3-6e-5 of the largest element at these depths) do not
    tol = 1e-5 * ref.abs().max().item()
    assert (dx[0].double() - ref).abs().max().item() <= tol
    assert (torch.matmul(dz, w.T).double() - ref).abs().max().item() <= tol
    assert torch.equal(dx[0], dx[1]) and torch.equal(dx[0], dx[2])


# small integers: every product and sum exact in f32 (each integer's lo
# half 0), so dx equals the exact product bit for bit; a wrong ldmatrix
# address, swizzle, B descriptor or epilogue row would move whole blocks
@pytest.mark.cuda
def test_cuda_dgrad_f32_wgmma_layouts_exact(cuda):
    rng = np.random.default_rng(31)
    B, In, Out = 512, 4224, 520                 # 132 tiles, a stage's tail
    dz, w = (torch.from_numpy(rng.integers(-3, 4, s).astype(np.float32)).to(cuda)
             for s in ((B, Out), (In, Out)))
    before = _count("dgrad_f32_wgmma")
    dx = MA.dgrad(dz, w)
    assert _count("dgrad_f32_wgmma") == before + 1
    assert torch.equal(dx.double(), dz.double() @ w.double().T)


# One call launches the pre-pass and the GEMM, both named dgrad_f32_ (no
# profiler group of the forward, the weight gradient or the library takes
# them); counted over 10 calls
@pytest.mark.cuda
def test_cuda_dgrad_kernels_a_call(cuda):
    rng = np.random.default_rng(32)
    dz, w = (_on_card(rng.standard_normal(s).astype(np.float32), cuda)
             for s in ((1024, 4096), (4096, 4096)))
    names = _kernels_of(lambda: MA.dgrad(dz, w), calls=10)
    assert all("dgrad_f32_" in n and "matmul_act" not in n for n in names)
    assert (round(len(names) / 10), len(set(names))) == (2, 2)


# the shapes and operands the plan leaves to torch.matmul: MLP3's
# 960x1024->135 (a 540-byte pitch), TIMIT's 1024x500->39, a 2x2 mesh rank's
# 480 rows of MLP3, a grid of 123 tiles (one under the one-wave rule's
# 124), a production shape one float off a 16-byte boundary, a
# non-contiguous dz, and bf16 operands: no launch, cuBLAS's product exactly
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mlp3", "timit", "mesh_mlp3", "under_wave", "unaligned",
                                  "strided", "bf16"])
def test_cuda_dgrad_bypass_launches_nothing(cuda, case):
    B, In, Out = {"mlp3": (960, 1024, 135), "timit": (1024, 500, 39),
                  "mesh_mlp3": (480, 1024, 135), "under_wave": (384, 5248, 4096)}.get(
                      case, (1024, 4096, 4096))
    rng = np.random.default_rng(33)
    dz = _on_card(rng.standard_normal((B, Out)).astype(np.float32), cuda,
                  offset=1 if case == "unaligned" else 0)
    w = _on_card(rng.standard_normal((In, Out)).astype(np.float32), cuda)
    if case == "strided":
        dz = torch.cat([dz, dz], 1)[:, :Out]
        assert not dz.is_contiguous()
    if case == "bf16":
        dz, w = dz.bfloat16(), w.bfloat16()
    before = _count("dgrad_f32_wgmma")
    dx = MA.dgrad(dz, w)
    assert _count("dgrad_f32_wgmma") == before
    want = MA.bf16_matmul(dz, w.T) if case == "bf16" else torch.matmul(dz, w.T)
    assert torch.equal(dx, want)


def _production_trainer(dev, momentum, dtype=None, dims=(1024, 4096, 4096, 4096, 4096, 8192)):
    """The production-width stack 1024->4096x4->8192 (or ``dims``) +
    softmax (weights 0.05 N(0, 1) from numpy seed 7, zero biases) in a
    Trainer, bunch 1024."""
    from nnet_asr_torch.models import components as TC
    from nnet_asr_torch.models.network import Network
    from nnet_asr_torch.train.sgd import SgdConfig
    from nnet_asr_torch.train.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(7)
    layers, params = [], []
    for i in range(len(dims) - 1):
        layers.append(TC.BiasedLinearity(dims[i], dims[i + 1]))
        params.append({"weight": 0.05 * rng.standard_normal((dims[i], dims[i + 1]),
                                                            dtype=np.float32),
                       "bias": np.zeros(dims[i + 1], np.float32)})
        if i < len(dims) - 2:
            layers.append(TC.Sigmoid(dims[i + 1], dims[i + 1]))
            params.append({})
    layers.append(TC.Softmax(dims[-1], dims[-1]))
    params.append({})
    cfg = TrainerConfig(bunchsize=1024, cachesize=1024, compute_dtype=dtype,
                        sgd=SgdConfig(learning_rate=0.01, momentum=momentum))
    return Trainer(Network(layers).from_numpy_params(params), cfg, device=dev)


# the route engages for every layer whose input needs a gradient: 4 a f32
# production step (not the first layer's), at momentum 0 and 0.9, none
# under the bf16 compute dtype
@pytest.mark.cuda
@pytest.mark.parametrize("momentum,dtype,want", [(0.0, None, 4), (0.9, None, 4),
                                                 (0.0, "bf16", 0), (0.9, "bf16", 0)])
def test_cuda_dgrad_launches_a_production_step(cuda, momentum, dtype, want):
    tr = _production_trainer(cuda, momentum, dtype)
    gen = torch.Generator(device=cuda).manual_seed(34)
    feats = 0.1 * torch.randn((1024, 1024), generator=gen, device=cuda)
    labels = torch.randint(0, 8192, (1024,), generator=gen, device=cuda, dtype=torch.int32)
    before = _count("dgrad_f32_wgmma")
    for _ in range(2):
        tr._train_step(feats, labels)
    torch.cuda.synchronize()
    assert _count("dgrad_f32_wgmma") - before == 2 * want


# Seide et al.'s SWB CD-DNN (429->2048x7->9304, bunch 1024) at momentum
# 0.9, one step in the profiler's spans (eager): its seven dgrads (one wave
# of 128 tiles each) launch the kernel and count on the WGMMA route, so the
# library forms the output forward alone
@pytest.mark.cuda
def test_cuda_swb_step_leaves_only_the_output_forward_to_the_library(cuda):
    from nnet_asr_torch.utils.profiler import profiler

    B, dims = 1024, (429,) + (2048,) * 7 + (9304,)
    tr = _production_trainer(cuda, 0.9, dims=dims)
    gen = torch.Generator(device=cuda).manual_seed(36)
    feats = 0.1 * torch.randn((B, 429), generator=gen, device=cuda)
    labels = torch.randint(0, 9304, (B,), generator=gen, device=cuda, dtype=torch.int32)
    was = profiler.enabled
    profiler.reset()
    profiler.enabled = True
    try:
        before = _count("dgrad_f32_wgmma")
        tr._train_step(feats, labels)
        torch.cuda.synchronize()
        flops = {k: c["sum"] for k, c in profiler.counters().items()
                 if k.startswith("gemm.flops.")}
    finally:
        profiler.enabled = was
        profiler.reset()
    assert _count("dgrad_f32_wgmma") - before == 7
    later = 2 * B * (6 * 2048 * 2048 + 2048 * 9304)     # the dgrads, or the wgrads, of 2..8
    assert flops == {"gemm.flops.library": 2 * B * 2048 * 9304,
                     "gemm.flops.wgmma": 2 * later,
                     "gemm.flops.cp_wgmma": 2 * B * (2 * 429 * 2048 + 6 * 2048 * 2048)}


# one production step's gradients through autograd (momentum 0: every
# weight and bias gradient formed) with the dgrads on their kernel against
# the same step with every dgrad on cuBLAS (tools/gemm_ceiling.py
# library_dgrad): by the worst leaf, the norm of the difference over the
# larger of the leaf's and the median leaf's norm, as benchmark/check.py's
# grad_diff, within that number's lower reading in prod_tnetcu.resident
# (4.50e-5: the program against the plain reference with every dgrad on
# cuBLAS; the kernel without its promotion read 1.08e-4 here)
@pytest.mark.cuda
def test_cuda_dgrad_production_gradients_agree_with_library(cuda):
    from nnet_asr_torch.tools.gemm_ceiling import library_dgrad

    gen = torch.Generator(device=cuda).manual_seed(35)
    feats = 0.1 * torch.randn((1024, 1024), generator=gen, device=cuda)
    labels = torch.randint(0, 8192, (1024,), generator=gen, device=cuda, dtype=torch.int32)
    grads = []
    for library in (False, True):
        tr = _production_trainer(cuda, 0.0)
        before = _count("dgrad_f32_wgmma")
        with library_dgrad() if library else contextlib.nullcontext():
            loss, _ = tr._loss(tr._forward_logits(feats, {}, train=True), labels)
            grads.append([g.double() for g in tr._grads(loss)])
        torch.cuda.synchronize()
        assert _count("dgrad_f32_wgmma") - before == (0 if library else 4)
    norms = [g.norm().item() for g in grads[1]]
    med = float(np.median(norms))
    diff = max((a - b).norm().item() / max(n, med)
               for a, b, n in zip(grads[0], grads[1], norms) if n >= 1e-3 * med)
    assert 0 < diff <= 4.5e-5


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_bad_input(cuda):
    x = torch.zeros((4, 3), device=cuda)
    w = torch.zeros((3, 2), device=cuda)
    b = torch.zeros(2, device=cuda)
    with pytest.raises(TypeError):
        MA.matmul_act(x.double(), w, b)
    with pytest.raises(ValueError):
        MA.matmul_act(x.t(), torch.zeros((4, 2), device=cuda), b)   # not contiguous
    with pytest.raises(ValueError):
        MA.matmul_act(x, w[:2], b)
    with pytest.raises(TypeError):
        SC.softmax_xent(x, torch.zeros(4, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        SC.softmax_xent(x, torch.zeros(3, dtype=torch.int32, device=cuda))
    e = torch.zeros((4, 2), device=cuda)
    with pytest.raises(TypeError):
        SF.wgrad_momentum_update(x, e, w, w.half(), 0.1, 0.5)
    with pytest.raises(ValueError):
        SF.wgrad_momentum_update(x, e, w, w.cpu(), 0.1, 0.5)
    # mixed dtypes: no cast, no fallback
    with pytest.raises(TypeError):
        MA.matmul_act(x.bfloat16(), w, b)
    with pytest.raises(TypeError):
        MA.matmul_act(x.bfloat16(), w.bfloat16(), b)
    with pytest.raises(TypeError):
        SF.wgrad_momentum_update(x.bfloat16(), e, w, w, 0.1, 0.5)
    with pytest.raises(TypeError):
        SF.wgrad_momentum_update(x.bfloat16(), e.bfloat16(), w.bfloat16(), w, 0.1, 0.5)


def _routing_net(head, sparse):
    """20 -> 32 (sigmoid) -> 10 with the given head; the hidden affine a
    SparseLinearity if ``sparse``."""
    from nnet_asr_torch.models import components as TC
    from nnet_asr_torch.models.network import Network

    rng = np.random.default_rng(12)
    first = TC.SparseLinearity(20, 32) if sparse else TC.BiasedLinearity(20, 32)
    layers = [first, TC.Sigmoid(32, 32), TC.BiasedLinearity(32, 10)]
    p0 = {"weight": (0.3 * rng.standard_normal((20, 32))).astype(np.float32),
          "bias": np.zeros(32, np.float32)}
    if sparse:
        p0["mask"] = (rng.random((20, 32)) > 0.2).astype(np.float32)
    params = [p0, {}, {"weight": (0.3 * rng.standard_normal((32, 10))).astype(np.float32),
                       "bias": np.zeros(10, np.float32)}]
    if head == "softmax":
        layers.append(TC.Softmax(10, 10))
        params.append({})
    elif head == "blocksoftmax":
        layers.append(TC.BlockSoftmax(10, 10, dims=(6, 4)))
        params.append({})
    return Network(layers).from_numpy_params(params)


# the loss routing of trainer.py:200-216, read from the entry points' launches that
# ran (``_count``) over two train steps and one eval step: affine_sigmoid on every
# BiasedLinearity -> Sigmoid pair under every objective (none for a
# SparseLinearity pair), fused_softmax_xent only for a Softmax head with CE
# and no confusion mode; stats finite, and the step's CE, MSE and
# confusion totals within 1e-4 relative of the CPU's plain run
@pytest.mark.cuda
@pytest.mark.parametrize("objective,head,mode,sparse,fused", [
    ("xent", "softmax", "no", False, True), ("xent", "blocksoftmax", "no", False, False),
    ("xent", "softmax", "max", False, False), ("xent", "softmax", "dsoft", False, False),
    ("mse", "softmax", "no", False, False), ("mse", "none", "no", False, False),
    ("xent", "softmax", "no", True, True)])
def test_cuda_trainer_loss_routing_by_launch_count(cuda, objective, head, mode, sparse, fused):
    from nnet_asr_torch.train.sgd import SgdConfig
    from nnet_asr_torch.train.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(13)
    feats = rng.standard_normal((64, 20)).astype(np.float32)
    labels = rng.integers(0, 10, 64).astype(np.int32)
    stats = {}
    for dev in (cuda, torch.device("cpu")):
        cfg = TrainerConfig(bunchsize=64, cachesize=64, objective=objective,
                            confusion_mode=mode, sgd=SgdConfig(learning_rate=0.01, l1=1e-4))
        tr = Trainer(_routing_net(head, sparse), cfg, device=dev)
        x, y = torch.from_numpy(feats).to(dev), torch.from_numpy(labels).to(dev)
        before = (_count(*MA_F32), _count("softmax_xent_f32"))
        out = [tr._train_step(x, y), tr._train_step(x, y), tr._eval_step(x, y)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert _count(*MA_F32) - before[0] == (0 if sparse else 3)
            assert _count("softmax_xent_f32") - before[1] == (3 if fused else 0)
        stats[dev.type] = [{k: v.double().cpu().numpy() for k, v in s.items()} for s in out]
    for g, c in zip(stats["cuda"], stats["cpu"]):
        assert sorted(g) == sorted(c)
        for k in g:
            assert np.isfinite(g[k]).all()
            np.testing.assert_allclose(g[k], c[k], rtol=1e-4, atol=1e-4 * max(abs(c[k]).max(), 1))


# the compute dtypes' routing, read from the per-dtype launch counts over
# two train steps and one eval step at momentum 0.5: bf16 launches the bf16
# affine_sigmoid once a step and the bf16 wgrad for both weights a train
# step, and no f32 GEMM kernel; an int8 mode launches no GEMM kernel at all;
# fused_softmax_xent once a step under every dtype. The step stats within
# 1e-3 relative of the CPU's plain run under bf16 (bf16 roundings of sums
# taken in another order), 1e-4 under int8 (f32 arithmetic); int8pfsr's
# noise comes from a generator on each device, so its training stats are
# only finite
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8", "int8pf", "int8pfsr", "int8full"])
def test_cuda_trainer_compute_dtype_launch_counts(cuda, dtype):
    from nnet_asr_torch.train.sgd import SgdConfig
    from nnet_asr_torch.train.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(14)
    feats = rng.standard_normal((64, 20)).astype(np.float32)
    labels = rng.integers(0, 10, 64).astype(np.int32)
    counters = (MA_F32, MA_BF16, WG_F32, WG_BF16, ("softmax_xent_f32",))
    stats = {}
    for dev in (cuda, torch.device("cpu")):
        cfg = TrainerConfig(bunchsize=64, cachesize=64, compute_dtype=dtype,
                            sgd=SgdConfig(learning_rate=0.01, momentum=0.5))
        tr = Trainer(_routing_net("softmax", False), cfg, device=dev)
        x, y = torch.from_numpy(feats).to(dev), torch.from_numpy(labels).to(dev)
        before = [_count(*k) for k in counters]
        out = [tr._train_step(x, y), tr._train_step(x, y), tr._eval_step(x, y)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            got = [_count(*k) - b for k, b in zip(counters, before)]
            assert got == ([0, 3, 0, 4, 3] if dtype == "bf16" else [0, 0, 0, 0, 3])
        stats[dev.type] = [{k: v.double().cpu().numpy() for k, v in s.items()} for s in out]
    rtol = 1e-3 if dtype == "bf16" else 1e-4
    for g, c in zip(stats["cuda"], stats["cpu"]):
        assert sorted(g) == sorted(c)
        for k in g:
            assert np.isfinite(g[k]).all()
            if dtype != "int8pfsr" and k == "xent":
                np.testing.assert_allclose(g[k], c[k], rtol=rtol)


# one CD-1 step of each unit pairing on the card against the CPU with the
# same injected noise (f32 GEMMs in another summation order, TF32 off):
# parameters, corrections and the MSE within rtol 1e-4, atol 1e-6; and a
# draw from the trainer's generator lands on the card
@pytest.mark.cuda
@pytest.mark.parametrize("units", [("gauss", "bern"), ("bern", "bern"), ("gauss", "gauss")])
def test_cuda_cd1_step_matches_cpu(cuda, units):
    from nnet_asr_torch.models.components import Rbm
    from nnet_asr_torch.train import rbm as R

    rng = np.random.default_rng(20)
    nv, nh, B = 598, 1024, 256
    spec = Rbm(nv, nh, vis_type=units[0], hid_type=units[1])
    p = {"weight": (0.05 * rng.standard_normal((nv, nh))).astype(np.float32),
         "vis_bias": np.zeros(nv, np.float32), "hid_bias": np.zeros(nh, np.float32)}
    x = rng.standard_normal((B, nv)).astype(np.float32)
    noise = R.hidden_noise(spec, torch.Generator().manual_seed(1), (B, nh))
    if units[1] == "bern":
        # no threshold within 1e-5 of a hidden probability, where the two
        # devices' summation orders could sample differently
        probs = spec.apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
        noise = torch.where((probs - noise).abs() < 1e-5, (probs - 1e-4).clamp_min(0), noise)
    cfg = R.RbmTrainConfig(learning_rate=0.001)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = {k: torch.from_numpy(v).to(dev) for k, v in p.items()}
        state = R.init_rbm_state(spec, params, cfg)
        mse = R.cd1_step(spec, cfg, params, state, torch.from_numpy(x).to(dev),
                         noise=noise.to(dev))
        out[dev.type] = {**params, **state, "mse": mse}
    for k, v in out["cpu"].items():
        np.testing.assert_allclose(out["cuda"][k].cpu().numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    tr = R.RbmTrainer(spec, p, cfg, device=cuda)
    assert tr.generator.device.type == "cuda"
    assert R.hidden_noise(spec, tr.generator, (4, 8)).device.type == "cuda"


# one recurrent segment batch (forward, CE, gradient, momentum update) and
# a frame-serial utterance on the card against the CPU: parameters within
# rtol 1e-4, atol 1e-6, Xent within 1e-5 relative
@pytest.mark.cuda
@pytest.mark.parametrize("serial", [False, True])
def test_cuda_recurrent_matches_cpu(cuda, serial):
    from nnet_asr_torch.models.components import BiasedLinearity, Recurrent, Softmax
    from nnet_asr_torch.models.network import Network
    from nnet_asr_torch.train.recurrent import RecurrentTrainer, RecurrentTrainerConfig
    from nnet_asr_torch.train.sgd import SgdConfig

    rng = np.random.default_rng(21)
    din, dh, dout = 40, 64, 12
    params = [{"weight": (0.2 * rng.standard_normal((din + dh, dh))).astype(np.float32),
               "bias": np.zeros(dh, np.float32)},
              {"weight": (0.2 * rng.standard_normal((dh, dout))).astype(np.float32),
               "bias": np.zeros(dout, np.float32)}, {}]
    utts = [(rng.standard_normal((T, din)).astype(np.float32),
             rng.integers(0, dout, T).astype(np.int32)) for T in (37, 50, 21)]
    nets, stats = {}, {}
    for dev in (cuda, torch.device("cpu")):
        net = Network([Recurrent(din, dh), BiasedLinearity(dh, dout),
                       Softmax(dout, dout)]).from_numpy_params(params)
        tr = RecurrentTrainer(net, RecurrentTrainerConfig(
            bptt_order=4, frame_serial=serial,
            sgd=SgdConfig(learning_rate=0.02, momentum=0.5, grad_div_frm=False)), device=dev)
        if serial:
            tr.train_utterance_serial(*utts[0])
        else:
            tr.run_epoch(iter(utts), batch_utts=3)
        nets[dev.type], stats[dev.type] = tr.updated_network(), tr.stats
    assert stats["cuda"].frames == stats["cpu"].frames
    np.testing.assert_allclose(stats["cuda"].error, stats["cpu"].error, rtol=1e-5)
    for a, b in zip(nets["cuda"].to_numpy_params(), nets["cpu"].to_numpy_params()):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6, err_msg=k)


# The f32 CP_WGMMA route (csrc/cp_tf32_wgmma.cuh: 3xTF32 wgmma fed by
# cp.async, x split in the block) against the plain version at the
# recipes' shapes (MLP3, TIMIT, one tmpe utterance, a 2x2 mesh rank, the
# RBM recipe's second layer) and ragged ones (N odd: one column a store; K
# odd: 4-byte copies; a 1-element offset), under the plan's split and 1 to
# 4 splits forced: y within 1e-5, act "none" within 1e-4 of the largest;
# two launches equal bit for bit; one launch a call on the route's counter;
# the split counters left at zero.
F32_CP_SHAPES = [(960, 598, 1024), (1024, 368, 500), (284, 598, 1024), (480, 598, 1024),
                 (960, 1024, 1024), (67, 598, 135), (130, 33, 70), (1, 1, 1), (200, 256, 132, 1)]


def _f32_cp_plan(M, N, K, splits, xs, ws, wgrad=False):
    """The f32 CP_WGMMA plan of ``tile_plan.plan`` or, at a shape the plan
    sends elsewhere (a weight gradient of an odd Out: the WS_WGMMA route,
    or mma.sync), the one the route would take there; with the split
    forced unless None."""
    a_pitch = K if not wgrad else M
    pl = tile_plan.plan(M, N, K, a_pitch=a_pitch, b_pitch=N, a_ptr=xs.data_ptr(),
                        b_ptr=ws.data_ptr(), wgrad=wgrad)
    if pl.route != tile_plan.CP_WGMMA:
        assert (pl.route == tile_plan.WS_WGMMA
                or tile_plan.cp_f32_keeps_mma_sync(wgrad, N) and pl.route == tile_plan.MMA_SYNC)
        pl = tile_plan.cp_fixed(M, N, K, tile_plan.CP_F32_TILE, tile_plan.cp_f32_splits(M, N, K),
                                tile_plan.copy_bytes(a_pitch, xs.data_ptr()),
                                tile_plan.copy_bytes(N, ws.data_ptr()), elem=4)
    assert pl.route == tile_plan.CP_WGMMA and pl.tile == tile_plan.CP_F32_TILE
    if splits is None:
        return pl
    return tile_plan.cp_fixed(M, N, K, pl.tile, splits, pl.a_bytes, pl.b_bytes, elem=4)


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [None, 1, 2, 3, 4])
@pytest.mark.parametrize("shape", F32_CP_SHAPES)
def test_cuda_matmul_act_f32_cp_wgmma_matches_plain(cuda, shape, forced):
    from nnet_asr_torch.ops.kernels import _build

    M, K, N, offset = (*shape, 0)[:4]
    x, w, b, _ = _affine_inputs(41, M, K, N)
    xs, ws, bs = (_on_card(a, cuda, offset) for a in (x, w, b))
    pl = _f32_cp_plan(M, N, K, forced, xs, ws)
    stream = torch.cuda.current_stream(cuda)

    def run(act):
        if forced is None:
            return MA.matmul_act(xs, ws, bs, act)
        y = torch.empty((M, N), device=cuda)
        MA._launch_cp_wgmma(_build.load_library(), xs, ws, bs, y, act, pl, stream)
        return y

    for act in ("sigmoid", "none"):
        before = (_count(*MA_F32), _count("matmul_act_f32_cp_wgmma"),
                  _count("matmul_act_f32_wgmma"))
        y1, y2 = run(act), run(act)
        assert (_count(*MA_F32), _count("matmul_act_f32_cp_wgmma"),
                _count("matmul_act_f32_wgmma")) == (before[0] + 2, before[1] + 2, before[2])
        yp = MA.matmul_act_plain(xs, ws, bs, act)
        torch.cuda.synchronize()
        assert torch.equal(y1, y2)
        tol = 1e-5 if act == "sigmoid" else 1e-4 * (yp.abs().max().item() or 1.0)
        assert (y1 - yp).abs().max().item() <= tol
    assert not _build.counters(cuda, stream).any().item()


# The f32 CP_WGMMA weight gradient against the plain version: MLP3's two
# weights, TIMIT's hidden and output ones, ragged shapes (Out odd: one
# column a store; a 1-element offset: 4-byte copies), f32 and bf16
# velocity, under the plan's split and 1, 2, 3 and 5 splits forced (an odd
# Out, which the plan keeps on mma.sync, launched on the route by its
# split rule): p and v within 1e-5 of the largest (bf16 v: plus one bf16
# step); two runs equal bit for bit; the route's counter once a call.
F32_CP_WGRAD = [(960, 598, 1024), (960, 1024, 135), (1024, 368, 500), (1024, 500, 39),
                (67, 61, 135), (300, 256, 520, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [None, 1, 2, 3, 5])
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", F32_CP_WGRAD)
def test_cuda_wgrad_f32_cp_wgmma_matches_plain(cuda, shape, vdt, forced):
    from nnet_asr_torch.ops.kernels import _build

    B, In, Out, offset = (*shape, 0)[:4]
    rng = np.random.default_rng(12)
    x, e = (rng.standard_normal((B, n)).astype(np.float32) for n in (In, Out))
    p, v = (rng.standard_normal((In, Out)).astype(np.float32) for _ in range(2))
    xs, es = (_on_card(a, cuda, offset) for a in (x, e))
    pl = _f32_cp_plan(In, Out, B, forced, xs, es, wgrad=True)
    stream = torch.cuda.current_stream(cuda)

    def run(pk, vk):
        if forced is None and Out % 2 == 0:
            SF.wgrad_momentum_update(xs, es, pk, vk, 0.003, 0.9)
        else:
            SF._launch_f32_cp_wgmma(_build.load_library(), xs, es, pk, vk, 0.003, 0.9, pl, stream)

    pk, pp, pk2 = (torch.from_numpy(p).to(cuda) for _ in range(3))
    vk, vp, vk2 = (torch.from_numpy(v).to(cuda, vdt) for _ in range(3))
    before = _count("wgrad_momentum_update_f32_cp_wgmma")
    run(pk, vk)
    run(pk2, vk2)
    assert _count("wgrad_momentum_update_f32_cp_wgmma") == before + 2
    SF.wgrad_momentum_update_plain(xs, es, pp, vp, 0.003, 0.9)
    torch.cuda.synchronize()
    assert torch.equal(pk, pk2) and torch.equal(vk, vk2)
    assert (pk - pp).abs().max().item() <= 1e-5 * pp.abs().max().item()
    tol = 1e-5 * vp.float().abs().max()
    if vdt == torch.bfloat16:
        tol = tol + bf16_ulp(torch.maximum(vk.float().abs(), vp.float().abs()))
    assert bool(((vk.float() - vp.float()).abs() <= tol).all())
    assert not _build.counters(cuda, stream).any().item()


# Small integers make every 3xTF32 sum exact (hi holds the value, lo is
# 0), so y and g equal the exact product's bits: a wrong swizzle, fragment,
# descriptor, transpose, zero fill or split sum moves whole elements. K =
# 598 leaves the last k8 slice 6 deep; whole and split; each copy width (x
# 8 or 16 bytes and W 16 or 4 in the forward; x 8 or 16 and e 16 or 4 in
# the weight gradient).
@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("which,shape", [("forward", (200, 598, 1024)),
                                         ("forward", (300, 368, 135)),
                                         ("wgrad", (300, 598, 1024)),
                                         ("wgrad", (960, 1024, 135))])
def test_cuda_f32_cp_wgmma_layouts_exact(cuda, which, shape, splits):
    from nnet_asr_torch.ops.kernels import _build

    rng = np.random.default_rng(23)
    stream = torch.cuda.current_stream(cuda)
    lib = _build.load_library()
    if which == "forward":
        M, K, N = shape
        x = torch.from_numpy(rng.integers(-2, 3, (M, K)).astype(np.float32)).to(cuda)
        w = torch.from_numpy(rng.integers(-2, 3, (K, N)).astype(np.float32)).to(cuda)
        b = torch.from_numpy(rng.integers(-2, 3, N).astype(np.float32)).to(cuda)
        pl = _f32_cp_plan(M, N, K, splits, x, w)
        y = torch.empty((M, N), device=cuda)
        MA._launch_cp_wgmma(lib, x, w, b, y, "none", pl, stream)
        torch.cuda.synchronize()
        assert torch.equal(y, (x.double() @ w.double() + b.double()).float())
    else:
        B, In, Out = shape
        x = torch.from_numpy(rng.integers(-2, 3, (B, In)).astype(np.float32)).to(cuda)
        e = torch.from_numpy(rng.integers(-2, 3, (B, Out)).astype(np.float32)).to(cuda)
        p, v = torch.zeros((In, Out), device=cuda), torch.zeros((In, Out), device=cuda)
        pl = _f32_cp_plan(In, Out, B, splits, x, e, wgrad=True)
        SF._launch_f32_cp_wgmma(lib, x, e, p, v, 1.0, 0.0, pl, stream)
        torch.cuda.synchronize()
        g = (x.double().T @ e.double()).float()
        assert torch.equal(v, g) and torch.equal(p, -g)


# The f32 WS_WGMMA route (csrc/cp_tf32_wgmma.cuh's warp-specialised ring:
# a producer warpgroup copying e's rows and transposing and splitting them,
# a consumer warpgroup issuing wgmma) against the plain version: the weight
# gradient with Out on wgmma's N, one tile of 136 columns (MLP3's 135
# outputs, TIMIT's 39, 129 to 136, ragged In and B, a 1-element offset:
# 4-byte copies of x and of e's rows), f32 and bf16 velocity, under its plan
# and 1 to 8 splits forced. Tolerances as the CP_WGMMA route's above; two
# launches equal bit for bit (the splits of a tile, one cluster, summed in
# split order); the route's counter once a call. An Out past the tile
# raises.
def _ws_plan(In, Out, B, splits, xs, es):
    """The WS_WGMMA plan of the weight gradient g = x^T e (In, Out, the
    bunch B) whether or not tile_plan.plan routes the shape there; the
    split forced unless None."""
    s = tile_plan.ws_splits(In, Out, B) if splits is None else splits
    return tile_plan.cp_fixed(In, Out, B, tile_plan.ROWS, s,
                              tile_plan.copy_bytes(In, xs.data_ptr()),
                              tile_plan.ws_rows_e_bytes(Out, es.data_ptr()), 4,
                              tile_plan.WS_WGMMA)


F32_WS_WGRAD = [(960, 1024, 135), (1024, 500, 39), (67, 61, 135), (300, 256, 130, 1),
                (284, 1024, 135), (1, 1, 1), (960, 598, 136), (300, 256, 129, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [None, 1, 2, 3, 5, 8])
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", F32_WS_WGRAD)
def test_cuda_wgrad_f32_ws_wgmma_matches_plain(cuda, shape, vdt, forced):
    from nnet_asr_torch.ops.kernels import _build

    B, In, Out, offset = (*shape, 0)[:4]
    rng = np.random.default_rng(14)
    x, e = (rng.standard_normal((B, n)).astype(np.float32) for n in (In, Out))
    p, v = (rng.standard_normal((In, Out)).astype(np.float32) for _ in range(2))
    xs, es = (_on_card(a, cuda, offset) for a in (x, e))
    pl = _ws_plan(In, Out, B, forced, xs, es)
    routed = tile_plan.plan(In, Out, B, In, Out, xs.data_ptr(), es.data_ptr(), wgrad=True)
    stream = torch.cuda.current_stream(cuda)

    def run(pk, vk):
        if forced is None and routed.route == tile_plan.WS_WGMMA:
            assert routed == pl
            SF.wgrad_momentum_update(xs, es, pk, vk, 0.003, 0.9)
        else:
            SF._launch_f32_ws_wgmma(_build.load_library(), xs, es, pk, vk, 0.003, 0.9, pl, stream)

    pk, pp, pk2 = (torch.from_numpy(p).to(cuda) for _ in range(3))
    vk, vp, vk2 = (torch.from_numpy(v).to(cuda, vdt) for _ in range(3))
    before = _count("wgrad_momentum_update_f32_ws_wgmma")
    run(pk, vk)
    run(pk2, vk2)
    assert _count("wgrad_momentum_update_f32_ws_wgmma") == before + 2
    SF.wgrad_momentum_update_plain(xs, es, pp, vp, 0.003, 0.9)
    torch.cuda.synchronize()
    assert torch.equal(pk, pk2) and torch.equal(vk, vk2)
    assert (pk - pp).abs().max().item() <= 1e-5 * pp.abs().max().item()
    tol = 1e-5 * vp.float().abs().max()
    if vdt == torch.bfloat16:
        tol = tol + bf16_ulp(torch.maximum(vk.float().abs(), vp.float().abs()))
    assert bool(((vk.float() - vp.float()).abs() <= tol).all())


# Small integers make every 3xTF32 sum exact: the WS kernel's swizzles,
# fragments, descriptors, the producer's transposing split, the run copies
# of e's rows (zero past the bunch, the padded columns dropped), zero fill
# and the split sums move whole elements if wrong.
@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("shape", [(960, 1024, 135), (283, 300, 39), (300, 598, 136),
                                   (200, 598, 129), (300, 368, 135)])
def test_cuda_f32_ws_wgmma_layouts_exact(cuda, shape, splits):
    from nnet_asr_torch.ops.kernels import _build

    rng = np.random.default_rng(29)
    B, In, Out = shape
    x = torch.from_numpy(rng.integers(-2, 3, (B, In)).astype(np.float32)).to(cuda)
    e = torch.from_numpy(rng.integers(-2, 3, (B, Out)).astype(np.float32)).to(cuda)
    p, v = torch.zeros((In, Out), device=cuda), torch.zeros((In, Out), device=cuda)
    SF._launch_f32_ws_wgmma(_build.load_library(), x, e, p, v, 1.0, 0.0,
                            _ws_plan(In, Out, B, splits, x, e), torch.cuda.current_stream(cuda))
    torch.cuda.synchronize()
    g = (x.double().T @ e.double()).float()
    assert torch.equal(v, g) and torch.equal(p, -g)


# The kernel holds one tile of 136 columns: a wider Out is refused by the
# launch, not computed in part
@pytest.mark.cuda
def test_cuda_f32_ws_wgmma_refuses_wide_out(cuda):
    from nnet_asr_torch.ops.kernels import _build

    B, In, Out = 64, 64, 137
    x, e = torch.ones((B, In), device=cuda), torch.ones((B, Out), device=cuda)
    p, v = torch.zeros((In, Out), device=cuda), torch.zeros((In, Out), device=cuda)
    with pytest.raises(RuntimeError):
        SF._launch_f32_ws_wgmma(_build.load_library(), x, e, p, v, 1.0, 0.0,
                                _ws_plan(In, Out, B, 1, x, e), torch.cuda.current_stream(cuda))

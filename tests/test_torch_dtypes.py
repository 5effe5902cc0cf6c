"""The compute dtypes of the port (bf16 and the four int8 modes) against the
JAX package's, on the CPU.

The bf16 kernels' plain versions and autograd against the JAX Pallas
kernel at bf16 (interpret mode, as tests/test_pallas.py runs it), the
fused update's bf16-operand plain version against ``dot(xᵀ, e)`` rounded to
bf16 and JAX ``apply_updates``, the launch plan at two bytes an element,
the int8 fake-quant and ``qmatmul`` against ``nnet_asr_tpu/ops/int8_train``,
whole Trainer epochs per dtype against JAX ``Trainer(use_pallas=True,
compute_dtype=...)``, int8pfsr by its properties (its noise stream is not
JAX's), and the pipeline's inference modes against JAX's
``transform_block``. Inputs come from numpy with a seed; tolerances are
stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnet_asr_tpu.models.network import Network as JNetwork
from nnet_asr_tpu.ops import int8_train as jint8
from nnet_asr_tpu.ops.pallas.matmul_act import affine_sigmoid as j_affine_sigmoid
from nnet_asr_tpu.ops.pallas.matmul_act import matmul_act as j_matmul_act
from nnet_asr_tpu.train import sgd as jsgd
from nnet_asr_tpu.train.pipeline import TransformPipeline as JPipeline
from nnet_asr_tpu.train.trainer import Trainer as JTrainer
from nnet_asr_tpu.train.trainer import TrainerConfig as JTrainerConfig
from nnet_asr_torch.models.network import Network as TNetwork
from nnet_asr_torch.ops import int8_train
from nnet_asr_torch.ops.kernels import _build
from nnet_asr_torch.ops.kernels import matmul_act as MA
from nnet_asr_torch.ops.kernels import sgd_fused as SF
from nnet_asr_torch.ops.kernels import tile_plan
from nnet_asr_torch.train import sgd as tsgd
from nnet_asr_torch.train.pipeline import TransformPipeline, int_mm
from nnet_asr_torch.train.trainer import Trainer, TrainerConfig

from test_torch_kernels import _affine_inputs
from test_torch_train import _ext_utts, _hamm_norm_text, _mlp_text, _nonlinear_text, _utts

torch.set_num_threads(2)

BF16 = torch.bfloat16


def bf16_step(a):
    """One bf16 step (8 significant bits) at each element's magnitude."""
    mag = np.maximum(np.abs(np.asarray(a, np.float64)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _f32(a):
    return (a.detach().float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


# --------------------------------------------------------------------------
# the kernels' plain versions at bf16
# --------------------------------------------------------------------------

# y within one bf16 step of JAX's at each element (both round the f32
# result once; the f32 sums differ in order); dx, dW and db within one bf16
# step of each gradient's largest magnitude (each is one rounding of an f32
# GEMM of the same bf16 dz, or of an f32 sum). (M, K, N): one K block, and
# K > 1024 (several K blocks in the Pallas kernel)
@pytest.mark.parametrize("shape", [(40, 70, 50), (24, 1100, 60)])
def test_affine_sigmoid_bf16_plain_matches_pallas(shape):
    x, w, b, g = _affine_inputs(3, *shape)
    jy, vjp = jax.vjp(j_affine_sigmoid, *(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)))
    jgrads = vjp(jnp.asarray(g, jnp.bfloat16))
    ts = [torch.from_numpy(a).to(BF16).requires_grad_(True) for a in (x, w, b)]
    before = (MA.matmul_act.launches, MA.matmul_act.launches_bf16)
    y = MA.affine_sigmoid(*ts)
    y.backward(torch.from_numpy(g).to(BF16))
    assert (MA.matmul_act.launches, MA.matmul_act.launches_bf16) == before
    assert y.dtype == BF16 and jy.dtype == jnp.bfloat16
    ty, jyf = _f32(y), _f32(jy)
    assert (np.abs(ty - jyf) <= bf16_step(np.maximum(np.abs(ty), np.abs(jyf)))).all()
    for t, jg in zip(ts, jgrads):
        assert t.grad.dtype == BF16 and jg.dtype == jnp.bfloat16
        jgf = _f32(jg)
        assert np.abs(_f32(t.grad) - jgf).max() <= bf16_step(np.abs(jgf).max())
    # no activation: the affine alone, rounded once
    z = _f32(MA.matmul_act(*(t.detach() for t in ts), "none"))
    jz = _f32(j_matmul_act(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)), act="none"))
    assert (np.abs(z - jz) <= bf16_step(np.maximum(np.abs(z), np.abs(jz))) + 1e-5).all()


# the plain fused update with bf16 x and e against JAX's bf16 mode: dW =
# dot(xᵀ, dz, f32 accumulation) rounded to bf16, then apply_updates in f32.
# g is representable in bf16 (rounded once, after the whole sum); v within
# one bf16 step of g (and of v, for bf16 v) where the two f32 sums round to
# neighbouring values, p within lr times that
@pytest.mark.parametrize("vdt", ["f32", "bf16"])
def test_wgrad_momentum_bf16_plain_matches_jax_apply_updates(vdt):
    rng = np.random.default_rng(4)
    B, In, Out = 60, 37, 9
    x = (0.5 * rng.standard_normal((B, In))).astype(np.float32)
    e = (0.5 * rng.standard_normal((B, Out))).astype(np.float32)
    p = (0.2 * rng.standard_normal((In, Out))).astype(np.float32)
    v = (0.5 * rng.standard_normal((In, Out))).astype(np.float32)
    cfg = dict(learning_rate=0.05, momentum=0.9, grad_div_frm=False,
               velocity_dtype=None if vdt == "f32" else "bf16")
    text = (f"<biasedlinearity> {Out} {In}\nm {Out} {In}\n"
            + "\n".join(" ".join(repr(float(c)) for c in row) for row in p.T)
            + f"\nv {Out}\n" + " ".join(["0"] * Out) + "\n")
    jnet = JNetwork.read(text)
    jvdt = jnp.bfloat16 if vdt == "bf16" else jnp.float32
    xb, eb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(e, jnp.bfloat16)
    jg = jnp.dot(xb.T, eb, preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    jp, jv = jsgd.apply_updates(
        jnet, [{k: jnp.asarray(a) for k, a in jnet.params[0].items()}],
        [{"weight": jnp.asarray(v, jvdt), "bias": jnp.zeros(Out, jvdt)}],
        [{"weight": jg.astype(jnp.float32)}], jsgd.SgdConfig(**cfg), B, [1.0])

    a, _, _ = tsgd.layer_coeffs(tsgd.SgdConfig(**cfg), B, 1.0)
    tdt = BF16 if vdt == "bf16" else torch.float32
    xs, es = torch.from_numpy(x).to(BF16), torch.from_numpy(e).to(BF16)
    tp, tv = torch.from_numpy(p.copy()), torch.from_numpy(v).to(tdt)
    before = (SF.wgrad_momentum_update.launches, SF.wgrad_momentum_update.launches_bf16)
    SF.wgrad_momentum_update(xs, es, tp, tv, a, 0.9)
    assert (SF.wgrad_momentum_update.launches, SF.wgrad_momentum_update.launches_bf16) == before
    assert tp.dtype == torch.float32 and tv.dtype == tdt
    g = _f32(jg)
    tol_v = bf16_step(g) + (bf16_step(_f32(jv[0]["weight"])) if vdt == "bf16" else 1e-7)
    assert (np.abs(_f32(tv) - _f32(jv[0]["weight"])) <= tol_v).all()
    assert (np.abs(tp.numpy() - _f32(jp[0]["weight"])) <= a * tol_v + 1e-7).all()
    # g itself, read back from an f32 velocity at momentum 0: one bf16
    # rounding of the f32 sum
    gp, gv = torch.zeros((In, Out)), torch.zeros((In, Out))
    SF.wgrad_momentum_update_plain(xs, es, gp, gv, 1.0, 0.0)
    assert torch.equal(gv, gv.to(BF16).float())
    assert torch.equal(gv, (xs.float().T @ es.float()).to(BF16).float())
    assert (np.abs(gv.numpy() - g) <= bf16_step(g)).all()


# --------------------------------------------------------------------------
# the launch plan at two bytes an element
# --------------------------------------------------------------------------

# (M, N, K, a_pitch, b_pitch, wgrad) -> (tile, splits, k_chunk, a_bytes,
# b_bytes, route): MLP3's rows of 598 and 135 bf16 are no multiple of 16
# bytes, so TMA reads neither; its forward (x at 1,196-byte rows, whole
# 4-byte units) takes CP_WGMMA (64x64 tiles, 4-byte copies of x, no split),
# and so do its weight gradients: 598->1024 on 64x64 tiles, 3 splits of 5
# steps as clusters (4-byte copies of x, 16-byte of e), 1024->135 on the
# 64x136 ROWS tile, 5 splits of 3 steps (e's stage of 64 rows of 270 bytes
# one run, 16 bytes a copy); every production shape takes WGMMA (no split;
# 128x256 tiles for the forward, 128x128 for the ping-pong weight gradient)
W, MS, CP = tile_plan.WGMMA, tile_plan.MMA_SYNC, tile_plan.CP_WGMMA
BF16_PLANS = {
    "affine 960x598->1024 (MLP3)": ((960, 1024, 598, 598, 1024, False),
                                    (tile_plan.SMALL, 1, 598, 4, 16, CP)),
    "affine 1024x1024->4096": ((1024, 4096, 1024, 1024, 4096, False),
                               (tile_plan.WIDE, 1, 1024, 16, 16, W)),
    "affine 1024x4096->4096": ((1024, 4096, 4096, 4096, 4096, False),
                               (tile_plan.WIDE, 1, 4096, 16, 16, W)),
    "wgrad 960x598->1024 (MLP3)": ((598, 1024, 960, 598, 1024, True),
                                   (tile_plan.SMALL, 3, 320, 4, 16, CP)),
    # e's rows of 135 bf16 are 270 bytes: an odd pitch in 4-byte words, but
    # a stage of 64 whole rows is 17,280 bytes, a whole number of 16
    "wgrad 960x1024->135 (MLP3)": ((1024, 135, 960, 1024, 135, True),
                                   (tile_plan.ROWS, 5, 192, 16, 16, CP)),
    "wgrad 1024x1024->4096": ((1024, 4096, 1024, 1024, 4096, True),
                              (tile_plan.BIG, 1, 1024, 16, 16, W)),
    "wgrad 1024x4096->4096": ((4096, 4096, 1024, 4096, 4096, True),
                              (tile_plan.BIG, 1, 1024, 16, 16, W)),
    "wgrad 1024x4096->8192": ((4096, 8192, 1024, 4096, 8192, True),
                              (tile_plan.BIG, 1, 1024, 16, 16, W)),
}


@pytest.mark.parametrize("name", sorted(BF16_PLANS))
def test_bf16_plan_of_main_path_shapes(name):
    (M, N, K, ap, bp, split), want = BF16_PLANS[name]
    p = tile_plan.plan(M, N, K, a_pitch=ap, b_pitch=bp, a_ptr=256, b_ptr=512, wgrad=split,
                       elem=2)
    assert (p.tile, p.splits, p.k_chunk, p.a_bytes, p.b_bytes, p.route) == want
    # f32 operands: the f32 WGMMA route at the production shapes (128x128
    # tiles on a persistent grid, the forward's too), the f32 CP_WGMMA one
    # at MLP3's forward and 598->1024 weight gradient (where bf16's weight
    # gradients keep mma.sync); the WS_WGMMA one at 960x1024->135, an odd Out
    f = tile_plan.plan(M, N, K, a_pitch=ap, b_pitch=bp, a_ptr=256, b_ptr=512, wgrad=split)
    assert f.route == (W if p.route == W else tile_plan.WS_WGMMA if split and bp % 2 else CP)
    if f.route == tile_plan.WGMMA:
        assert (f.tile, f.splits, f.blocks) == (tile_plan.BIG, 1, tile_plan.SM_COUNT)
    elif f.route == tile_plan.WS_WGMMA:   # Out on wgmma's N, the route's own split
        assert (f.tile, f.splits) == (tile_plan.ROWS, tile_plan.ws_splits(M, N, K))
    else:   # the f32 CP_WGMMA tile and split rule, which the bf16 routes leave alone
        assert (f.tile, f.splits) == (tile_plan.CP_F32_TILE, tile_plan.cp_f32_splits(M, N, K))
    if p.route == CP and split:
        # In on wgmma's M, Out on its N: the ROWS tile across an Out of at
        # most 136, else the column tile; the route's own split rule
        assert p.tile == (tile_plan.ROWS if N <= tile_plan.CP_WGRAD_ROWS
                          else tile_plan.CP_WGRAD_TILE)
        assert p == tile_plan.cp_fixed(M, N, K, p.tile,
                                       tile_plan.cp_wgrad_splits(M, N, K, p.tile),
                                       p.a_bytes, p.b_bytes)
        assert p.blocks == tile_plan.tile_count(M, N, p.tile) * p.splits
    elif p.route == CP:
        assert (p.tile, p.splits) == (tile_plan.SMALL, tile_plan.cp_splits(M, N, K))
        assert p.blocks == tile_plan.tile_count(M, N, p.tile) * p.splits
    else:
        # one block a 128x256 tile; the weight gradient's grid persistent
        tiles = tile_plan.tile_count(M, N, p.tile)
        assert p.blocks == (min(tiles, tile_plan.SM_COUNT) if split else tiles)


# The route rule: WGMMA exactly where both row pitches are 16-byte
# multiples and every pointer (operands and outputs) is 16-byte aligned;
# ragged M, N and K with such pitches stay on WGMMA; f32 takes it only
# where, besides, K is a multiple of 4 floats and the 128x128 tiles fill
# the card (the production shape, not a 128x256 product). (M, N, K,
# a_pitch, b_pitch, a_ptr, b_ptr, out_ptrs, elem) -> WGMMA?
@pytest.mark.parametrize("args,wgmma", [
    ((128, 256, 64, 64, 256, 0, 0, (), 2), True),             # one tile
    ((1000, 4104, 1000, 1000, 4104, 0, 0, (), 2), True),      # ragged M, N, K
    ((1, 8, 8, 8, 8, 0, 0, (), 2), True),                     # smaller than one box
    ((1032, 4104, 1000, 1032, 4104, 16, 32, (48, 4096), 2), True),
    ((960, 1024, 598, 598, 1024, 0, 0, (), 2), False),        # a pitch of 1,196 bytes
    ((1024, 135, 960, 1024, 135, 0, 0, (), 2), False),        # a pitch of 270 bytes
    ((64, 128, 100, 100, 128, 0, 0, (), 2), False),           # 200 bytes: 4-byte rows only
    ((64, 128, 128, 128, 128, 8, 0, (), 2), False),           # A base 8 bytes off
    ((64, 128, 128, 128, 128, 0, 2, (), 2), False),           # B base 2 bytes off
    ((64, 128, 128, 128, 128, 0, 0, (4,), 2), False),         # an output 4 bytes off
    ((64, 128, 128, 128, 128, 0, 0, (0, 8), 2), False),       # the second output off
    ((1024, 4096, 4096, 4096, 4096, 0, 0, (), 4), True),      # f32: the production shape
    ((128, 256, 64, 64, 256, 0, 0, (0,), 4), False),          # f32: 2 tiles for 132 SMs
])
def test_wgmma_route_rule(args, wgmma):
    M, N, K, ap, bp, a_ptr, b_ptr, outs, elem = args
    for split in (False, True):
        p = tile_plan.plan(M, N, K, a_pitch=ap, b_pitch=bp, a_ptr=a_ptr, b_ptr=b_ptr,
                           wgrad=split, elem=elem, out_ptrs=outs)
        assert (p.route == tile_plan.WGMMA) == wgmma
        # the TMA part of the rule; an f32 product off the route for its
        # tile count alone passes it
        few_tiles = elem == 4 and tile_plan.tile_count(M, N, tile_plan.BIG) < tile_plan.SM_COUNT
        assert tile_plan.wgmma_route(elem, (ap, bp), (a_ptr, b_ptr, *outs)) == (wgmma or few_tiles)
        if wgmma:
            persistent = split or elem == 4
            want = (tile_plan.BIG, 128, 128) if persistent else (tile_plan.WIDE, 128, 256)
            assert (p.tile, p.bm, p.bn, p.splits, p.k_chunk) == (*want, 1, K)
            assert (p.a_bytes, p.b_bytes) == (16, 16)
        elif p.route == tile_plan.CP_WGMMA:
            # off TMA but in whole 4-byte units (e's base 16-byte aligned
            # where one ROWS tile spans Out): the bf16 cp.async routes, the
            # forward on 64x64 tiles, the weight gradient on its own; f32
            # products of too few BIG tiles, the forward and the weight
            # gradient
            assert elem == 2 or few_tiles
            want = (tile_plan.CP_F32_TILE if elem == 4 else
                    tile_plan.cp_wgrad_tile(N, ap, bp, a_ptr, b_ptr, outs) if split else
                    tile_plan.SMALL)
            assert p.tile == want
        else:
            assert p.tile in (tile_plan.BIG, tile_plan.SMALL)


# The CP_WGMMA route (bf16 forward, wgmma fed by cp.async) at the recipes'
# shapes: (M, K, N) -> (splits, k_chunk, x copy bytes, W copy bytes),
# 64x64 tiles. MLP3's 240 tiles and TIMIT's 128 over 6 steps of 64 stay
# whole; one tmpe utterance's 80 tiles split 3 ways (4 steps, the last
# ragged), a 2x2 mesh rank's 128 tiles over 10 steps 2 ways; x's rows of
# 1,196 bytes take 4-byte copies, TIMIT's x of 736 bytes 16-byte ones and
# its W of 1,000 bytes 8-byte ones.
CP_PLANS = {(960, 598, 1024): (1, 598, 4, 16), (1024, 368, 500): (1, 368, 16, 8),
            (284, 598, 1024): (3, 256, 4, 16), (480, 598, 1024): (2, 320, 4, 16),
            (307, 598, 1024): (3, 256, 4, 16)}


@pytest.mark.parametrize("shape", sorted(CP_PLANS))
def test_cp_wgmma_plan_of_recipe_shapes(shape):
    M, K, N = shape
    p = tile_plan.plan(M, N, K, a_pitch=K, b_pitch=N, a_ptr=1 << 20, b_ptr=1 << 21, elem=2,
                       out_ptrs=(1 << 22,))
    splits, k_chunk, a_bytes, b_bytes = CP_PLANS[shape]
    tiles = tile_plan.tile_count(M, N, tile_plan.SMALL)
    assert p == tile_plan.Plan(tile_plan.SMALL, 64, 64, splits, k_chunk, a_bytes, b_bytes,
                               tile_plan.CP_WGMMA, tiles * splits)
    # a split covers whole CP_BK steps, the splits cover K, and a split
    # grid fits CP_PER_SM blocks an SM with a counter a tile
    assert k_chunk * (splits - 1) < K <= k_chunk * splits
    if splits > 1:
        assert k_chunk % tile_plan.CP_BK == 0
        assert k_chunk >= tile_plan.CP_MIN_K_STEPS * tile_plan.CP_BK
        assert p.blocks <= tile_plan.CP_PER_SM * tile_plan.SM_COUNT
        assert tiles <= _build.COUNTERS


# Rows the route cannot copy stay on MMA_SYNC with the plan they had: a
# 2-byte pitch (K = 135, N = 135, K = 33), a base or output 2 bytes off a
# 4-byte boundary; the weight gradient's refusals: e's rows of 135 (a
# 2-byte pitch) from a base off 16 bytes, so a stage of whole rows is no
# run of 16-byte copies; x's rows of 61 (odd 2-byte units) or its base 2
# bytes off. (M, N, K, a_pitch, b_pitch, a_ptr, b_ptr, out_ptrs, wgrad)
@pytest.mark.parametrize("args", [
    (960, 1024, 135, 135, 1024, 0, 0, (), False),
    (67, 135, 598, 598, 135, 0, 0, (), False),
    (130, 70, 33, 33, 70, 0, 0, (), False),
    (200, 132, 256, 256, 132, 2, 0, (), False),
    (200, 132, 256, 256, 132, 0, 6, (), False),
    (960, 1024, 598, 598, 1024, 0, 0, (2,), False),
    (1024, 135, 960, 1024, 135, 0, 4, (), True),
    (1024, 135, 960, 1024, 135, 0, 8, (), True),
    (61, 1024, 960, 61, 1024, 0, 0, (), True),
    (598, 1024, 960, 598, 1024, 2, 0, (), True),
])
def test_two_byte_pitches_stay_on_mma_sync(args):
    M, N, K, ap, bp, a_ptr, b_ptr, outs, wgrad = args
    p = tile_plan.plan(M, N, K, ap, bp, a_ptr, b_ptr, wgrad=wgrad, elem=2, out_ptrs=outs)
    assert p.route == tile_plan.MMA_SYNC
    if wgrad:
        assert tile_plan.cp_wgrad_tile(N, ap, bp, a_ptr, b_ptr, outs) is None
    else:
        assert not tile_plan.cp_wgmma_route(2, (ap, bp), (a_ptr, b_ptr, *outs))
    saved = tile_plan.CP_WGMMA_ELEMS
    try:
        tile_plan.CP_WGMMA_ELEMS = ()
        assert tile_plan.plan(M, N, K, ap, bp, a_ptr, b_ptr, wgrad=wgrad, elem=2,
                              out_ptrs=outs) == p
    finally:
        tile_plan.CP_WGMMA_ELEMS = saved


# f32 operands take the route (csrc/cp_tf32_wgmma.cuh), forward and weight
# gradient, at every shape of the main paths whose 128x128 tiles leave the
# card idle, but the weight gradient of an odd Out, on the WS_WGMMA route
# where its N width is built (ws_f32_takes: 135) and else on its mma.sync
# plan (cp_f32_keeps_mma_sync), neither changed; with the route switched off for 4-byte
# elements the plan is the MMA_SYNC one it was, on the 64x64 tile and the
# same copy widths (its split rule takes three blocks an SM at a time, the
# route's waves of two); the production shapes keep the f32 WGMMA plan,
# route on or off
@pytest.mark.parametrize("shape", [*sorted(CP_PLANS), (1024, 1024, 4096), (1024, 4096, 4096),
                                   (67, 598, 135), (1024, 500, 39)])
@pytest.mark.parametrize("wgrad", [False, True])
def test_f32_plans_unchanged_by_the_cp_wgmma_route(shape, wgrad):
    M, K, N = shape
    p = tile_plan.plan(M, N, K, K, N, 1 << 20, 1 << 21, wgrad=wgrad, out_ptrs=(1 << 22,))
    saved = tile_plan.CP_WGMMA_ELEMS
    try:
        tile_plan.CP_WGMMA_ELEMS = (2,)
        q = tile_plan.plan(M, N, K, K, N, 1 << 20, 1 << 21, wgrad=wgrad, out_ptrs=(1 << 22,))
    finally:
        tile_plan.CP_WGMMA_ELEMS = saved
    if tile_plan.tile_count(M, N, tile_plan.BIG) >= tile_plan.SM_COUNT:
        assert p == q and p.route == tile_plan.WGMMA
    elif tile_plan.ws_f32_takes(M, N, K, wgrad, N):
        # the WS_WGMMA route's plan (an odd Out it is built for), the
        # CP_WGMMA route on or off
        assert p == q and p.route == tile_plan.WS_WGMMA and N % 2 == 1
    elif tile_plan.cp_f32_keeps_mma_sync(wgrad, N):
        assert p == q and p.route == tile_plan.MMA_SYNC and N % 2 == 1
    else:
        assert q.route == tile_plan.MMA_SYNC and p.route == tile_plan.CP_WGMMA
        assert (q.tile, p.tile) == (tile_plan.SMALL, tile_plan.CP_F32_TILE)
        assert (p.a_bytes, p.b_bytes) == (q.a_bytes, q.b_bytes)
        assert p.splits == tile_plan.cp_f32_splits(M, N, K)
        assert q.splits == tile_plan.split_count(tile_plan.tile_count(M, N, q.tile),
                                                 -(-K // tile_plan.BK))


# The CP_WGMMA block's shared memory (SMEM_BYTES of its CpTile: a ring of
# CP_STAGES stages, 128 bytes a row of x and a k-line of W at CP_BK, and
# 1024 bytes of slack) fits a block and four blocks an SM, twice the
# CP_PER_SM the split aims at; the staged y tile (rows of 2 bn + 16 bytes)
# fits the ring; the tiles it was measured against fit a block at 4 stages
def test_cp_wgmma_tile_fits_the_shared_memory():
    smem = tile_plan.cp_smem_bytes()
    assert smem == tile_plan.CP_STAGES * (64 * 128 + 64 * 128) + 1024 == 50176
    assert tile_plan.SM_SMEM // (smem + 16 + tile_plan.BLOCK_SMEM_RESERVED) == 4
    assert 64 * (2 * 64 + 16) <= smem - 1024
    for tile in (tile_plan.HALF, tile_plan.TALL, tile_plan.BIG):
        bm, bn = tile_plan.TILES[tile]
        ring = tile_plan.cp_smem_bytes(tile, stages=4) - 1024
        assert ring == 4 * (bm * 128 + (bn // 64) * 64 * 128)
        assert ring + 1024 + tile_plan.BLOCK_SMEM_RESERVED <= tile_plan.SM_SMEM
        assert bm * (2 * bn + 16) <= ring


# cp_fixed, the plan the measurements force: splits of whole CP_BK steps
# that cover K, fewer where K has fewer steps, k_chunk = K when whole
@pytest.mark.parametrize("K,splits,want", [(598, 1, (1, 598)), (598, 2, (2, 320)),
                                           (598, 3, (3, 256)), (598, 4, (4, 192)),
                                           (368, 4, (3, 128)), (64, 3, (1, 64)),
                                           (2, 2, (1, 2))])
def test_cp_fixed_splits(K, splits, want):
    p = tile_plan.cp_fixed(960, 1024, K, tile_plan.SMALL, splits, 4, 16)
    assert (p.splits, p.k_chunk) == want
    assert p.blocks == tile_plan.tile_count(960, 1024, tile_plan.SMALL) * p.splits
    assert p.route == tile_plan.CP_WGMMA


@pytest.mark.parametrize("pitch,ptr,elem,want", [
    (598, 0, 2, 4), (135, 0, 2, 2), (1024, 0, 2, 16), (4096, 0, 2, 16), (8192, 0, 2, 16),
    (1024, 2, 2, 2), (1024, 4, 2, 4), (1024, 16, 2, 16), (136, 0, 2, 16), (2, 0, 2, 4),
    (598, 0, 4, 8), (135, 0, 4, 4), (1024, 4, 4, 4), (1024, 0, 4, 16)])
def test_copy_width_follows_pitch_alignment_and_element_size(pitch, ptr, elem, want):
    assert tile_plan.copy_bytes(pitch, ptr, elem) == want
    assert tile_plan.plan(8, pitch, 8, a_pitch=8, b_pitch=pitch, b_ptr=ptr,
                          elem=elem).b_bytes == want
    with pytest.raises(ValueError):
        tile_plan.plan(8, 8, 8, 8, 8, elem=8)


# --------------------------------------------------------------------------
# int8 fake-quant
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [None, 0, 1, -1])
def test_fake_quant_matches_jax(dim):
    rng = np.random.default_rng(5)
    t = (rng.standard_normal((33, 17)) * rng.random((33, 1)) * 3).astype(np.float32)
    q = int8_train.fake_quant(torch.from_numpy(t), dim).numpy()
    jq = np.asarray(jint8._fq(jnp.asarray(t), dim))
    np.testing.assert_array_equal(q, jq)
    s = np.abs(t).max(axis=dim, keepdims=dim is not None) / np.float32(127.0) + np.float32(1e-12)
    assert len(np.unique(np.round(q / s))) <= 255


# the stochastic-rounding quantizer with injected uniform noise, against
# the numpy formula in f32 (bit for bit): floor(t/s + u), clipped, times s;
# the forward value is the quantized one, the gradient the identity
@pytest.mark.parametrize("dim", [None, -1])
def test_fake_quant_ste_with_injected_noise_matches_formula(dim):
    rng = np.random.default_rng(6)
    t = (2 * rng.standard_normal((24, 11))).astype(np.float32)
    u = rng.random((24, 11)).astype(np.float32)
    tt = torch.from_numpy(t).requires_grad_(True)
    out = int8_train.fake_quant_ste(tt, dim, torch.from_numpy(u))
    s = np.abs(t).max(axis=dim, keepdims=dim is not None) / np.float32(127.0) + np.float32(1e-12)
    q = np.clip(np.floor(t / s + u), -127, 127).astype(np.float32) * s
    np.testing.assert_array_equal(out.detach().numpy(), t + (q - t))
    out.sum().backward()
    np.testing.assert_array_equal(tt.grad.numpy(), np.ones_like(t))
    # without noise: round half to even, as jnp.round
    rq = int8_train.fake_quant_ste(torch.from_numpy(t), dim).numpy()
    np.testing.assert_array_equal(rq, t + (np.clip(np.round(t / s), -127, 127) * s - t))


# forward, dgrad and wgrad of int8full's matmul within f32 summation order
# (rtol 1e-5, atol 1e-6) of JAX's custom VJP
def test_qmatmul_forward_and_backward_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((40, 23)).astype(np.float32)
    w = (0.3 * rng.standard_normal((23, 15))).astype(np.float32)
    g = rng.standard_normal((40, 15)).astype(np.float32)
    jy, vjp = jax.vjp(jint8.qmatmul, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    y = int8_train.qmatmul(xt, wt)
    y.backward(torch.from_numpy(g))
    for t, j in ((y, jy), (xt.grad, jdx), (wt.grad, jdw)):
        np.testing.assert_allclose(_f32(t), np.asarray(j), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# the Trainer per compute dtype
# --------------------------------------------------------------------------

# tolerances after one epoch (~20 SGD steps) and a CV of its model:
# int8, int8pf, int8full are f32 arithmetic (fake-quant), so Xent within
# 1e-5 relative, params within rtol 1e-4, atol 1e-5, correct exact, as the
# f32 epochs; bf16: Xent within 1e-3 relative, params within 2e-3 absolute
# (where the two packages' f32 sums round a gradient to neighbouring bf16
# values, the step moves a weight by lr times one bf16 step of it; measured
# at most 8.2e-4 here), correct within 2 frames (an argmax tie in bf16)
DTYPE_TOL = {"bf16": dict(xent=1e-3, rtol=0.0, atol=2e-3, corr=2),
             "int8": dict(xent=1e-5, rtol=1e-4, atol=1e-5, corr=0),
             "int8pf": dict(xent=1e-5, rtol=1e-4, atol=1e-5, corr=0),
             "int8full": dict(xent=1e-5, rtol=1e-4, atol=1e-5, corr=0)}


def _check_epoch(tr, jtr, tol):
    assert tr.stats.frames == jtr.stats.frames > 0
    assert abs(tr.stats.corr - jtr.stats.corr) <= tol["corr"]
    np.testing.assert_allclose(tr.stats.error, jtr.stats.error, rtol=tol["xent"])


@pytest.mark.parametrize("momentum", [0.0, 0.5])
@pytest.mark.parametrize("dtype", sorted(DTYPE_TOL))
def test_trainer_compute_dtype_epoch_and_crossvalidate_match_jax(dtype, momentum):
    tol = DTYPE_TOL[dtype]
    text = _mlp_text()
    utts = _utts(5)
    common = dict(bunchsize=16, cachesize=64, seed=5, compute_dtype=dtype)
    sgd = dict(learning_rate=0.1, momentum=momentum)
    jtr = JTrainer(JNetwork.read(text), JTrainerConfig(
        **common, sgd=jsgd.SgdConfig(**sgd), use_pallas=True))
    jtr.run_epoch(iter(utts), batch_utts=5)
    ttr = Trainer(TNetwork.read(text), TrainerConfig(**common, sgd=tsgd.SgdConfig(**sgd)),
                  device="cpu")
    # the momentum hooks: every BiasedLinearity under bf16, none under int8
    assert ttr._fused == ([0, 2, 4] if momentum and dtype == "bf16" else [])
    ttr.run_epoch(iter(utts), batch_utts=5)
    _check_epoch(ttr, jtr, tol)
    tnet = ttr.updated_network()
    for a, b in zip(tnet.to_numpy_params(), jtr.updated_network().params):
        for k in a:
            assert a[k].dtype == np.float32       # the masters stay f32
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=tol["rtol"],
                                       atol=tol["atol"])

    cv_utts = _utts(6, n=6)
    cv = dict(bunchsize=16, cachesize=64, randomize=False, crossvalidate=True,
              compute_dtype=dtype)
    jcv = JTrainer(jtr.updated_network(), JTrainerConfig(**cv, use_pallas=True))
    jcv.run_epoch(iter(cv_utts))
    tcv = Trainer(tnet, TrainerConfig(**cv), device="cpu")
    tcv.run_epoch(iter(cv_utts))
    _check_epoch(tcv, jcv, tol)


# jnp's promotion: the SparseLinearity (f32 parameters) turns the bf16
# input into f32, so both later BiasedLinearities compute in f32 with their
# parameters rounded through bf16, and with momentum none takes the fused
# hook (their gradients are rounded to bf16 by the casts). Tolerances of
# the bf16 epochs above
@pytest.mark.parametrize("momentum", [0.0, 0.5])
def test_trainer_bf16_after_an_f32_layer_matches_jax(momentum):
    tol = DTYPE_TOL["bf16"]
    text = _mlp_text().replace("<biasedlinearity>", "<sparselinearity>", 1)
    utts = _utts(5)
    common = dict(bunchsize=16, cachesize=64, seed=5, compute_dtype="bf16")
    sgd = dict(learning_rate=0.1, momentum=momentum)
    jtr = JTrainer(JNetwork.read(text), JTrainerConfig(
        **common, sgd=jsgd.SgdConfig(**sgd), use_pallas=True))
    jtr.run_epoch(iter(utts), batch_utts=5)
    ttr = Trainer(TNetwork.read(text), TrainerConfig(**common, sgd=tsgd.SgdConfig(**sgd)),
                  device="cpu")
    assert ttr._bf16_in == [True, False, False, False, False] and ttr._fused == []
    ttr.run_epoch(iter(utts), batch_utts=5)
    _check_epoch(ttr, jtr, tol)
    for a, b in zip(ttr.updated_network().to_numpy_params(), jtr.params):
        for k in a:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=0, atol=tol["atol"])


def _sr_net():
    from nnet_asr_torch.models import components as TC

    rng = np.random.default_rng(5)
    layers = [TC.BiasedLinearity(10, 16), TC.Sigmoid(16, 16), TC.BiasedLinearity(16, 6),
              TC.Softmax(6, 6)]
    params = [{"weight": (0.3 * rng.standard_normal((10, 16))).astype(np.float32),
               "bias": np.zeros(16, np.float32)}, {},
              {"weight": (0.3 * rng.standard_normal((16, 6))).astype(np.float32),
               "bias": np.zeros(6, np.float32)}, {}]
    return TNetwork(layers).from_numpy_params(params)


def _sr_data():
    rng = np.random.default_rng(15)
    return (rng.standard_normal((64, 10)).astype(np.float32),
            rng.integers(0, 6, 64).astype(np.int32))


# int8pfsr against tests/test_pallas.py's properties: training (a) differs
# from int8pf, (b) repeats for a seed, (c) draws new noise every step, across
# caches, from one stream, and (d) evaluation rounds to nearest: the same CV
# twice, equal to int8pf's
def test_int8pfsr_stochastic_rounding_properties():
    X, y = _sr_data()

    def run(dtype, seed=9):
        cfg = TrainerConfig(bunchsize=32, cachesize=64, randomize=False, seed=seed,
                            sgd=tsgd.SgdConfig(learning_rate=0.05), compute_dtype=dtype)
        tr = Trainer(_sr_net(), cfg, device="cpu")
        tr.run_epoch(iter([(X, y), (X, y)]))          # two caches of two bunches
        return tr

    w_pf = run("int8pf").net.layers[0].weight.detach().numpy()
    tr_sr = run("int8pfsr")
    w_sr = tr_sr.net.layers[0].weight.detach().numpy()
    w_sr2 = run("int8pfsr").net.layers[0].weight.detach().numpy()
    w_other = run("int8pfsr", seed=10).net.layers[0].weight.detach().numpy()
    assert not np.array_equal(w_sr, w_pf)
    np.testing.assert_array_equal(w_sr, w_sr2)
    assert not np.array_equal(w_sr, w_other)
    assert np.abs(w_sr - w_pf).max() < 0.05           # unbiased: close to int8pf
    # 4 steps x 2 BiasedLinearities, each one draw of the layer input's shape
    fresh = torch.Generator().manual_seed(9)
    for _ in range(4):
        for width in (10, 16):
            torch.rand((32, width), generator=fresh)
    assert torch.equal(tr_sr._sr_gen.get_state(), fresh.get_state())

    evals = {}
    for dtype in ("int8pfsr", "int8pfsr", "int8pf"):
        cfg = TrainerConfig(bunchsize=32, cachesize=64, randomize=False, crossvalidate=True,
                            compute_dtype=dtype)
        net = _sr_net()
        net.layers[0].weight.data.copy_(torch.from_numpy(w_sr))
        tr = Trainer(net, cfg, device="cpu")
        tr.run_epoch(iter([(X, y)]))
        evals.setdefault(dtype, []).append((tr.stats.error, tr.stats.corr))
    assert evals["int8pfsr"][0] == evals["int8pfsr"][1] == evals["int8pf"][0]


def test_trainer_rejects_an_unknown_compute_dtype():
    with pytest.raises(ValueError, match="compute_dtype"):
        TrainerConfig(compute_dtype="fp8")
    with pytest.raises(ValueError, match="compute_dtype"):
        TransformPipeline(None, compute_dtype="int8pf")


# --------------------------------------------------------------------------
# the pipeline's inference modes
# --------------------------------------------------------------------------

# valid rows against JAX's transform_block. bf16 folded: the bf16 product
# (one rounding of an f32 sum, which may land on the neighbouring bf16
# value) plus the f32 bias, so within one bf16 step of the row's largest
# product; bf16 layered: the same for the BiasedLinearity, then the f32
# sigmoid; int8: int32 products are exact and the scales f32 arithmetic,
# within 1e-5 (a quantum may flip where x/s lands on a rounding tie)
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("kind", ["folded", "layered"])
def test_transform_block_compute_dtype_matches_jax(kind, dtype):
    ext = 2
    text = {"folded": _hamm_norm_text(), "layered": _nonlinear_text()}[kind]
    jp = JPipeline(JNetwork.read(text), ext, ext, chunk=16, compute_dtype=dtype)
    tp = TransformPipeline(TNetwork.read(text), ext, ext, chunk=16, device="cpu",
                           compute_dtype=dtype)
    assert (tp._folded is not None) == (kind == "folded")
    utts = _ext_utts(7, 9, 4, ext)
    jrows, jvalid = jp.transform_block(utts)
    rows, valid = tp.transform_block(utts)
    assert valid == jvalid and rows.shape[0] == valid and rows.dtype == torch.float32
    t, j = rows.numpy(), np.asarray(jrows, np.float32)[:valid]
    f32 = TransformPipeline(TNetwork.read(text), ext, ext, chunk=16,
                            device="cpu").transform_block(utts)[0].numpy()
    if dtype == "bf16":
        tol = bf16_step(np.abs(f32).max(axis=1, keepdims=True)) + 1e-6
        assert (np.abs(t - j) <= tol).all()
    else:
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)
    # the reduced precision shows: not the f32 rows
    assert not np.array_equal(t, f32)


@pytest.mark.parametrize("shape", [(5, 7, 3), (40, 598, 135), (17, 16, 8)])
def test_int_mm_is_exact(shape):
    M, K, N = shape
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    out = int_mm(a, b)
    assert out.dtype == torch.int32
    assert torch.equal(out, a.int() @ b.int())

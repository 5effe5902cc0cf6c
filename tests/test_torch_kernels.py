"""The port's kernel modules against the JAX Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX kernels run as tests/test_pallas.py runs them (Pallas
interpret mode) and against the XLA objective. The CUDA kernels are held
against the plain versions on the card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnet_asr_tpu.ops.objectives import xent_loss_and_stats as j_xent_loss_and_stats
from nnet_asr_tpu.ops.pallas.matmul_act import affine_sigmoid as j_affine_sigmoid
from nnet_asr_tpu.ops.pallas.softmax_ce import fused_softmax_xent as j_fused_softmax_xent
from nnet_asr_torch.ops.kernels import matmul_act as MA
from nnet_asr_torch.ops.kernels import softmax_ce as SC
from nnet_asr_torch.ops.objectives import xent_loss_and_stats

torch.set_num_threads(2)


def _affine_inputs(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, K)) / np.sqrt(K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    g = rng.standard_normal((M, N)).astype(np.float32)
    return x, w, b, g


# (M, K, N): one K block, and K > 1024 (several K blocks in the Pallas kernel)
@pytest.mark.parametrize("shape", [(40, 70, 50), (24, 1100, 60)])
def test_affine_sigmoid_plain_matches_pallas(shape):
    x, w, b, g = _affine_inputs(1, *shape)
    jy, vjp = jax.vjp(j_affine_sigmoid, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jgrads = vjp(jnp.asarray(g))

    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    before = MA.matmul_act.launches
    y = MA.affine_sigmoid(*ts)
    y.backward(torch.from_numpy(g))
    assert MA.matmul_act.launches == before          # CPU tensors: no launch
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    for t, jg in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)


def test_matmul_act_none_is_affine():
    x, w, b, _ = _affine_inputs(2, 9, 13, 7)
    y = MA.matmul_act(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), "none")
    np.testing.assert_allclose(y.numpy(), x @ w + b, rtol=1e-5, atol=1e-6)


def _ce_inputs(seed, B, C):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((B, C))).astype(np.float32)
    labels = rng.integers(0, C, B).astype(np.int32)
    labels[1] = -1                                    # a padding row
    top = logits[2].max() + 1.0                       # a tied max, label on the 2nd
    logits[2, 3] = logits[2, C - 2] = top
    labels[2] = C - 2
    logits[4, 0] = logits[4, 5] = logits[4].max() + 2.0   # tie, label on the 1st
    labels[4] = 0
    return logits, labels


# C not a multiple of 128, and a multiple
@pytest.mark.parametrize("B,C", [(37, 135), (20, 256)])
def test_fused_softmax_xent_plain_matches_pallas(B, C):
    logits, labels = _ce_inputs(3, B, C)
    jloss, jstats = j_fused_softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    jerr = jax.grad(lambda l: j_fused_softmax_xent(l, jnp.asarray(labels))[0])(
        jnp.asarray(logits))

    lt = torch.from_numpy(logits).requires_grad_(True)
    before = SC.softmax_xent.launches
    loss, correct = SC.fused_softmax_xent(lt, torch.from_numpy(labels))
    loss.backward()
    assert SC.softmax_xent.launches == before
    assert correct.dtype == torch.int32 and not correct.requires_grad
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(loss.item(), float(jstats["xent"]), rtol=1e-6)
    assert int(correct) == int(jstats["correct"])
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jerr), rtol=1e-6, atol=1e-6)
    err, xent, corr = SC.softmax_xent_plain(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_array_equal(err.numpy(), lt.grad.numpy())
    # the tied rows: first-max wins
    assert int(np.argmax(logits[2])) == 3 and int(np.argmax(logits[4])) == 0


@pytest.mark.parametrize("B,C", [(37, 135), (20, 256)])
def test_fused_softmax_xent_plain_matches_xla_objective(B, C):
    logits, labels = _ce_inputs(4, B, C)
    labels[6] = C + 3                                  # out of range: no hit
    (jloss, jstats), jgrad = jax.value_and_grad(
        lambda l: j_xent_loss_and_stats(l, jnp.asarray(labels)), has_aux=True)(
            jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss, correct = SC.fused_softmax_xent(lt, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jstats["xent"]), rtol=1e-6)
    assert int(correct) == int(jstats["correct"])
    # rows with a label outside [0, C) get err = softmax, as in the Pallas
    # kernel; the XLA objective's one-hot loss gives them no gradient
    ok = (labels >= 0) & (labels < C)
    np.testing.assert_allclose(lt.grad.numpy()[ok], np.asarray(jgrad)[ok],
                               rtol=1e-6, atol=1e-6)
    soft = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    np.testing.assert_allclose(lt.grad.numpy()[~ok], soft[~ok], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,C", [(37, 135), (20, 256)])
def test_xent_loss_and_stats_matches_jax(B, C):
    logits, labels = _ce_inputs(5, B, C)
    labels[6] = C + 3
    (jloss, jstats), jgrad = jax.value_and_grad(
        lambda l: j_xent_loss_and_stats(l, jnp.asarray(labels)), has_aux=True)(
            jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss, stats = xent_loss_and_stats(lt, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(stats["xent"]), float(jstats["xent"]), rtol=1e-6)
    assert int(stats["correct"]) == int(jstats["correct"])
    assert int(stats["frames"]) == B
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-6)


# rows with a NaN (without a label: no stats; with one: NaN xent and no
# hit, since jnp.max propagates NaN and no column reaches a NaN max), tied
# rows, and labels of -1 and past the Pallas kernel's column padding (135 ->
# 256): the plain version counts as the JAX kernel does
@pytest.mark.parametrize("labelled_nan", [False, True])
def test_fused_softmax_xent_plain_nan_rows_match_pallas(labelled_nan):
    B, C = 12, 135
    logits, labels = _ce_inputs(6, B, C)
    logits[1, 7] = np.nan                              # label -1
    labels[6] = 256 + 3                                # picks nothing in either
    logits[5, 1] = logits[5].max() + 1.0               # the label is the first max ...
    labels[5] = 1
    if labelled_nan:
        logits[5, 9] = np.nan                          # ... of a row with a NaN
    _, jstats = j_fused_softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    _, xent, corr = SC.softmax_xent_plain(torch.from_numpy(logits), torch.from_numpy(labels))
    assert int(corr) == int(jstats["correct"])
    assert bool(torch.isnan(xent)) == bool(np.isnan(float(jstats["xent"]))) == labelled_nan
    if not labelled_nan:
        np.testing.assert_allclose(float(xent), float(jstats["xent"]), rtol=1e-6)
    labels[5] = -1                                     # row 5 was counted only without NaN
    _, _, corr_off = SC.softmax_xent_plain(torch.from_numpy(logits), torch.from_numpy(labels))
    assert int(corr) - int(corr_off) == (0 if labelled_nan else 1)


def test_nan_row_counts_no_hit():
    logits = np.array([[1, 5, np.nan, 2], [0, 1, 2, 3]], np.float32)
    labels = np.array([1, 3], np.int32)
    _, jstats = j_fused_softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    _, xent, corr = SC.softmax_xent_plain(torch.from_numpy(logits), torch.from_numpy(labels))
    assert int(corr) == int(jstats["correct"]) == 1
    assert bool(torch.isnan(xent)) and np.isnan(float(jstats["xent"]))


def test_clamp_at_minus_1e10():
    logits = np.zeros((2, 4), np.float32)
    logits[0, 0] = 1e11                      # label 1 has logp = -1e11: clamped
    labels = np.array([1, 2], np.int32)
    _, xent, _ = SC.softmax_xent_plain(torch.from_numpy(logits), torch.from_numpy(labels))
    want = 1e10 + np.log(4.0)
    np.testing.assert_allclose(float(xent), want, rtol=1e-6)


def test_wrappers_reject_other_devices():
    x = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        MA.matmul_act(x, torch.empty((3, 2), device="meta"), torch.empty(2, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        SC.softmax_xent(x, torch.empty(4, dtype=torch.int32, device="meta"))

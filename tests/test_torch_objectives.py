"""The port's objectives and host statistics against the JAX package's (CPU).

Same numpy inputs through ``nnet_asr_tpu.ops.objectives`` and
``nnet_asr_torch.ops.objectives``. Losses, stats and gradients are f32
sums of a few hundred terms: within rtol 1e-5 (atol 1e-6 for gradients);
``correct`` and the report text of the host statistics must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnet_asr_tpu.ops import objectives as J
from nnet_asr_torch.ops import objectives as T

torch.set_num_threads(2)


def _logits(seed, B=40, C=9):
    """Random logits, labels in [0, C), and a row with a tie for the max."""
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal((B, C))).astype(np.float32)
    labels = rng.integers(0, C, B).astype(np.int32)
    logits[3, 1] = logits[3, 7] = logits[3].max() + 1.0
    labels[3] = 7                                 # first max (col 1): a miss
    return logits, labels


def test_softmax_identity_backward_is_softmax_with_identity_gradient():
    logits, _ = _logits(1)
    g = np.random.default_rng(2).standard_normal(logits.shape).astype(np.float32)
    x = torch.from_numpy(logits).requires_grad_(True)
    y = T.softmax_identity_backward(x)
    y.backward(torch.from_numpy(g))
    jy, vjp = jax.vjp(J.softmax_identity_backward, jnp.asarray(logits))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(y.detach().numpy(), torch.softmax(x, -1).detach().numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(x.grad.numpy(), g)
    np.testing.assert_array_equal(np.asarray(vjp(jnp.asarray(g))[0]), g)


def test_block_log_softmax_matches_jax():
    logits, _ = _logits(3, C=12)
    dims = (5, 3, 4)
    got = T.block_log_softmax(torch.from_numpy(logits), dims).numpy()
    want = np.asarray(J.block_log_softmax(jnp.asarray(logits), dims))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.exp(got[:, :5]).sum(1), 1.0, rtol=1e-5)


# loss, xent, correct and d loss / d logits against JAX, with and without
# spans; with spans the prediction is the argmax of the per-span
# log-softmax, and a label's gradient stays inside its span
@pytest.mark.parametrize("dims", [None, (4, 5), (2, 3, 4)])
def test_xent_loss_and_stats_blocks_match_jax(dims):
    logits, labels = _logits(4 + (0 if dims is None else len(dims)))
    (jloss, jst), jg = jax.value_and_grad(
        lambda l: J.xent_loss_and_stats(l, jnp.asarray(labels), dims), has_aux=True)(
            jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss, st = T.xent_loss_and_stats(lt, torch.from_numpy(labels), dims)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(st["xent"].item(), float(jst["xent"]), rtol=1e-5)
    assert st["correct"].item() == int(jst["correct"])
    assert st["frames"].item() == int(jst["frames"]) == logits.shape[0]
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    if dims is not None:
        lo = sum(dims[:1])
        in_first = labels < lo
        np.testing.assert_array_equal(lt.grad.numpy()[in_first, lo:], 0.0)


def test_mse_loss_and_gradient_match_jax():
    logits, labels = _logits(8)
    rng = np.random.default_rng(9)
    targets = np.eye(logits.shape[1], dtype=np.float32)[labels]
    y = 0.5 * rng.random(logits.shape).astype(np.float32)
    (jloss, jst), jg = jax.value_and_grad(
        lambda v: J.mse_loss_and_stats(v, jnp.asarray(targets)), has_aux=True)(jnp.asarray(y))
    yt = torch.from_numpy(y).requires_grad_(True)
    loss, st = T.mse_loss_and_stats(yt, T.one_hot(torch.from_numpy(labels), y.shape[1]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(st["mse"].item(), float(jst["mse"]), rtol=1e-5)
    assert st["frames"].item() == int(jst["frames"])
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(yt.grad.numpy(), y - targets)
    # one-hot of a label outside [0, C) is a zero row, as jax.nn.one_hot's
    oh = T.one_hot(torch.tensor([-1, 0, 9, 2]), 9).numpy()
    np.testing.assert_array_equal(oh, np.asarray(jax.nn.one_hot(jnp.asarray([-1, 0, 9, 2]), 9)))


def _stats_pair(mode, label_map):
    """Both packages' XentStats after the same adds and host confusion."""
    rng = np.random.default_rng(10)
    C = 6
    out = []
    for cls in (J.XentStats, T.XentStats):
        st = cls(confusion_mode=mode, label_map_file=label_map)
        out.append(st)
    for _ in range(3):
        logits = rng.standard_normal((25, C)).astype(np.float32)
        post = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        labels = rng.integers(0, C - 1, 25).astype(np.int32)      # class C-1 unseen
        xent = float(rng.random() * 50)
        corr = int((post.argmax(1) == labels).sum())
        for st in out:
            st.add(xent, 25, corr)
            st.add_confusion(post, labels)
    return out


@pytest.mark.parametrize("mode", ["no", "max", "soft", "dmax", "dsoft"])
@pytest.mark.parametrize("with_map", [True, False])
def test_xent_stats_report_equal_to_jax(tmp_path, mode, with_map):
    label_map = None
    if with_map:
        label_map = tmp_path / "map"
        label_map.write_text("sil\naa\nb\nch\nd\n")              # one tag short
        label_map = str(label_map)
    jst, tst = _stats_pair(mode, label_map)
    assert tst.report() == jst.report()
    assert tst.accuracy == jst.accuracy
    if mode != "no":
        lines = tst.report().splitlines()
        assert len(lines) == 1 + 6 + (2 + 6 if mode in ("max", "soft") else 0)
        assert ("sil" in lines[-6]) == with_map and lines[-1].split()[0] == "5"
    other_j, other_t = J.XentStats(error=1.5, frames=3, corr=2), T.XentStats(
        error=1.5, frames=3, corr=2)
    jst.merge(other_j)
    tst.merge(other_t)
    assert tst.report() == jst.report()


def test_mse_stats_match_jax():
    jst, tst = J.MseStats(), T.MseStats()
    for st in (jst, tst):
        st.add(12.25, 40)
        st.add(3.0000001, 17)
        st.merge(type(st)(error=0.5, frames=3))
    assert tst.report() == jst.report()
    assert tst.report().startswith("Mse:15.75") and " frames:60 " in tst.report()

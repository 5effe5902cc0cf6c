"""The kernel wrappers refuse on the CPU what their CUDA path refuses.

``matmul_act`` and ``softmax_xent`` check their operands before they
dispatch on the device, so a CPU call that the card would refuse raises
the card path's exception instead of computing a plain result. An unknown
activation raises ``ValueError`` in the JAX kernel too, run as
tests/test_pallas.py runs it (Pallas interpret mode on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnet_asr_tpu.ops.pallas.matmul_act import matmul_act as j_matmul_act
from nnet_asr_torch.ops.kernels import matmul_act as MA
from nnet_asr_torch.ops.kernels import softmax_ce as SC


def _affine(M=6, K=10, N=12):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    return x, w, b


def _logits(B=8, C=5):
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.standard_normal((B, C)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, C, B).astype(np.int32))
    return logits, labels


def _relu():
    x, w, b = _affine()
    return MA.matmul_act(x, w, b, act="relu")


def _f64_bias():
    x, w, b = _affine()
    return MA.matmul_act(x, w, b.double())


def _mismatched():
    x, w, b = _affine()
    return MA.matmul_act(x, w[:-1], b)


def _transposed_w():
    x, w, b = _affine(K=12)
    return MA.matmul_act(x, w.T, b)   # the same shape, not contiguous


def _f64_logits():
    logits, labels = _logits()
    return SC.softmax_xent(logits.double(), labels)


def _int64_labels():
    logits, labels = _logits()
    return SC.softmax_xent(logits, labels.long())


def _short_labels():
    logits, labels = _logits()
    return SC.softmax_xent(logits, labels[:-1])


# (refused call, the exception the CUDA path's check raises)
REFUSALS = {"matmul_act relu": (_relu, ValueError),
            "matmul_act f64 bias": (_f64_bias, TypeError),
            "matmul_act mismatched shapes": (_mismatched, ValueError),
            "matmul_act transposed w": (_transposed_w, ValueError),
            "softmax_xent f64 logits": (_f64_logits, TypeError),
            "softmax_xent int64 labels": (_int64_labels, TypeError),
            "softmax_xent labels of the wrong length": (_short_labels, ValueError)}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_cpu_refuses_what_the_card_refuses(case):
    call, exc = REFUSALS[case]
    with pytest.raises(exc):
        call()


def test_unknown_act_raises_in_jax_too():
    x, w, b = (jnp.asarray(t.numpy()) for t in _affine())
    with pytest.raises(ValueError):
        j_matmul_act(x, w, b, act="relu")


def test_accepted_inputs_still_compute():
    x, w, b = _affine()
    torch.testing.assert_close(MA.matmul_act(x, w, b), torch.sigmoid(x @ w + b))
    logits, labels = _logits()
    err, _xent, correct = SC.softmax_xent(logits, labels)
    assert err.shape == logits.shape and correct.dtype == torch.int32

"""The fused wgrad + momentum update and the Trainer's momentum path, on the CPU.

The port's ``wgrad_momentum_update_plain`` against the JAX Pallas kernel
(interpret mode, as tests/test_pallas.py runs it), the wrapper's checks
and CPU dispatch, and whole momentum epochs of the port's Trainer (whose
BiasedLinearity weights go through the fused update inside the backward
pass) against JAX ``Trainer(use_pallas=True)``. Inputs come from numpy
with a seed; tolerances are stated per test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnet_asr_tpu.models.network import Network as JNetwork
from nnet_asr_tpu.ops.pallas.sgd_fused import wgrad_momentum_update as j_wgrad
from nnet_asr_tpu.train import sgd as jsgd
from nnet_asr_tpu.train.trainer import Trainer as JTrainer
from nnet_asr_tpu.train.trainer import TrainerConfig as JTrainerConfig
from nnet_asr_torch.models.network import Network as TNetwork
from nnet_asr_torch.ops.kernels import _build
from nnet_asr_torch.ops.kernels import sgd_fused as SF
from nnet_asr_torch.train import sgd as tsgd
from nnet_asr_torch.train.trainer import Trainer, TrainerConfig

from test_torch_train import _mlp_text, _utts

torch.set_num_threads(2)


def _update_inputs(seed, B, In, Out):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((B, In))).astype(np.float32)
    e = (0.1 * rng.standard_normal((B, Out))).astype(np.float32)
    p = (0.2 * rng.standard_normal((In, Out))).astype(np.float32)
    v = (0.05 * rng.standard_normal((In, Out))).astype(np.float32)
    return x, e, p, v


# (B, In, Out, JAX block sizes): test_pallas.py's shape and blocks, and a
# ragged example-01-like shape (no dim a tile multiple) at the default blocks
SHAPES = {"pallas_test": (96, 130, 70, dict(bm=64, bn=128, bk=32)),
          "ragged": (60, 37, 9, {})}


# tolerances of tests/test_pallas.py: v rtol 1e-5 (f32) or 2e-2 (bf16,
# one rounding of a sum taken in another order), atol 1e-4; p rtol 1e-4,
# atol 1e-5
@pytest.mark.parametrize("vdt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_wgrad_momentum_plain_matches_jax_pallas(shape, vdt):
    B, In, Out, blocks = SHAPES[shape]
    x, e, p, v = _update_inputs(9, B, In, Out)
    m, a = 0.9, 0.003
    bf16 = vdt == "bf16"
    jp, jv = j_wgrad(jnp.asarray(x), jnp.asarray(e), jnp.asarray(p),
                     jnp.asarray(v, jnp.bfloat16 if bf16 else jnp.float32), a, m, **blocks)
    tp = torch.from_numpy(p.copy())
    tv = torch.from_numpy(v).to(torch.bfloat16 if bf16 else torch.float32)
    SF.wgrad_momentum_update_plain(torch.from_numpy(x), torch.from_numpy(e), tp, tv, a, m)
    assert tv.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_allclose(tv.float().numpy(), np.asarray(jv, np.float32),
                               rtol=2e-2 if bf16 else 1e-5, atol=1e-4)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-5)


def test_wgrad_momentum_update_cpu_takes_plain_in_place():
    x, e, p, v = (torch.from_numpy(t) for t in _update_inputs(3, 33, 20, 11))
    pp, vv = p.clone(), v.clone()
    before = _build.LAUNCHES.copy()
    SF.wgrad_momentum_update(x, e, p, v, 0.01, 0.5)
    SF.wgrad_momentum_update_plain(x, e, pp, vv, 0.01, 0.5)
    assert _build.LAUNCHES == before                        # no kernel on the CPU
    assert torch.equal(p, pp) and torch.equal(v, vv)
    assert not torch.equal(p, torch.from_numpy(_update_inputs(3, 33, 20, 11)[2]))


BAD = {
    "x_float64": (lambda x, e, p, v: (x.double(), e, p, v), TypeError),
    "p_bf16": (lambda x, e, p, v: (x, e, p.bfloat16(), v), TypeError),
    "v_float16": (lambda x, e, p, v: (x, e, p, v.half()), TypeError),
    "e_rows": (lambda x, e, p, v: (x, e[:-1].contiguous(), p, v), ValueError),
    "v_shape": (lambda x, e, p, v: (x, e, p, v[:, :-1].contiguous()), ValueError),
    "p_strided": (lambda x, e, p, v: (x, e, p.t().contiguous().t(), v), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wgrad_momentum_update_rejects_bad_input(case):
    make, err = BAD[case]
    args = make(*(torch.from_numpy(t) for t in _update_inputs(4, 8, 6, 5)))
    with pytest.raises(err):
        SF.wgrad_momentum_update(*args, 0.01, 0.5)


MOMENTUM_CASES = {
    "m0.5": dict(learning_rate=0.1, momentum=0.5),
    "m0.9": dict(learning_rate=0.05, momentum=0.9),
    "bf16_velocity": dict(learning_rate=0.1, momentum=0.9, velocity_dtype="bf16"),
    "l2_div_frm": dict(learning_rate=0.1, momentum=0.5, weightcost=1e-3),
    "l2_sum": dict(learning_rate=0.004, momentum=0.5, weightcost=1e-3,
                   grad_div_frm=False),
    "frozen_layer": dict(learning_rate=0.1, momentum=0.5, lr_factors=(0.0, 0.5, 1.0)),
}


# params within rtol 1e-4, atol 1e-5 and Xent within 1e-5 relative after
# ~20 momentum steps (f32 summation order; bf16 velocity rounds the same
# f32 values); frames and correct counts exact
@pytest.mark.parametrize("case", sorted(MOMENTUM_CASES))
def test_momentum_trainer_epoch_and_crossvalidate_match_jax(case):
    text = _mlp_text()
    utts = _utts(5)
    sgd = MOMENTUM_CASES[case]
    common = dict(bunchsize=16, cachesize=64, seed=5)
    jtr = JTrainer(JNetwork.read(text), JTrainerConfig(
        **common, sgd=jsgd.SgdConfig(**sgd), use_pallas=True))
    jtr.run_epoch(iter(utts), batch_utts=5)
    ttr = Trainer(TNetwork.read(text), TrainerConfig(**common, sgd=tsgd.SgdConfig(**sgd)),
                  device="cpu")
    # every updatable BiasedLinearity's weight takes the fused update,
    # and no gradient is asked for it
    frozen = sgd.get("lr_factors", (1.0,))[0] == 0.0
    assert ttr._fused == ([2, 4] if frozen else [0, 2, 4])
    assert not any(k == "weight" and i in ttr._fused for i, k in ttr._trainable)
    ttr.run_epoch(iter(utts), batch_utts=5)
    assert ttr.stats.frames == jtr.stats.frames > 0
    assert ttr.stats.corr == jtr.stats.corr
    np.testing.assert_allclose(ttr.stats.error, jtr.stats.error, rtol=1e-5)
    jparams = jtr.updated_network().params
    tnet = ttr.updated_network()
    for a, b in zip(tnet.to_numpy_params(), jparams):
        for k in a:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=1e-4, atol=1e-5)
    bf16 = sgd.get("velocity_dtype") == "bf16"
    for a, b in zip(ttr.velocity, jtr.velocity):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == (torch.bfloat16 if bf16 else torch.float32)
            np.testing.assert_allclose(a[k].float().numpy(), np.asarray(b[k], np.float32),
                                       rtol=1e-2 if bf16 else 1e-4, atol=1e-5)
    if frozen:
        np.testing.assert_array_equal(tnet.to_numpy_params()[0]["weight"],
                                      JNetwork.read(text).params[0]["weight"])

    cv_utts = _utts(6, n=6)
    cv = dict(bunchsize=16, cachesize=64, randomize=False, crossvalidate=True)
    jcv = JTrainer(jtr.updated_network(), JTrainerConfig(**cv, use_pallas=True))
    jcv.run_epoch(iter(cv_utts))
    tcv = Trainer(tnet, TrainerConfig(**cv), device="cpu")
    tcv.run_epoch(iter(cv_utts))
    assert tcv.stats.frames == jcv.stats.frames > 0
    assert tcv.stats.corr == jcv.stats.corr
    np.testing.assert_allclose(tcv.stats.error, jcv.stats.error, rtol=1e-5)

"""The port's training path against the JAX package's, on the CPU.

Transform folding and the chunked pipeline, the frame cache, one SGD step
per branch, and whole epochs of the Trainer against JAX
``Trainer(use_pallas=True)`` (Pallas kernels in interpret mode), with the
same numpy inputs. Tolerances are f32 summation-order ones, stated per test.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnet_asr_tpu.models.network import Network as JNetwork
from nnet_asr_tpu.ops.fold_affine import fold_transform as j_fold_transform
from nnet_asr_tpu.tools import gen_mlp_init, generators
from nnet_asr_tpu.train import sgd as jsgd
from nnet_asr_tpu.train.cache import DeviceFrameCache as JCache
from nnet_asr_tpu.train.pipeline import TransformPipeline as JPipeline
from nnet_asr_tpu.train.trainer import Trainer as JTrainer
from nnet_asr_tpu.train.trainer import TrainerConfig as JTrainerConfig
from nnet_asr_torch.models.network import Network as TNetwork
from nnet_asr_torch.ops.fold_affine import fold_transform
from nnet_asr_torch.train import sgd as tsgd
from nnet_asr_torch.train.cache import DeviceFrameCache
from nnet_asr_torch.train.pipeline import TransformPipeline
from nnet_asr_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)


def _stdout_of(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def _hamm_norm_text(din=4, ext=2, k=3, seed=0):
    text = _stdout_of(generators.main, [
        "hamm_dct", f"--dimIn={din}", f"--startFrmExt={ext}", f"--endFrmExt={ext}",
        f"--dctBaseCnt={k}"])
    rng = np.random.default_rng(seed)
    d = din * k
    return (text + f"<bias> {d} {d}\nv {d}\n"
            + " ".join(repr(float(v)) for v in rng.standard_normal(d))
            + f"\n<window> {d} {d}\nv {d}\n"
            + " ".join(repr(float(v)) for v in rng.random(d) + 0.5) + "\n")


def _nonlinear_text(din=4, ext=2, seed=1):
    """Splice → affine → sigmoid: cannot fold, runs layer by layer."""
    rng = np.random.default_rng(seed)
    ctx = 2 * ext + 1
    w = rng.standard_normal((6, din * ctx))
    return (_stdout_of(generators.main, ["splice", f"--dimIn={din}",
                                         f"--startFrmExt={ext}", f"--endFrmExt={ext}"])
            + f"<biasedlinearity> 6 {din * ctx}\nm 6 {din * ctx}\n"
            + "\n".join(" ".join(repr(float(v)) for v in row) for row in w)
            + "\nv 6\n" + " ".join(["0.1"] * 6) + f"\n<sigmoid> 6 6\n")


def test_fold_transform_matches_jax():
    text = _hamm_norm_text()
    jsa, jM, jc = j_fold_transform(JNetwork.read(text))
    sa, M, c = fold_transform(TNetwork.read(text), "cpu")
    assert sa.offsets == jsa.offsets and sa.in_dim == jsa.in_dim
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
    assert fold_transform(TNetwork.read(_nonlinear_text()), "cpu") is None


def _ext_utts(seed, n, din, ext):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(3, 30)) + 2 * ext, din)).astype(np.float32)
            for _ in range(n)]


# valid rows within atol 1e-5: f32 GEMMs of different blocking
@pytest.mark.parametrize("kind", ["folded", "layered", "none"])
def test_transform_block_valid_rows_match_jax(kind):
    ext = 2
    text = {"folded": _hamm_norm_text(), "layered": _nonlinear_text(), "none": None}[kind]
    jp = JPipeline(JNetwork.read(text) if text else None, ext, ext, chunk=16)
    tp = TransformPipeline(TNetwork.read(text) if text else None, ext, ext, chunk=16,
                           device="cpu")
    utts = _ext_utts(7, 9, 4, ext)          # ~150 rows: many 16-row chunks
    jrows, jvalid = jp.transform_block(utts)
    rows, valid = tp.transform_block(utts)
    assert valid == jvalid == sum(u.shape[0] - 2 * ext for u in utts)
    assert rows.shape[0] == valid
    np.testing.assert_allclose(rows.numpy(), np.asarray(jrows)[:valid], rtol=1e-5, atol=1e-5)
    trows, lens = tp.transform_rows(utts)
    np.testing.assert_array_equal(trows.numpy(), rows.numpy())
    assert lens == [u.shape[0] - 2 * ext for u in utts]


def _drain_all(cache, blocks, add):
    out = []
    for blk, lab in blocks:
        add(blk, lab)
        while cache.full:
            out.append(cache.take_stacked())
    if cache.rows > 0:
        out.append(cache.take_stacked())
    return out


@pytest.mark.parametrize("randomize", [True, False])
def test_device_frame_cache_matches_jax(randomize):
    rng = np.random.default_rng(3)
    # 13+9+... rows through a 24-row cache of 8-row bunches: blocks cross the
    # cache boundary (overflow carried), one block overflows twice, and the
    # last drain leaves a sub-bunch tail (discarded)
    sizes = [13, 9, 30, 5, 11, 7]
    blocks = []
    start = 0
    for n in sizes:
        feats = (np.arange(start, start + n, dtype=np.float32)[:, None]
                 * np.ones((1, 3), np.float32) + rng.random((n, 3)).astype(np.float32))
        blocks.append((feats, (np.arange(start, start + n) % 17).astype(np.int32)))
        start += n
    jc = JCache(24, 8, seed=11, randomize=randomize)
    tc = DeviceFrameCache(24, 8, seed=11, randomize=randomize)
    jout = _drain_all(jc, blocks, lambda b, l: jc.add_block(jnp.asarray(b), b.shape[0], l))
    tout = _drain_all(tc, blocks, lambda b, l: tc.add_block(torch.from_numpy(b), b.shape[0], l))
    assert len(tout) == len(jout)
    for j, t in zip(jout, tout):
        assert (j is None) == (t is None)
        if j is None:
            continue
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
        assert t[1].dtype == torch.int32
    assert tc.discarded == jc.discarded > 0


def test_cache_rejects_indivisible_sizes():
    with pytest.raises(ValueError, match="Non divisible"):
        DeviceFrameCache(10, 4)


SGD_CASES = {
    "plain": dict(cfg=dict(learning_rate=0.05, grad_div_frm=False)),
    "momentum": dict(cfg=dict(learning_rate=0.05, momentum=0.5, grad_div_frm=False)),
    "grad_div_frm": dict(cfg=dict(learning_rate=0.05, grad_div_frm=True)),
    "l2": dict(cfg=dict(learning_rate=0.05, weightcost=1e-2, grad_div_frm=False)),
    "l2_div_frm": dict(cfg=dict(learning_rate=0.05, weightcost=1e-2, momentum=0.5)),
    "factor0": dict(cfg=dict(learning_rate=0.05, lr_factors=(0.0, 1.0))),
    "bf16_velocity": dict(cfg=dict(learning_rate=0.05, momentum=0.9,
                                   velocity_dtype="bf16")),
    "runtime_lr": dict(cfg=dict(learning_rate=0.05, momentum=0.5), lr=0.0125),
    # the first layer a SparseLinearity with a random 0/1 mask: the soft
    # threshold after the step (and the L2 decay), then the mask, on every
    # update of the layer with or without L1; L1 leaves other layers alone
    "l1_sparse": dict(cfg=dict(learning_rate=0.05, l1=0.05, grad_div_frm=False), sparse=True),
    "l1_sparse_momentum_l2": dict(cfg=dict(learning_rate=0.05, l1=0.01, momentum=0.5,
                                           weightcost=1e-2), sparse=True),
    "sparse_mask_only": dict(cfg=dict(learning_rate=0.05, grad_div_frm=False), sparse=True),
    "l1_without_sparse_layer": dict(cfg=dict(learning_rate=0.05, l1=0.05)),
}


# params and f32 velocity within rtol 1e-6, atol 1e-7 (same f32 ops);
# bf16 velocity within one bf16 rounding step
@pytest.mark.parametrize("case", sorted(SGD_CASES))
def test_apply_updates_matches_jax(case):
    spec = SGD_CASES[case]
    text = _stdout_of(gen_mlp_init.main, ["--dim=6:5:3", "--gauss", "--negbias", "--seed=2"])
    if spec.get("sparse"):
        text = text.replace("<biasedlinearity>", "<sparselinearity>", 1)
    jnet = JNetwork.read(text)
    tnet = TNetwork.read(text)
    rng = np.random.default_rng(sorted(SGD_CASES).index(case))
    if spec.get("sparse"):
        mask = (rng.random((6, 5)) > 0.3).astype(np.float32)
        jnet.params[0]["mask"] = mask
        tnet.layers[0].mask.copy_(torch.from_numpy(mask))
    grads = [{k: rng.standard_normal(np.shape(v)).astype(np.float32) for k, v in p.items()}
             for p in jnet.params]
    jcfg = jsgd.SgdConfig(**spec["cfg"])
    tcfg = tsgd.SgdConfig(**spec["cfg"])
    bf16 = tcfg.velocity_dtype == "bf16"
    vel = [{k: (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in p.items() if k in js.trainable_keys} if tcfg.momentum else {}
           for js, p in zip(jnet.specs, jnet.params)]
    jvel = [{k: jnp.asarray(v, jnp.bfloat16 if bf16 else jnp.float32) for k, v in d.items()}
            for d in vel]
    tvel = tsgd.init_momentum(tnet, tcfg.momentum, tcfg.velocity_dtype)
    for d, src in zip(tvel, vel):
        for k in d:
            d[k].copy_(torch.from_numpy(src[k]))
    n_frames = 17
    jfac = jsgd.layer_lr_factors(jnet, jcfg)
    tfac = tsgd.layer_lr_factors(tnet, tcfg)
    assert jfac == tfac
    lr = spec.get("lr")
    jp, jv = jsgd.apply_updates(
        jnet, [{k: jnp.asarray(v) for k, v in p.items()} for p in jnet.params], jvel,
        [{k: jnp.asarray(v) for k, v in g.items()} for g in grads], jcfg,
        n_frames, jfac, learning_rate=None if lr is None else jnp.float32(lr))
    tparams = tnet.params
    tsgd.apply_updates(tnet, tparams, tvel,
                       [{k: torch.from_numpy(v) for k, v in g.items()} for g in grads],
                       tcfg, n_frames, tfac, learning_rate=lr)
    for a, b in zip(tnet.to_numpy_params(), jp):
        for k in a:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=1e-6, atol=1e-7)
    for a, b in zip(tvel, jv):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == (torch.bfloat16 if bf16 else torch.float32)
            np.testing.assert_allclose(a[k].float().numpy(), np.asarray(b[k], np.float32),
                                       rtol=8e-3 if bf16 else 1e-6, atol=1e-7)
    if case == "factor0":   # the frozen layer did not move
        np.testing.assert_array_equal(tnet.to_numpy_params()[0]["weight"],
                                      jnet.params[0]["weight"])
    if spec.get("sparse"):  # pruned weights stay at 0; L1 zeroes some more
        w = tnet.to_numpy_params()[0]["weight"]
        np.testing.assert_array_equal(w[mask == 0], 0.0)
        assert ((w == 0) & (mask == 1)).any() == (tcfg.l1 > 0.02)


def _mlp_text(seed=4):
    return _stdout_of(gen_mlp_init.main, ["--dim=20:32:32:10", "--gauss", "--negbias",
                                          f"--seed={seed}"])


def _utts(seed, n=12, din=20, classes=10):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((classes, din)).astype(np.float32)
    out = []
    for _ in range(n):
        T = int(rng.integers(15, 40))
        lab = rng.integers(0, classes, T).astype(np.int32)
        x = means[lab] + 0.5 * rng.standard_normal((T, din)).astype(np.float32)
        out.append((x, lab))
    return out


# params within rtol 1e-4, atol 1e-5 and Xent within 1e-5 relative after
# ~20 f32 SGD steps; frames and correct exact
@pytest.mark.parametrize("momentum", [0.0, 0.5])
def test_trainer_epoch_and_crossvalidate_match_jax_pallas(momentum):
    text = _mlp_text()
    utts = _utts(5)
    common = dict(bunchsize=16, cachesize=64, seed=5)
    sgd = dict(learning_rate=0.1, momentum=momentum, grad_div_frm=True)
    jtr = JTrainer(JNetwork.read(text), JTrainerConfig(
        **common, sgd=jsgd.SgdConfig(**sgd), use_pallas=True))
    jtr.run_epoch(iter(utts), batch_utts=5)
    ttr = Trainer(TNetwork.read(text), TrainerConfig(**common, sgd=tsgd.SgdConfig(**sgd)),
                  device="cpu")
    ttr.run_epoch(iter(utts), batch_utts=5)
    assert ttr.stats.frames == jtr.stats.frames > 0
    assert ttr.stats.corr == jtr.stats.corr
    np.testing.assert_allclose(ttr.stats.error, jtr.stats.error, rtol=1e-5)
    assert ttr.total_frames == jtr.total_frames
    jparams = jtr.updated_network().params
    tnet = ttr.updated_network()
    for a, b in zip(tnet.to_numpy_params(), jparams):
        for k in a:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=1e-4, atol=1e-5)
    assert ttr.report().startswith("Xent:") and "FPS:" in ttr.throughput_report()

    # crossvalidate each trained net on fresh data
    cv_utts = _utts(6, n=6)
    cv = dict(bunchsize=16, cachesize=64, randomize=False, crossvalidate=True)
    jcv = JTrainer(jtr.updated_network(), JTrainerConfig(**cv, use_pallas=True))
    jcv.run_epoch(iter(cv_utts))
    tcv = Trainer(tnet, TrainerConfig(**cv), device="cpu")
    before = tcv.net.to_numpy_params()
    tcv.run_epoch(iter(cv_utts))
    assert tcv.stats.frames == jcv.stats.frames > 0
    assert tcv.stats.corr == jcv.stats.corr
    np.testing.assert_allclose(tcv.stats.error, jcv.stats.error, rtol=1e-5)
    for a, b in zip(tcv.net.to_numpy_params(), before):     # no update in CV
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _head_text(head, seed=4):
    """The 20:32:32:10 MLP with its softmax head kept, swapped for a
    BlockSoftmax over (6, 4), or dropped."""
    text = _mlp_text(seed)
    if head == "softmax":
        return text
    if head == "none":
        return text.rsplit("<softmax>", 1)[0]
    return text.replace("<softmax> 10 10", "<blocksoftmax> 10 10\nv 2\n6 4")


# (objective, head, confusion mode) of the routes trainer.py:200-216 takes
# beside the fused one
OBJECTIVE_CASES = {
    "mse": ("mse", "softmax", "no"),
    "mse_no_head": ("mse", "none", "no"),
    "mse_blocksoftmax": ("mse", "blocksoftmax", "no"),
    "blocksoftmax": ("xent", "blocksoftmax", "no"),
    "confusion_max": ("xent", "softmax", "max"),
    "confusion_soft": ("xent", "softmax", "soft"),
    "confusion_dmax": ("xent", "softmax", "dmax"),
    "confusion_dsoft": ("xent", "softmax", "dsoft"),
    "blocksoftmax_confusion_max": ("xent", "blocksoftmax", "max"),
}


def _check_stats(t, j, mode):
    """frames and correct exact, error within 1e-5 relative; the max/dmax
    confusion (counts) equal, the soft/dsoft one within rtol 1e-5."""
    assert t.frames == j.frames > 0
    np.testing.assert_allclose(t.error, j.error, rtol=1e-5)
    assert getattr(t, "corr", None) == getattr(j, "corr", None)
    if mode == "no":
        assert getattr(t, "confusion", None) is None
        return
    assert t.confusion_mode == j.confusion_mode == mode and t.n_classes == j.n_classes
    np.testing.assert_array_equal(t.confusion_count, j.confusion_count)
    assert t.confusion_count.sum() == t.frames
    for a, b in ((t.confusion, j.confusion), (t.diag_confusion, j.diag_confusion)):
        if mode in ("max", "dmax"):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# epochs + CV of each route against JAX Trainer(use_pallas=True): params
# within atol 1e-5 after ~20 f32 SGD steps, stats as _check_stats
@pytest.mark.parametrize("momentum", [0.0, 0.5])
@pytest.mark.parametrize("case", list(OBJECTIVE_CASES))
def test_trainer_objectives_match_jax_pallas(case, momentum):
    objective, head, mode = OBJECTIVE_CASES[case]
    text = _head_text(head)
    utts = _utts(5)
    common = dict(bunchsize=16, cachesize=64, seed=5, objective=objective,
                  confusion_mode=mode)
    sgd = dict(learning_rate=0.1 if objective == "xent" else 0.5, momentum=momentum)
    jtr = JTrainer(JNetwork.read(text), JTrainerConfig(
        **common, sgd=jsgd.SgdConfig(**sgd), use_pallas=True))
    jtr.run_epoch(iter(utts), batch_utts=5)
    ttr = Trainer(TNetwork.read(text), TrainerConfig(**common, sgd=tsgd.SgdConfig(**sgd)),
                  device="cpu")
    ttr.run_epoch(iter(utts), batch_utts=5)
    _check_stats(ttr.stats, jtr.stats, mode)
    tnet = ttr.updated_network()
    for a, b in zip(tnet.to_numpy_params(), jtr.updated_network().params):
        for k in a:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=0, atol=1e-5)
    assert ttr.report().startswith("Mse:" if objective == "mse" else "Xent:")

    cv_utts = _utts(6, n=6)
    cv = dict(bunchsize=16, cachesize=64, randomize=False, crossvalidate=True,
              objective=objective, confusion_mode=mode)
    jcv = JTrainer(jtr.updated_network(), JTrainerConfig(**cv, use_pallas=True))
    jcv.run_epoch(iter(cv_utts))
    tcv = Trainer(tnet, TrainerConfig(**cv), device="cpu")
    tcv.run_epoch(iter(cv_utts))
    _check_stats(tcv.stats, jcv.stats, mode)


def _discrete_text():
    """DiscreteLinearity(20 → 12 + 20) → sigmoid → BiasedLinearity → softmax."""
    rng = np.random.default_rng(12)

    def mat(r, c):
        return f"m {r} {c}\n" + "\n".join(" ".join(repr(float(v)) for v in row)
                                          for row in 0.3 * rng.standard_normal((r, c))) + "\n"
    return (f"<discretelinearity> 32 20\n2\n{mat(12, 8)}{mat(20, 12)}v 32\n"
            + " ".join(["0.1"] * 32) + "\n<sigmoid> 32 32\n<biasedlinearity> 10 32\n"
            + mat(10, 32) + "v 10\n" + " ".join(["0"] * 10) + "\n<softmax> 10 10\n")


# the JAX package cannot update a DiscreteLinearity (its weights are a
# list): init_momentum fails with any momentum, apply_updates with a
# non-zero factor. The port raises a ValueError there, and trains the frozen
# layer (factor 0, momentum 0) as JAX does (params within atol 1e-5)
@pytest.mark.parametrize("factors,momentum", [(None, 0.0), ((1.0, 1.0), 0.0),
                                              ((0.0, 1.0), 0.5), ((0.0, 1.0), 0.0)])
def test_discretelinearity_updates_as_jax(factors, momentum):
    text = _discrete_text()
    common = dict(bunchsize=16, cachesize=64, seed=5)
    sgd = dict(learning_rate=0.1, momentum=momentum, lr_factors=factors)
    utts = _utts(7, n=4)
    frozen = factors is not None and factors[0] == 0.0 and momentum == 0.0
    with contextlib.ExitStack() as stack:
        if not frozen:
            stack.enter_context(pytest.raises(Exception))
        jtr = JTrainer(JNetwork.read(text), JTrainerConfig(
            **common, sgd=jsgd.SgdConfig(**sgd), use_pallas=True))
        jtr.run_epoch(iter(utts), batch_utts=5)
    if not frozen:
        with pytest.raises(ValueError, match="JAX package cannot update either"):
            Trainer(TNetwork.read(text), TrainerConfig(**common, sgd=tsgd.SgdConfig(**sgd)),
                    device="cpu")
        return
    ttr = Trainer(TNetwork.read(text), TrainerConfig(**common, sgd=tsgd.SgdConfig(**sgd)),
                  device="cpu")
    ttr.run_epoch(iter(utts), batch_utts=5)
    _check_stats(ttr.stats, jtr.stats, "no")
    jparams = jtr.params       # (JAX's updated_network cannot np.asarray the blocks)
    tparams = ttr.updated_network().to_numpy_params()
    for a, b in zip(tparams[0]["weights"], jparams[0]["weights"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tparams[1:], jparams[1:]):
        for k in a:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=0, atol=1e-5)


def test_trainer_runtime_learning_rate():
    """set_learning_rate(0) freezes the net; the epoch still counts."""
    text = _mlp_text(seed=8)
    tr = Trainer(TNetwork.read(text), TrainerConfig(bunchsize=16, cachesize=64, seed=3),
                 device="cpu")
    before = tr.net.to_numpy_params()
    tr.set_learning_rate(0.0)
    tr.run_epoch(iter(_utts(9, n=4)))
    assert tr.stats.frames > 0
    for a, b in zip(tr.net.to_numpy_params(), before):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_trainer_requires_softmax_and_cuda_by_default():
    text = _mlp_text()
    with pytest.raises(ValueError, match="softmax"):
        Trainer(TNetwork.read(text.rsplit("<softmax>", 1)[0]), TrainerConfig(),
                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(TNetwork.read(text), TrainerConfig())


# transform_to_host / __call__ rows within atol 1e-5 of JAX's (f32 GEMMs of
# different blocking); one per utterance, halo trimmed
@pytest.mark.parametrize("kind", ["folded", "layered", "none"])
def test_transform_to_host_and_call_match_jax(kind):
    ext = 2
    text = {"folded": _hamm_norm_text(), "layered": _nonlinear_text(), "none": None}[kind]
    jp = JPipeline(JNetwork.read(text) if text else None, ext, ext, chunk=16)
    tp = TransformPipeline(TNetwork.read(text) if text else None, ext, ext, chunk=16,
                           device="cpu")
    utts = _ext_utts(8, 7, 4, ext)
    jouts = jp.transform_to_host(utts)
    touts = tp.transform_to_host(utts)
    calls = tp(utts)
    assert len(touts) == len(calls) == len(jouts) == len(utts)
    for u, j, t, c in zip(utts, jouts, touts, calls):
        assert isinstance(t, np.ndarray) and isinstance(c, torch.Tensor)
        assert t.shape == np.asarray(j).shape == (u.shape[0] - 2 * ext, t.shape[1])
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(c.numpy(), t)


def _state_trainers(velocity_dtype):
    text = _mlp_text(seed=11)
    common = dict(bunchsize=16, cachesize=64, seed=7)
    sgd = dict(learning_rate=0.1, momentum=0.5, velocity_dtype=velocity_dtype)
    jtr = JTrainer(JNetwork.read(text), JTrainerConfig(
        **common, sgd=jsgd.SgdConfig(**sgd), use_pallas=True))
    ttr = Trainer(TNetwork.read(text), TrainerConfig(**common, sgd=tsgd.SgdConfig(**sgd)),
                  device="cpu")
    return jtr, ttr


def _trainer_state(tr):
    """(params, velocity as f32, (error, frames, corr)) of either package's Trainer."""
    def host(t):
        return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t, np.float32))
    return ([{k: host(v) for k, v in p.items()} for p in tr.params],
            [{k: host(v) for k, v in d.items()} for d in tr.velocity],
            (tr.stats.error, tr.stats.frames, getattr(tr.stats, "corr", 0)))


# a file one package writes loads in the other exactly (f32 values; bf16
# velocity is stored as its exact f32 value); the next epoch from the
# loaded state then agrees as whole epochs do (rtol 1e-4, atol 1e-5)
@pytest.mark.parametrize("velocity_dtype", [None, "bf16"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_state_file_loads_across_packages(tmp_path, writer, velocity_dtype):
    jtr, ttr = _state_trainers(velocity_dtype)
    src, dst = (ttr, jtr) if writer == "torch" else (jtr, ttr)
    src.run_epoch(iter(_utts(5)), batch_utts=5)
    path = str(tmp_path / "state.npz")
    src.save_state(path)
    with np.load(path) as data:
        keys = set(data.files)
    assert {"_rng_x", "_stats", "p0.weight", "p0.bias", "v4.weight"} <= keys
    dst.load_state(path)
    (sp, sv, ss), (dp, dv, ds) = _trainer_state(src), _trainer_state(dst)
    assert ds == ss and ss[1] > 0
    for a, b in zip(sp + sv, dp + dv):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for tr in (jtr, ttr):
        tr.run_epoch(iter(_utts(9)), batch_utts=5)
    np.testing.assert_allclose(ttr.stats.error, jtr.stats.error, rtol=1e-5)
    for a, b in zip(_trainer_state(ttr)[0], _trainer_state(jtr)[0]):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5)


# an MSE trainer's state file has the JAX layout ([error, frames, 0] in
# _stats, the SparseLinearity mask among the params) and loads across the
# packages exactly
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_mse_sparse_state_file_loads_across_packages(tmp_path, writer):
    text = _head_text("softmax", seed=13).replace("<biasedlinearity>", "<sparselinearity>", 1)
    common = dict(bunchsize=16, cachesize=64, seed=7, objective="mse")
    sgd = dict(learning_rate=0.5, momentum=0.5, l1=1e-4)
    jtr = JTrainer(JNetwork.read(text), JTrainerConfig(
        **common, sgd=jsgd.SgdConfig(**sgd), use_pallas=True))
    ttr = Trainer(TNetwork.read(text), TrainerConfig(**common, sgd=tsgd.SgdConfig(**sgd)),
                  device="cpu")
    src, dst = (ttr, jtr) if writer == "torch" else (jtr, ttr)
    src.run_epoch(iter(_utts(5)), batch_utts=5)
    path = str(tmp_path / "state.npz")
    src.save_state(path)
    with np.load(path) as data:
        assert {"p0.mask", "v0.weight", "_stats"} <= set(data.files)
        assert "v0.mask" not in data.files
        st = data["_stats"]
    assert st.shape == (3,) and st[2] == 0 and st[1] == src.stats.frames > 0
    dst.load_state(path)
    assert (dst.stats.error, dst.stats.frames) == (src.stats.error, src.stats.frames)
    for a, b in zip(_trainer_state(src)[0] + _trainer_state(src)[1],
                    _trainer_state(dst)[0] + _trainer_state(dst)[1]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_load_state_rejects_a_mismatched_network(tmp_path):
    _, ttr = _state_trainers(None)
    path = str(tmp_path / "state.npz")
    ttr.save_state(path)
    other = Trainer(TNetwork.read(_stdout_of(gen_mlp_init.main, [
        "--dim=20:16:32:10", "--gauss", "--negbias", "--seed=3"])),
        TrainerConfig(sgd=tsgd.SgdConfig(momentum=0.5)), device="cpu")
    with pytest.raises(ValueError, match="p0.weight"):
        other.load_state(path)

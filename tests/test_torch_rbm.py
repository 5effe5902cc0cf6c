"""The port's RBM CD-1 pretraining against the JAX package, on the CPU.

The noise streams cannot match (JAX splits a threefry key per bunch, the
port draws from one torch.Generator), so the same noise is injected on
both sides (``sample_hidden(..., noise=)``). One CD-1 update, from a
non-zero state: parameters, corrections, RbmSparse's Q and the MSE within
rtol 1e-5, atol 1e-6 (f32 summation order). An ``RbmTrainer`` epoch over
several caches with a partial last one, the port's noise drawn from a
clone of its generator and fed into JAX's step in JAX's bunch order (both
caches shuffle with the same Rand48): weights and Mse within rtol 1e-4,
atol 1e-5, frames exact. ``trbm`` is held by properties (its stream is the
port's own), and the pretraining recipe by fine-tuned accuracy.
"""

import contextlib
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnet_asr_tpu.models import components as JC
from nnet_asr_tpu.models.network import Network as JNetwork
from nnet_asr_tpu.tools import trbm as jtrbm
from nnet_asr_tpu.train import rbm as jrbm
from nnet_asr_torch.models import components as TC
from nnet_asr_torch.models.network import Network as TNetwork
from nnet_asr_torch.tools import generators as tgenerators
from nnet_asr_torch.tools import trbm as ttrbm
from nnet_asr_torch.tools.synth_corpus import CorpusShape, make_corpus
from nnet_asr_torch.train import rbm as trbm_mod

torch.set_num_threads(2)

KINDS = {"bern-bern": (JC.Rbm, TC.Rbm, "bern", "bern"),
         "gauss-bern": (JC.Rbm, TC.Rbm, "gauss", "bern"),
         "gauss-gauss": (JC.Rbm, TC.Rbm, "gauss", "gauss"),
         "sparse": (JC.RbmSparse, TC.RbmSparse, "bern", "bern")}
CFG = dict(learning_rate=0.05, momentum=0.5, weightcost=2e-3, sparsity_prior=0.05,
           sparsity_lambda=0.9, sparsity_cost=0.01)


def _specs(kind, nv, nh):
    jcls, tcls, vt, ht = KINDS[kind]
    return jcls(nv, nh, vis_type=vt, hid_type=ht), tcls(nv, nh, vis_type=vt, hid_type=ht)


def _params(rng, nv, nh):
    return {"weight": (0.3 * rng.standard_normal((nv, nh))).astype(np.float32),
            "vis_bias": (0.1 * rng.standard_normal(nv)).astype(np.float32),
            "hid_bias": (0.1 * rng.standard_normal(nh)).astype(np.float32)}


def _data(rng, kind, n, nv):
    if kind.startswith("gauss"):
        return rng.standard_normal((n, nv)).astype(np.float32)
    return (rng.random((n, nv)) > 0.5).astype(np.float32)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cd1_update_with_injected_noise_matches_jax(kind):
    rng = np.random.default_rng(sorted(KINDS).index(kind))
    nv, nh, B = 9, 7, 16
    jspec, tspec = _specs(kind, nv, nh)
    p = _params(rng, nv, nh)
    jcfg, tcfg = jrbm.RbmTrainConfig(**CFG), trbm_mod.RbmTrainConfig(**CFG)
    # a non-zero state: the corrections and Q of an earlier step
    state = {"vh_corr": 0.01 * rng.standard_normal((nv, nh)), "vb_corr": 0.01 * rng.standard_normal(nv),
             "hb_corr": 0.01 * rng.standard_normal(nh)}
    if kind == "sparse":
        state["sparsity_q"] = 0.2 * rng.random(nh)
    state = {k: v.astype(np.float32) for k, v in state.items()}
    x = _data(rng, kind, B, nv)
    noise = trbm_mod.hidden_noise(tspec, torch.Generator().manual_seed(3), (B, nh)).numpy()

    jp, js = {k: jnp.asarray(v) for k, v in p.items()}, {k: jnp.asarray(v) for k, v in state.items()}
    pos_hid = jspec.apply(jp, jnp.asarray(x))
    neg_vis = jspec.reconstruct(jp, jrbm.sample_hidden(jspec, None, pos_hid, noise=jnp.asarray(noise)))
    neg_hid = jspec.apply(jp, neg_vis)
    jmse = 0.5 * jnp.sum((neg_vis - jnp.asarray(x)) ** 2)
    jp, js = jrbm.apply_rbm_update(jspec, jcfg, jp, js, jnp.asarray(x), pos_hid, neg_vis, neg_hid)

    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ts = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    tmse = trbm_mod.cd1_step(tspec, tcfg, tp, ts, torch.from_numpy(x), noise=torch.from_numpy(noise))
    assert sorted(ts) == sorted(js)
    for k in jp:
        _close(tp[k], jp[k], 1e-5, 1e-6, k)
    for k in js:
        _close(ts[k], js[k], 1e-5, 1e-6, k)
    _close(tmse, jmse, 1e-5, 1e-6, "mse")
    # the port's initial state is JAX's
    init_t = trbm_mod.init_rbm_state(tspec, {k: torch.from_numpy(v) for k, v in p.items()}, tcfg)
    init_j = jrbm.init_rbm_state(jspec, {k: jnp.asarray(v) for k, v in p.items()}, jcfg)
    assert sorted(init_t) == sorted(init_j)
    for k in init_j:
        np.testing.assert_array_equal(init_t[k].numpy(), np.asarray(init_j[k]))


@pytest.mark.parametrize("kind", ["sparse", "gauss-gauss"])
def test_rbm_trainer_epoch_matches_jax_with_injected_noise(kind):
    rng = np.random.default_rng(10 + len(kind))
    nv, nh, bunch, cache = 6, 5, 8, 32
    jspec, tspec = _specs(kind, nv, nh)
    p = _params(rng, nv, nh)
    # 116 frames: three full caches and a partial fourth (2 bunches + 4 rows)
    utts = [_data(rng, kind, T, nv) for T in (13, 9, 21, 7, 30, 11, 25)]
    assert sum(u.shape[0] for u in utts) == 116
    gen = torch.Generator().manual_seed(77)
    clone = torch.Generator()
    clone.set_state(gen.get_state())
    tcfg = trbm_mod.RbmTrainConfig(**CFG)
    ttr = trbm_mod.RbmTrainer(tspec, p, tcfg, bunchsize=bunch, cachesize=cache, seed=5,
                              device="cpu", generator=gen)
    ttr.run_epoch(iter(utts), batch_utts=3)

    jtr = jrbm.RbmTrainer(jspec, p, jrbm.RbmTrainConfig(**CFG), bunchsize=bunch,
                          cachesize=cache, seed=5)

    def drain_with_ports_noise(params, state, key, feats_all):
        total = 0.0
        for feats in feats_all:
            noise = trbm_mod.hidden_noise(tspec, clone, (feats.shape[0], nh)).numpy()
            pos_hid = jspec.apply(params, feats)
            neg_vis = jspec.reconstruct(params, jrbm.sample_hidden(
                jspec, None, pos_hid, noise=jnp.asarray(noise)))
            neg_hid = jspec.apply(params, neg_vis)
            total = total + 0.5 * jnp.sum((neg_vis - feats) ** 2)
            params, state = jrbm.apply_rbm_update(jspec, jrbm.RbmTrainConfig(**CFG), params,
                                                  state, feats, pos_hid, neg_vis, neg_hid)
        return params, state, key, total

    jtr._drain_scan = drain_with_ports_noise
    jtr.run_epoch(iter(utts), batch_utts=3)
    assert ttr.frames == jtr.frames == 112
    np.testing.assert_allclose(ttr.mse_sum, jtr.mse_sum, rtol=1e-4, atol=1e-5)
    for k in p:
        _close(ttr.params[k], jtr.params[k], 1e-4, 1e-5, k)
    for k in jtr.state:
        _close(ttr.state[k], jtr.state[k], 1e-4, 1e-5, k)
    fmt = re.compile(r"Mse:\S+ frames:(\d+) err/frm:\S+\n$")
    assert fmt.fullmatch(ttr.report()) and fmt.fullmatch(jtr.report())
    assert fmt.fullmatch(ttr.report()).group(1) == fmt.fullmatch(jtr.report()).group(1)


def test_rbm_trainer_rng_impls_and_divergence():
    rng = np.random.default_rng(4)
    _, tspec = _specs("gauss-bern", 6, 4)
    p = _params(rng, 6, 4)
    rows = torch.from_numpy(_data(rng, "gauss-bern", 64, 6))
    ws = []
    for impl in ("threefry", "rbg"):
        tr = trbm_mod.RbmTrainer(tspec, p, trbm_mod.RbmTrainConfig(learning_rate=0.01, rng_impl=impl),
                                 bunchsize=16, cachesize=64, seed=3, randomize=False, device="cpu")
        tr.ingest_block(rows, 64)
        assert tr.frames == 64 and not np.array_equal(tr.params["weight"].numpy(), p["weight"])
        ws.append(tr.params["weight"].numpy())
    # one generator seeded by --SEED: the two names give one stream
    np.testing.assert_array_equal(*ws)
    with pytest.raises(ValueError, match="rng_impl"):
        trbm_mod.RbmTrainer(tspec, p, trbm_mod.RbmTrainConfig(rng_impl="bogus"), device="cpu")
    tr = trbm_mod.RbmTrainer(tspec, p, trbm_mod.RbmTrainConfig(learning_rate=1e30),
                             bunchsize=16, cachesize=64, seed=3, device="cpu")
    with pytest.raises(FloatingPointError, match="training diverged"):
        tr.run_epoch(iter([100.0 * rows.numpy()]))


# ---------------------------------------------------------------------------
# trbm

SHAPE = CorpusShape(feat_dim=5, ext=3, dct=4, hidden=24, classes=6, n_train=12,
                    n_cv=0, min_frames=20, max_frames=40)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    make_corpus(str(d), SHAPE, seed=41)
    dim = SHAPE.feat_dim * SHAPE.dct
    (d / "rbm_gauss.mmf").write_text(_stdout_of(tgenerators.main, [
        "rbm_init", f"--dim={dim}:16", "--gauss", "--vistype=gauss", "--seed=5"]))
    return d


def _stdout_of(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


def _trbm_argv(d, src, target, *extra):
    return ["trbm", "-H", str(src), "-S", str(d / "train.scp"),
            f"--FEATURETRANSFORM={d / 'transform'}", f"--STARTFRMEXT={SHAPE.ext}",
            f"--ENDFRMEXT={SHAPE.ext}", "--BUNCHSIZE=16", "--CACHESIZE=128", "--SEED=9",
            "--LEARNINGRATE=0.002", "--MOMENTUM=0.5", f"--TARGETMMF={target}", *extra]


MSE = re.compile(r"Mse:(\S+) frames:(\d+) err/frm:(\S+)")


def test_trbm_cli_trains_and_writes_a_model_jax_reads(corpus, tmp_path):
    d = corpus
    jlog = _stdout_of(jtrbm.main, _trbm_argv(d, d / "rbm_gauss.mmf", tmp_path / "j.mmf"))
    per_frame, src = [], d / "rbm_gauss.mmf"
    for it in range(3):
        out = tmp_path / f"t{it}.mmf"
        log = _stdout_of(ttrbm.main, _trbm_argv(d, src, out, "--RNGIMPL=rbg" if it else
                                                "--RNGIMPL=threefry"), device="cpu")
        for line in ("===== TRbm TRAINING STARTED =====", "learning rate: 0.002 momentum: 0.5",
                     "===== TRbm FINISHED", "FPS:"):
            assert line in log
        m = MSE.search(log)
        assert m and int(m.group(2)) == int(MSE.search(jlog).group(2)) > 0
        per_frame.append(float(m.group(3)))
        src = out
    assert per_frame[0] > per_frame[1] > per_frame[2], per_frame
    jnet, tnet = JNetwork.read(str(tmp_path / "j.mmf")), JNetwork.read(str(src))
    assert [s.tag for s in tnet.specs] == [s.tag for s in jnet.specs] == ["<rbm>"]
    assert (tnet.specs[0].vis_type, tnet.specs[0].hid_type) == ("gauss", "bern")
    assert all(np.isfinite(v).all() and v.shape == jnet.params[0][k].shape
               for k, v in tnet.params[0].items())


def test_trbm_cli_refusals_match_jax(corpus, tmp_path):
    d = corpus
    for main, kw in ((jtrbm.main, {}), (ttrbm.main, {"device": "cpu"})):
        with pytest.raises(SystemExit, match="First component of the network must be <rbm>"):
            main(_trbm_argv(d, d / "init.mmf", tmp_path / "x.mmf"), **kw)
        with pytest.raises(ValueError, match="Invalid value 'bogus' for RNGIMPL"):
            main(_trbm_argv(d, d / "rbm_gauss.mmf", tmp_path / "x.mmf", "--RNGIMPL=bogus"), **kw)
        with pytest.raises(SystemExit, match=r"Target MMF must be specified"):
            main(["trbm", "-H", str(d / "rbm_gauss.mmf")], **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrbm.main(_trbm_argv(d, d / "rbm_gauss.mmf", tmp_path / "x.mmf"))


# ---------------------------------------------------------------------------
# the pretraining recipe: RbmTrainer -> rbm2mlplayer -> netjoin -> fine-tune

def test_rbm_pretrain_then_finetune(tmp_path):
    """The port's version of tests/test_workflows.py's composition, through
    the MMF files of examples/run_rbm_pretrain_example01.sh."""
    from nnet_asr_torch.train.sgd import SgdConfig
    from nnet_asr_torch.train.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(0)
    dim, hid, classes = 10, 16, 4
    protos = (rng.random((classes, dim)) > 0.5).astype(np.float32)
    y = rng.integers(0, classes, 600).astype(np.int32)
    X = protos[y].copy()
    flip = rng.random(X.shape) < 0.05
    X[flip] = 1 - X[flip]

    rbm = TC.Rbm(dim, hid)
    rt = trbm_mod.RbmTrainer(rbm, _params(rng, dim, hid), trbm_mod.RbmTrainConfig(learning_rate=0.1),
                             bunchsize=100, cachesize=600, seed=3, device="cpu")
    for _ in range(15):
        rt.run_epoch(iter([X]))
    rbm.load_params(rt.numpy_params())
    TNetwork([rbm]).write(str(tmp_path / "rbm.mmf"))
    tgenerators.main(["rbm2mlplayer", str(tmp_path / "rbm.mmf"), str(tmp_path / "layer.mmf")])
    out_w = (0.1 * rng.standard_normal((classes, hid))).astype(np.float32)
    (tmp_path / "top.mmf").write_text(
        f"<biasedlinearity> {classes} {hid}\nm {classes} {hid}\n"
        + "\n".join(" ".join(repr(float(v)) for v in row) for row in out_w)
        + f"\nv {classes}\n" + " ".join(["0.0"] * classes) + f"\n<softmax> {classes} {classes}\n")
    joined = _stdout_of(tgenerators.main, ["netjoin", str(tmp_path / "layer.mmf"),
                                           str(tmp_path / "top.mmf")])
    net = TNetwork.read(joined)
    assert [l.tag for l in net.layers] == ["<biasedlinearity>", "<sigmoid>",
                                           "<biasedlinearity>", "<softmax>"]
    tr = Trainer(net, TrainerConfig(bunchsize=100, cachesize=600, seed=5,
                                    sgd=SgdConfig(learning_rate=0.5, grad_div_frm=True)),
                 device="cpu")
    for _ in range(5):
        tr.stats = type(tr.stats)()
        tr.run_epoch(iter([(X, y)]))
    assert tr.stats.accuracy > 90.0, tr.stats.accuracy


def test_trbm_accepts_the_reference_flags():
    """tests/test_flag_parity.py's TRbmCu flags, and --GPUSELECT, pass the
    unused-parameter check; the run then stops for want of -H."""
    from test_flag_parity import REF_FLAGS

    for flag in REF_FLAGS["trbm"].split() + ["GPUSELECT=-1", "RNGIMPL=rbg"]:
        with contextlib.redirect_stdout(io.StringIO()), \
                pytest.raises(SystemExit, match=r"Source MMF must be specified \[-H\]"):
            ttrbm.main(["trbm", f"--{flag}"], device="cpu")

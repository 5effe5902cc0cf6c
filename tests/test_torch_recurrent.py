"""The port's <recurrent> layer and truncated-BPTT trainer against the JAX
package, on the CPU.

Forward: ``apply``/``apply_with_state`` from a non-zero state within
rtol 1e-5, atol 1e-6. Segment training (K frames a segment, batches of
utterances of unequal length that are not multiples of K, momentum,
weight cost, learning-rate factors, crossvalidation): parameters within
rtol 1e-4, atol 1e-5, Xent within rtol 1e-5, frames equal, correct within
one frame; the port has no padded segments, JAX pads to 16 (exact no-ops).
Frame-serial: against JAX's frame-serial mode within rtol 1e-4, atol 1e-5,
and against the numpy oracle of tests/test_rbm_recurrent.py at its own
rtol 2e-4, atol 2e-5. The ``trecurrent`` CLI: the ``Xent:`` line within
rtol 1e-5 and the MMF weights within atol 1e-5. ``tfeacat`` on a net with
a <recurrent> layer: posteriors within rtol 1e-5.
"""

import contextlib
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnet_asr_tpu.io import htk
from nnet_asr_tpu.io.mlf import MlfWriter
from nnet_asr_tpu.models import components as JC
from nnet_asr_tpu.models.network import Network as JNetwork
from nnet_asr_tpu.tools import generators as jgenerators
from nnet_asr_tpu.tools import tfeacat as jtfeacat
from nnet_asr_tpu.tools import trecurrent as jtrecurrent
from nnet_asr_tpu.train import recurrent as jrec
from nnet_asr_tpu.train.sgd import SgdConfig as JSgdConfig
from nnet_asr_torch.models import components as TC
from nnet_asr_torch.models.network import Network as TNetwork
from nnet_asr_torch.tools import tfeacat as ttfeacat
from nnet_asr_torch.tools import trecurrent as ttrecurrent
from nnet_asr_torch.tools.synth_corpus import CorpusShape, make_corpus
from nnet_asr_torch.train import recurrent as trec
from nnet_asr_torch.train.sgd import SgdConfig as TSgdConfig
from test_rbm_recurrent import _serial_oracle

torch.set_num_threads(2)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_recurrent_forward_matches_jax(batch):
    rng = np.random.default_rng(len(batch))
    din, dout, T = 5, 4, 11
    p = {"weight": _rand(rng, din + dout, dout, scale=0.5), "bias": _rand(rng, dout)}
    x, h0 = _rand(rng, *batch, T, din), _rand(rng, *batch, dout)
    jspec, tspec = JC.Recurrent(din, dout), TC.Recurrent(din, dout).load_params(p)
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, tspec.param_dict()
    run = jspec.apply_with_state
    for _ in batch:
        run = jax.vmap(run, in_axes=(None, 0, 0))
    jy, jh = run(jp, jnp.asarray(x), jnp.asarray(h0))
    with torch.no_grad():
        ty, th = tspec.apply_with_state(tp, torch.from_numpy(x), torch.from_numpy(h0))
        tz = tspec(torch.from_numpy(x[(0,) * len(batch)]))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th.numpy(), ty.numpy()[..., -1, :], rtol=0, atol=0)
    jz = jspec.apply(jp, jnp.asarray(x[(0,) * len(batch)]))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-5, atol=1e-6)


def test_recurrent_mmf_from_generator_byte_equal_and_bad_dims_raise():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jgenerators.main(["recurrent_init", "--dim=4:6:3", "--gauss", "--negbias", "--seed=2"])
    text = buf.getvalue()
    jnet, tnet = JNetwork.read(text), TNetwork.read(text)
    assert tnet.to_text() == jnet.to_text()
    assert tnet.has_recurrent() and jnet.has_recurrent()
    assert [l.tag for l in tnet.layers] == ["<recurrent>", "<recurrent>"]
    tnet.check_dims()
    back = tnet.to_numpy_params()
    for a, b in zip(back, jnet.params):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    for read in (JNetwork.read, TNetwork.read):
        with pytest.raises(ValueError, match="Wrong recurrent dimensions in network file"):
            read("<recurrent> 2 2\nm 2 2\n1 2\n3 4\nv 2\n0 0\n")


# ---------------------------------------------------------------------------
# the trainer

def _deep_net(rng, din=4, d1=5, dh=6, dout=3):
    """BL -> Sigmoid -> Recurrent -> BL -> Softmax, JAX specs and params."""
    specs = (JC.BiasedLinearity(din, d1), JC.Sigmoid(d1, d1), JC.Recurrent(d1, dh),
             JC.BiasedLinearity(dh, dout), JC.Softmax(dout, dout))
    params = [{"weight": _rand(rng, din, d1, scale=0.5), "bias": _rand(rng, d1, scale=0.1)}, {},
              {"weight": _rand(rng, d1 + dh, dh, scale=0.4), "bias": _rand(rng, dh, scale=0.1)},
              {"weight": _rand(rng, dh, dout, scale=0.4), "bias": _rand(rng, dout, scale=0.1)}, {}]
    return specs, params


def _simple_net(rng, din=4, dh=6, dout=3):
    """tests/test_rbm_recurrent.py's net: Recurrent -> BL -> Softmax."""
    specs = (JC.Recurrent(din, dh), JC.BiasedLinearity(dh, dout), JC.Softmax(dout, dout))
    params = [{"weight": _rand(rng, din + dh, dh, scale=0.3), "bias": np.zeros(dh, np.float32)},
              {"weight": _rand(rng, dh, dout, scale=0.3), "bias": np.zeros(dout, np.float32)}, {}]
    return specs, params


def _nets(specs, params):
    jnet = JNetwork(specs, [dict(p) for p in params])
    tnet = TNetwork.read(jnet.to_text())
    return jnet, tnet


def _sequences(rng, lens, din=4, dout=3):
    """Label = the channel active one frame earlier (tests/test_rbm_recurrent.py)."""
    utts = []
    for T in lens:
        ch = rng.integers(0, dout, T)
        x = np.zeros((T, din), np.float32)
        x[np.arange(T), ch] = 1.0
        x += _rand(rng, T, din, scale=0.1)
        labels = np.roll(ch, 1)
        labels[0] = ch[0]
        utts.append((x, labels.astype(np.int32)))
    return utts


def _assert_params_close(tnet, jparams, rtol=1e-4, atol=1e-5):
    for i, (a, b) in enumerate(zip(tnet.to_numpy_params(), jparams)):
        for k in b:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=rtol, atol=atol,
                                       err_msg=f"layer {i} {k}")


def _assert_stats_close(ts, js):
    assert ts.frames == js.frames > 0
    np.testing.assert_allclose(ts.error, js.error, rtol=1e-5)
    assert abs(ts.corr - js.corr) <= 1


@pytest.mark.parametrize("K", [3, 4])
@pytest.mark.parametrize("momentum", [0.0, 0.5])
@pytest.mark.parametrize("batch_utts", [1, 3])
def test_segment_training_matches_jax(K, momentum, batch_utts):
    rng = np.random.default_rng(100 * K + 10 * batch_utts + int(10 * momentum))
    jnet, tnet = _nets(*_deep_net(rng))
    utts = _sequences(rng, (17, 10, 23, 6, 14))
    kw = dict(learning_rate=0.3, momentum=momentum, weightcost=1e-3, grad_div_frm=False,
              lr_factors=(0.5, 1.0, 0.8))
    jtr = jrec.RecurrentTrainer(jnet, jrec.RecurrentTrainerConfig(bptt_order=K,
                                                                  sgd=JSgdConfig(**kw)))
    ttr = trec.RecurrentTrainer(tnet, trec.RecurrentTrainerConfig(bptt_order=K,
                                                                  sgd=TSgdConfig(**kw)),
                                device="cpu")
    for _ in range(2):
        jtr.run_epoch(iter(utts), batch_utts=batch_utts)
        ttr.run_epoch(iter(utts), batch_utts=batch_utts)
    _assert_params_close(tnet, jtr.params)
    _assert_stats_close(ttr.stats, jtr.stats)
    assert ttr.stats.frames == 2 * sum(len(l) for _, l in utts)
    assert ttr.report().startswith("Xent:")
    upd = ttr.updated_network()
    assert upd.to_text() == tnet.to_text() and next(upd.parameters()).device.type == "cpu"


def test_segment_crossvalidate_matches_jax_and_updates_nothing():
    rng = np.random.default_rng(7)
    specs, params = _deep_net(rng)
    jnet, tnet = _nets(specs, params)
    before = tnet.to_text()
    utts = _sequences(rng, (9, 15, 4))
    jtr = jrec.RecurrentTrainer(jnet, jrec.RecurrentTrainerConfig(bptt_order=4, crossvalidate=True))
    ttr = trec.RecurrentTrainer(tnet, trec.RecurrentTrainerConfig(bptt_order=4, crossvalidate=True),
                                device="cpu")
    jtr.run_epoch(iter(utts), batch_utts=2)
    ttr.run_epoch(iter(utts), batch_utts=2)
    _assert_stats_close(ttr.stats, jtr.stats)
    assert tnet.to_text() == before


@pytest.mark.parametrize("net,momentum", [("simple", 0.0), ("simple", 0.3), ("deep", 0.4)])
def test_frame_serial_matches_jax_and_the_oracle(net, momentum):
    rng = np.random.default_rng(6)
    specs, params = (_simple_net if net == "simple" else _deep_net)(rng)
    jnet, tnet = _nets(specs, params)
    K, lr = 3, 0.2
    utts = _sequences(rng, (40, 33))
    kw = dict(learning_rate=lr, momentum=momentum, grad_div_frm=False,
              weightcost=0.0 if net == "simple" else 1e-3)
    jtr = jrec.RecurrentTrainer(jnet, jrec.RecurrentTrainerConfig(
        bptt_order=K, frame_serial=True, sgd=JSgdConfig(**kw)))
    ttr = trec.RecurrentTrainer(tnet, trec.RecurrentTrainerConfig(
        bptt_order=K, frame_serial=True, sgd=TSgdConfig(**kw)), device="cpu")
    for x, l in utts:
        jtr.train_utterance_serial(x, l)
        ttr.train_utterance_serial(x, l)
    _assert_params_close(tnet, jtr.params)
    _assert_stats_close(ttr.stats, jtr.stats)
    assert ttr.stats.frames == 73
    if net == "simple":
        want = _serial_oracle(jnet, utts, K, lr, momentum)
        got = tnet.to_numpy_params()
        for g, w in zip((got[0]["weight"], got[0]["bias"], got[1]["weight"], got[1]["bias"]), want):
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5)


def test_trainer_refusals():
    rng = np.random.default_rng(8)
    _, tnet = _nets(*_simple_net(rng))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 14"):
        trec.RecurrentTrainer(tnet, trec.RecurrentTrainerConfig(), mesh=object(), device="cpu")
    no_softmax = TNetwork(list(tnet.layers)[:2])
    with pytest.raises(ValueError, match="terminal <softmax>"):
        trec.RecurrentTrainer(no_softmax, trec.RecurrentTrainerConfig(), device="cpu")
    two = TNetwork([TC.Recurrent(4, 4), TC.Recurrent(4, 3), TC.Softmax(3, 3)])
    with pytest.raises(ValueError, match="exactly one <recurrent>"):
        trec.RecurrentTrainer(two, trec.RecurrentTrainerConfig(frame_serial=True), device="cpu")


# ---------------------------------------------------------------------------
# trecurrent, as tests/test_workflows.py builds its corpus

def _stdout_of(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def rec_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("rec")
    rng = np.random.default_rng(3)
    din, dh, dout = 3, 6, 3
    text = _stdout_of(jgenerators.main, ["recurrent_init", f"--dim={din}:{dh}", "--gauss",
                                         "--seed=4"])
    text += f"<biasedlinearity> {dout} {dh}\nm {dout} {dh}\n"
    w = 0.3 * rng.standard_normal((dout, dh))
    text += "\n".join(" ".join(repr(float(v)) for v in row) for row in w)
    text += f"\nv {dout}\n" + " ".join(["0.0"] * dout) + "\n"
    text += f"<softmax> {dout} {dout}\n"
    (d / "rec.mmf").write_text(text)
    os.makedirs(d / "feats")
    mlf = MlfWriter(str(d / "labs.mlf"))
    scp = []
    for u in range(8):
        T = int(rng.integers(20, 41))
        ch = rng.integers(0, dout, T)
        x = np.zeros((T, din), np.float32)
        x[np.arange(T), ch] = 1.0
        labels = np.roll(ch, 1)
        labels[0] = ch[0]
        p = str(d / "feats" / f"u{u}.fea")
        htk.write_htk_file(p, x, htk.PARMKIND_USER)
        mlf.write_record(f"*/u{u}.lab", [f"{i * 100000} {(i + 1) * 100000} c{labels[i]}"
                                         for i in range(T)])
        scp.append(p)
    mlf.close()
    (d / "map").write_text("c0 c1 c2")
    (d / "train.scp").write_text("\n".join(scp) + "\n")
    return d


def _trec_argv(d, src, *extra):
    return ["trec", "-H", str(src), "-I", str(d / "labs.mlf"), "-L", "*/", "-X", "lab",
            "-S", str(d / "train.scp"), "-m", str(d / "map"), "-n", "0.3", "--BPTT=4", *extra]


XENT = re.compile(r"Xent:(\S+) frames:(\d+) err/frm:\S+ correct\[(\S+)%\]")


@pytest.mark.parametrize("extra", [(), ("--MOMENTUM=0.5", "--WEIGHTCOST=0.001"),
                                   ("--FRAMESERIAL=TRUE",)])
def test_trecurrent_matches_jax(rec_corpus, tmp_path, extra):
    d = rec_corpus
    outs = {}
    for name, main, kw in (("jax", jtrecurrent.main, {}), ("torch", ttrecurrent.main,
                                                           {"device": "cpu"})):
        src, logs = d / "rec.mmf", []
        for it in range(2):
            out = tmp_path / f"{name}{it}.mmf"
            logs.append(_stdout_of(main, _trec_argv(d, src, f"--TARGETMMF={out}", *extra), **kw))
            src = out
        logs.append(_stdout_of(main, _trec_argv(d, src, "-c"), **kw))
        outs[name] = (logs, src)
    (jlogs, jout), (tlogs, tout) = outs["jax"], outs["torch"]
    assert "===== TRecurrent TRAINING STARTED =====" in tlogs[0]
    assert "===== TRecurrent CROSSVAL STARTED =====" in tlogs[-1]
    for jl, tl in zip(jlogs, tlogs):
        (jx, jf, jacc), (tx, tf, tacc) = (XENT.search(s).groups() for s in (jl, tl))
        assert int(tf) == int(jf) > 0
        np.testing.assert_allclose(float(tx), float(jx), rtol=1e-5)
        assert abs(float(tacc) - float(jacc)) <= 100.0 / int(tf)
    jnet, tnet = JNetwork.read(str(jout)), JNetwork.read(str(tout))
    assert [s.tag for s in tnet.specs] == [s.tag for s in jnet.specs]
    for a, b in zip(tnet.params, jnet.params):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0)


def test_trecurrent_needs_cuda_unless_cpu_is_named(rec_corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrecurrent.main(_trec_argv(rec_corpus, rec_corpus / "rec.mmf"))
    with pytest.raises(SystemExit, match=r"Source mlf file is missing \[-I\]"):
        ttrecurrent.main(["trec", "-H", str(rec_corpus / "rec.mmf")], device="cpu")


# ---------------------------------------------------------------------------
# tfeacat on a net with a <recurrent> layer

SHAPE = CorpusShape(feat_dim=5, ext=3, dct=4, hidden=24, classes=6, n_train=2,
                    n_cv=12, min_frames=20, max_frames=40)


def test_tfeacat_recurrent_net_matches_jax(tmp_path):
    make_corpus(str(tmp_path), SHAPE, seed=51)
    rng = np.random.default_rng(52)
    din = SHAPE.feat_dim * SHAPE.dct
    specs = (JC.BiasedLinearity(din, 10), JC.Sigmoid(10, 10), JC.Recurrent(10, 8),
             JC.BiasedLinearity(8, SHAPE.classes), JC.Softmax(SHAPE.classes, SHAPE.classes))
    params = [{"weight": _rand(rng, din, 10, scale=0.3), "bias": _rand(rng, 10, scale=0.1)}, {},
              {"weight": _rand(rng, 18, 8, scale=0.4), "bias": _rand(rng, 8, scale=0.1)},
              {"weight": _rand(rng, 8, SHAPE.classes, scale=0.5),
               "bias": _rand(rng, SHAPE.classes, scale=0.1)}, {}]
    (tmp_path / "rec.mmf").write_text(JNetwork(specs, params).to_text())
    dirs = {name: tmp_path / name for name in ("jax", "torch")}
    for p in dirs.values():
        p.mkdir()

    def argv(out):
        return ["tfeacat", "-H", str(tmp_path / "rec.mmf"), "-S", str(tmp_path / "cv.scp"),
                f"--FEATURETRANSFORM={tmp_path / 'transform'}", f"--STARTFRMEXT={SHAPE.ext}",
                f"--ENDFRMEXT={SHAPE.ext}", "-l", str(out), "-y", "post"]

    assert jtfeacat.main(argv(dirs["jax"])) == 0
    assert ttfeacat.main(argv(dirs["torch"]), device="cpu") == 0
    names = sorted(p.name for p in dirs["jax"].iterdir())
    assert len(names) == SHAPE.n_cv and names == sorted(p.name for p in dirs["torch"].iterdir())
    for name in names:
        (j, jh), (t, th) = (htk.read_htk_file(str(dirs[k] / name)) for k in ("jax", "torch"))
        assert th == jh and t.shape == j.shape and t.shape[1] == SHAPE.classes
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_trecurrent_accepts_the_reference_flags():
    """tests/test_flag_parity.py's TRecurrentCu flags, and --GPUSELECT and
    --FRAMESERIAL, pass the unused-parameter check; the run then stops for
    want of -H."""
    from test_flag_parity import REF_FLAGS

    for flag in REF_FLAGS["trecurrent"].split() + ["GPUSELECT=-1", "FRAMESERIAL=TRUE"]:
        with contextlib.redirect_stdout(io.StringIO()), \
                pytest.raises(SystemExit, match=r"Source MMF must be specified \[-H\]"):
            ttrecurrent.main(["trec", f"--{flag}"], device="cpu")

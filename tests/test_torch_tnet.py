"""The port's tnet CLI against the JAX tnet on a synthetic HTK corpus (CPU).

Same corpus (``nnet_asr_torch.tools.synth_corpus`` at a small shape),
transform (hamm_dct + bias/window normalisation), initial model and
options: the ``Xent:``/``Mse:`` values agree within 1e-5 relative (f32
summation order over a few dozen SGD steps), the written MMFs load
allclose (atol 1e-5), and the confusion report lines are equal. The
compute dtypes hold to the tolerances stated at their test.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from nnet_asr_tpu.models.network import Network as JNetwork
from nnet_asr_tpu.tools import tnet as jtnet
from nnet_asr_tpu.train.trainer import TrainerConfig as JTrainerConfig
from nnet_asr_torch.tools import tnet as ttnet
from nnet_asr_torch.tools.synth_corpus import CorpusShape, make_corpus

torch.set_num_threads(2)


def _stdout_of(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


SHAPE = CorpusShape(feat_dim=5, ext=3, dct=4, hidden=24, classes=6, n_train=15,
                    n_cv=0, min_frames=20, max_frames=40)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    n = make_corpus(str(d), SHAPE, seed=21)
    assert n["train"] > 0 and n["cv"] == 0
    return d


def _argv(d, src, *extra):
    return ["tnet", "-H", str(src), "-I", str(d / "labs.mlf"), "-L", "*/", "-X", "lab",
            "-S", str(d / "train.scp"), "-m", str(d / "map"), "-n", "0.05",
            "--BUNCHSIZE=16", "--CACHESIZE=64", "--SEED=123",
            f"--FEATURETRANSFORM={d / 'transform'}",
            f"--STARTFRMEXT={SHAPE.ext}", f"--ENDFRMEXT={SHAPE.ext}", *extra]


XENT = re.compile(r"Xent:(\S+) frames:(\d+) err/frm:\S+ correct\[(\S+)%\]")


def _xent(log):
    m = XENT.search(log)
    assert m, log
    return float(m.group(1)), int(m.group(2)), float(m.group(3))


@pytest.mark.parametrize("extra", [
    ("--GRAD-DIV-FRM=F",),
    ("--MOMENTUM=0.5", "--WEIGHTCOST=0.001", "--GPUSELECT=-1", "--THREADS=2"),
])
def test_tnet_matches_jax_tnet(corpus, tmp_path, extra):
    d = corpus
    jout, tout = tmp_path / "jax.mmf", tmp_path / "torch.mmf"
    jlog = _stdout_of(jtnet.main, _argv(d, d / "init.mmf", f"--TARGETMMF={jout}", *extra))
    tlog = _stdout_of(ttnet.main, _argv(d, d / "init.mmf", f"--TARGETMMF={tout}", *extra),
                      device="cpu")
    for line in ("===== TNET TRAINING STARTED =====", "===== TNET FINISHED",
                 "Objective function: Xent", "Learning rate: 0.05", "FPS:"):
        assert line in tlog
    jx, jf, _ = _xent(jlog)
    tx, tf, _ = _xent(tlog)
    assert tf == jf > 0
    np.testing.assert_allclose(tx, jx, rtol=1e-5)
    jnet, tnet = JNetwork.read(str(jout)), JNetwork.read(str(tout))
    assert [s.tag for s in tnet.specs] == [s.tag for s in jnet.specs]
    for a, b in zip(tnet.params, jnet.params):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0)

    # crossvalidation of the trained model
    jcv = _stdout_of(jtnet.main, _argv(d, jout, "-c"))
    tcv = _stdout_of(ttnet.main, _argv(d, tout, "-c"), device="cpu")
    assert "===== TNET CROSSVALIDATION STARTED =====" in tcv
    (jx, jf, jacc), (tx, tf, tacc) = _xent(jcv), _xent(tcv)
    assert tf == jf
    np.testing.assert_allclose(tx, jx, rtol=1e-5)
    assert abs(tacc - jacc) <= 100.0 / tf       # at most one frame's argmax


@pytest.mark.parametrize("extra", [
    ("--MESH=2x1",), ("--DISTRIBUTED=TRUE",), ("--JAXPROFILE=trace",), ("--MESH=1x2",),
    ("--COMPUTEDTYPE=bf16", "--MESH=2x1"), ("--COMPUTEDTYPE=int8pfsr", "--JAXPROFILE=trace"),
])
def test_tnet_option_outside_slice_raises(corpus, extra):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttnet.main(_argv(corpus, corpus / "init.mmf", *extra), device="cpu")


# --COMPUTEDTYPE against the JAX tnet, one epoch and a CV of its model.
# The int8 modes are f32 arithmetic: the f32 tolerances above. bf16: the
# JAX tnet takes its Pallas path here (its default is XLA's, which rounds
# the pre-activation to bf16 before the sigmoid; the port's kernel, as the
# Pallas one, rounds once after it), Xent within 1e-3 relative, weights
# within 2e-3 (a bf16 gradient rounding that flips between the two f32
# summation orders moves a weight by the learning rate times one bf16
# step), correct within 2 frames
@pytest.mark.parametrize("momentum", ["0", "0.5"])
@pytest.mark.parametrize("dtype", ["bf16", "int8", "int8pf", "int8full"])
def test_tnet_compute_dtype_matches_jax_tnet(corpus, tmp_path, monkeypatch, dtype, momentum):
    monkeypatch.setattr(JTrainerConfig, "pallas_enabled", lambda self: True)
    d = corpus
    rtol, atol = (1e-3, 2e-3) if dtype == "bf16" else (1e-5, 1e-5)
    extra = (f"--COMPUTEDTYPE={dtype}", f"--MOMENTUM={momentum}")
    jout, tout = tmp_path / "jax.mmf", tmp_path / "torch.mmf"
    jlog = _stdout_of(jtnet.main, _argv(d, d / "init.mmf", f"--TARGETMMF={jout}", *extra))
    tlog = _stdout_of(ttnet.main, _argv(d, d / "init.mmf", f"--TARGETMMF={tout}", *extra),
                      device="cpu")
    jcv = _stdout_of(jtnet.main, _argv(d, jout, "-c", extra[0]))
    tcv = _stdout_of(ttnet.main, _argv(d, tout, "-c", extra[0]), device="cpu")
    for j, t in ((jlog, tlog), (jcv, tcv)):
        (jx, jf, jacc), (tx, tf, tacc) = _xent(j), _xent(t)
        assert tf == jf > 0
        np.testing.assert_allclose(tx, jx, rtol=rtol)
        assert abs(tacc - jacc) <= (200.0 if dtype == "bf16" else 100.0) / tf
    for a, b in zip(JNetwork.read(str(tout)).params, JNetwork.read(str(jout)).params):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0)


# --COMPUTEDTYPE=int8pfsr: its noise stream is not JAX's, so the port is
# held to properties: the same run twice writes the same model, which
# differs from int8pf's; the epoch stays within 1e-3 relative of the JAX
# tool's (both round without bias around the same trajectory)
def test_tnet_int8pfsr_repeats_and_differs_from_int8pf(corpus, tmp_path):
    d = corpus
    logs = {}
    for name, dtype in (("a", "int8pfsr"), ("b", "int8pfsr"), ("pf", "int8pf")):
        logs[name] = _stdout_of(ttnet.main, _argv(d, d / "init.mmf", f"--COMPUTEDTYPE={dtype}",
                                                  f"--TARGETMMF={tmp_path / name}"),
                                device="cpu")
    texts = {n: (tmp_path / n).read_text() for n in logs}
    assert texts["a"] == texts["b"] != texts["pf"]
    jlog = _stdout_of(jtnet.main, _argv(d, d / "init.mmf", "--COMPUTEDTYPE=int8pfsr",
                                        f"--TARGETMMF={tmp_path / 'jax'}"))
    (jx, jf, _), (tx, tf, _) = _xent(jlog), _xent(logs["a"])
    assert tf == jf > 0
    np.testing.assert_allclose(tx, jx, rtol=1e-3)


# one momentum epoch with --SAVESTATE, then the next from its MMF with
# --RESUMESTATE, in each package: the resumed Xent (which carries the
# saved stats) within 1e-5 relative, the MMFs within atol 1e-5, and both
# state files hold the same keys
@pytest.mark.parametrize("velocity", ["f32", "bf16"])
def test_tnet_save_then_resume_state_matches_jax(corpus, tmp_path, velocity):
    d = corpus
    extra = ("--MOMENTUM=0.9", f"--VELOCITYDTYPE={velocity}")
    runs = {}
    for name, main, kw in (("jax", jtnet.main, {}), ("torch", ttnet.main, {"device": "cpu"})):
        e1, e2, st = (tmp_path / f"{name}_{f}" for f in ("e1.mmf", "e2.mmf", "state.npz"))
        log1 = _stdout_of(main, _argv(d, d / "init.mmf", f"--TARGETMMF={e1}",
                                      f"--SAVESTATE={st}", *extra), **kw)
        log2 = _stdout_of(main, _argv(d, e1, f"--TARGETMMF={e2}", f"--RESUMESTATE={st}",
                                      *extra), **kw)
        with np.load(st) as data:
            runs[name] = (_xent(log1), _xent(log2), e2, sorted(data.files))
    (jx1, jx2, je2, jkeys), (tx1, tx2, te2, tkeys) = runs["jax"], runs["torch"]
    assert tkeys == jkeys
    assert tx2[1] == jx2[1] == 2 * tx1[1] > 0        # the stats carry over
    np.testing.assert_allclose(tx1[0], jx1[0], rtol=1e-5)
    np.testing.assert_allclose(tx2[0], jx2[0], rtol=1e-5)
    for a, b in zip(JNetwork.read(str(te2)).params, JNetwork.read(str(je2)).params):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0)


def _model(corpus, tmp_path, kind):
    """The corpus's initial model, or it with a BlockSoftmax (3, 3) head, or
    with its hidden affine as a SparseLinearity (no mask: all ones)."""
    text = (corpus / "init.mmf").read_text()
    if kind == "blocksoftmax":
        text = text.replace(f"<softmax> {SHAPE.classes} {SHAPE.classes}",
                            f"<blocksoftmax> {SHAPE.classes} {SHAPE.classes}\nv 2\n3 3")
    elif kind == "sparse":
        text = text.replace("<biasedlinearity>", "<sparselinearity>", 1)
    src = tmp_path / f"{kind}.mmf"
    src.write_text(text)
    return src


def test_tnet_blocksoftmax_output_raises(corpus, tmp_path):
    """A BlockSoftmax whose spans do not sum to its width is refused, with
    the JAX reader's message."""
    text = _model(corpus, tmp_path, "blocksoftmax").read_text().replace("\n3 3", "\n3 2")
    src = tmp_path / "bad_block.mmf"
    src.write_text(text)
    with pytest.raises(ValueError, match="Non-matching dimension of sum of softmaxes"):
        ttnet.main(_argv(corpus, src), device="cpu")


MSE = re.compile(r"Mse:(\S+) frames:(\d+) err/frm:\S+")


def _report(log):
    """(value, frames) of the Xent or Mse line, and the confusion lines after it."""
    lines = log.splitlines()
    i = next(k for k, l in enumerate(lines) if l.startswith(("Xent:", "Mse:")))
    m = (XENT if lines[i].startswith("Xent:") else MSE).match(lines[i])
    rest = lines[i + 1:next(k for k in range(i, len(lines)) if lines[k].startswith("Done"))]
    return float(m.group(1)), int(m.group(2)), rest


# each new route against the JAX tnet, one epoch and a CV of its model
@pytest.mark.parametrize("model,extra", [
    ("init", ("-O", "mse")),
    ("init", ("--CONFUSIONMODE=max",)),
    ("init", ("--CONFUSIONMODE=dsoft", "--MOMENTUM=0.5")),
    ("sparse", ("--L1=0.001", "--GRAD-DIV-FRM=F")),
    ("sparse", ("--L1=0.0001", "--MOMENTUM=0.5", "--WEIGHTCOST=0.001")),
    ("blocksoftmax", ()),
    ("blocksoftmax", ("-O", "mse")),
])
def test_tnet_objectives_and_tags_match_jax_tnet(corpus, tmp_path, model, extra):
    d = corpus
    src = d / "init.mmf" if model == "init" else _model(d, tmp_path, model)
    jout, tout = tmp_path / "jax.mmf", tmp_path / "torch.mmf"
    jlog = _stdout_of(jtnet.main, _argv(d, src, f"--TARGETMMF={jout}", *extra))
    tlog = _stdout_of(ttnet.main, _argv(d, src, f"--TARGETMMF={tout}", *extra), device="cpu")
    mse = "mse" in extra
    assert f"Objective function: {'Mse' if mse else 'Xent'}" in tlog
    cv_extra = [e for e in extra if e.startswith(("-O", "mse", "--CONFUSIONMODE"))]
    jcv = _stdout_of(jtnet.main, _argv(d, jout, "-c", *cv_extra))
    tcv = _stdout_of(ttnet.main, _argv(d, tout, "-c", *cv_extra), device="cpu")
    for j, t in ((jlog, tlog), (jcv, tcv)):
        (jv, jf, jrest), (tv, tf, trest) = _report(j), _report(t)
        assert tf == jf > 0
        np.testing.assert_allclose(tv, jv, rtol=1e-5)
        assert trest == jrest
        if "--CONFUSIONMODE=max" in extra:
            assert trest[:2] == ["Row:label Col:hyp", f"m {SHAPE.classes} {SHAPE.classes}"]
            rows = np.array([[float(v) for v in l.split()] for l in trest[2:2 + SHAPE.classes]])
            assert rows.sum() == tf
        if "--CONFUSIONMODE=dsoft" in extra:
            assert len(trest) == SHAPE.classes and trest[0].split()[0] == "s0"
    jnet, tnet = JNetwork.read(str(jout)), JNetwork.read(str(tout))
    assert [s.tag for s in tnet.specs] == [s.tag for s in jnet.specs]
    for a, b in zip(tnet.params, jnet.params):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0)
    if model == "sparse":       # the written mask prunes |w| < 1e-3
        w, mask = tnet.params[0]["weight"], tnet.params[0]["mask"]
        assert (mask == 0).any() and (mask[np.abs(w) < 1e-3] == 0).all()


def test_tnet_needs_cuda_unless_cpu_is_named(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttnet.main(_argv(corpus, corpus / "init.mmf"))

"""The port's tnet CLI against the JAX tnet on a synthetic HTK corpus (CPU).

Same corpus (``nnet_asr_torch.tools.synth_corpus`` at a small shape),
transform (hamm_dct + bias/window normalisation), initial model and
options: the ``Xent:`` values agree within 1e-5 relative (f32
summation order over a few dozen SGD steps) and the written MMFs load
allclose (atol 1e-5).
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from nnet_asr_tpu.models.network import Network as JNetwork
from nnet_asr_tpu.tools import tnet as jtnet
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
    ("--COMPUTEDTYPE=bf16",), ("--CONFUSIONMODE=max",), ("-O", "mse"),
    ("--MESH=2x1",), ("--DISTRIBUTED=TRUE",), ("--COMPUTEDTYPE=int8pfsr",),
    ("--CONFUSIONMODE=soft",), ("--JAXPROFILE=trace",), ("--L1=0.001",),
])
def test_tnet_option_outside_slice_raises(corpus, extra):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttnet.main(_argv(corpus, corpus / "init.mmf", *extra), device="cpu")


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


def test_tnet_blocksoftmax_output_raises(corpus, tmp_path):
    text = (corpus / "init.mmf").read_text().replace(
        f"<softmax> {SHAPE.classes} {SHAPE.classes}",
        f"<blocksoftmax> {SHAPE.classes} {SHAPE.classes}\nv 2\n3 3")
    src = tmp_path / "block.mmf"
    src.write_text(text)
    with pytest.raises(NotImplementedError, match="<blocksoftmax>"):
        ttnet.main(_argv(corpus, src), device="cpu")


def test_tnet_needs_cuda_unless_cpu_is_named(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttnet.main(_argv(corpus, corpus / "init.mmf"))

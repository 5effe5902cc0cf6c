"""The port's newbob scheduler against the JAX scheduler, on the CPU.

Both drive three momentum epochs of their own package's tnet over the same
synthetic corpus (``nnet_asr_torch.tools.synth_corpus`` at a small shape)
through the shared ``run_newbob``. The accept, reject and halving
decisions must be the same, and the best models' MMFs allclose.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from nnet_asr_tpu.models.network import Network as JNetwork
from nnet_asr_tpu.tools import scheduler as jscheduler
from nnet_asr_tpu.train.trainer import TrainerConfig as JTrainerConfig
from nnet_asr_torch.tools import scheduler as tscheduler
from nnet_asr_torch.tools.synth_corpus import CorpusShape, make_corpus

torch.set_num_threads(2)

SHAPE = CorpusShape(feat_dim=5, ext=3, dct=4, hidden=24, classes=6, n_train=15,
                    n_cv=5, min_frames=20, max_frames=40)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    n = make_corpus(str(d), SHAPE, seed=21)
    assert n["train"] > 0 and n["cv"] > 0
    return d


def _argv(d, weights, *extra):
    return ["--nn-init", str(d / "init.mmf"), "--mlf-train", str(d / "labs.mlf"),
            "--mlf-cv", str(d / "labs.mlf"), "--scp-train", str(d / "train.scp"),
            "--scp-cv", str(d / "cv.scp"), "--phonelist", str(d / "map"),
            "--feature-transform", str(d / "transform"), f"--frm-ext={SHAPE.ext}",
            "--bunchsize=16", "--cachesize=64", "--weights-dir", str(weights), *extra]


DECISION = re.compile(r"^(accepting weights|reverting the weights.*|lrate=.*|"
                      r"Initial CV accuracy.*|Best model: .*)$", re.M)


def _run(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv, **kw) == 0
    out = buf.getvalue()
    best = re.search(r"Best model: (\S+) \(CV", out).group(1)
    return DECISION.findall(out), best


# learning rates (per-frame, divided by the bunch) where the decisions are:
# accept, accept + start halving, accept + halve; and accept, reject +
# start halving, accept + halve. Best models within atol 1e-4 after up to three
# epochs of f32 SGD with momentum 0.5 at these rates.
@pytest.mark.parametrize("learnrate,want", [
    ("8.0", ["accepting weights", "accepting weights", "lrate=4",
             "accepting weights", "lrate=2"]),
    ("10.0", ["accepting weights", "reverting the weights  71.52777778 < 72.22222222",
              "lrate=5", "accepting weights", "lrate=2.5"]),
])
def test_scheduler_momentum_newbob_matches_jax(corpus, tmp_path, learnrate, want):
    extra = ("--learnrate", learnrate, "--momentum=0.5", "--max-iter=3",
             "--start-halving-inc=10")
    jlog, jbest = _run(jscheduler.main, _argv(corpus, tmp_path / "jax", *extra))
    tlog, tbest = _run(tscheduler.main, _argv(corpus, tmp_path / "torch", *extra),
                       device="cpu")
    assert tlog[:-1] == jlog[:-1]                # every decision, then the best model
    assert [line for line in tlog if not line.startswith(("Initial", "Best"))] == want
    assert os.path.basename(tbest) == os.path.basename(jbest)
    assert os.path.dirname(tbest) == str(tmp_path / "torch")
    for a, b in zip(JNetwork.read(tbest).params, JNetwork.read(jbest).params):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-4, rtol=0)
    # the port's weights directory holds the same files as the JAX one
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))


# --compute-dtype=bf16 passed on as tnet --COMPUTEDTYPE: the same
# decisions and best model as the JAX scheduler, whose tnet takes its
# Pallas path here (the rounding the port's kernels follow; see
# test_torch_tnet.py). At learning rate 2 the bf16 trajectories stay
# together (at 8 and 10, as above, a bf16 rounding that flips between the
# two packages' f32 sums grows over the steps until the CV accuracies
# part); the best models within atol 1e-2 after three epochs
def test_scheduler_bf16_newbob_matches_jax(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(JTrainerConfig, "pallas_enabled", lambda self: True)
    extra = ("--learnrate", "2.0", "--momentum=0.5", "--max-iter=3",
             "--start-halving-inc=10", "--compute-dtype=bf16")
    jlog, jbest = _run(jscheduler.main, _argv(corpus, tmp_path / "jax", *extra))
    tlog, tbest = _run(tscheduler.main, _argv(corpus, tmp_path / "torch", *extra),
                       device="cpu")
    assert tlog[:-1] == jlog[:-1]
    assert [line for line in tlog if not line.startswith(("Initial", "Best"))] == [
        "accepting weights", "accepting weights", "lrate=1", "accepting weights", "lrate=0.5"]
    assert os.path.basename(tbest) == os.path.basename(jbest)
    for a, b in zip(JNetwork.read(tbest).params, JNetwork.read(jbest).params):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-2, rtol=0)


# --mesh=1x1 with no launcher (a one-rank group formed in this process):
# streaming passes --MESH=1x1 to tnet, --resident keeps the stacks on the
# mesh; at momentum 0 both write the weight files of the single-device
# scheduler byte for byte. A mesh of more ranks needs a launcher.
@pytest.mark.parametrize("extra", [("--mesh=1x1",), ("--resident", "--mesh=1x1")],
                         ids=["streaming", "resident"])
def test_scheduler_mesh_1x1_matches_single_device(corpus, tmp_path, extra):
    base = ("--learnrate", "8.0", "--max-iter=2")
    _, single = _run(tscheduler.main, _argv(corpus, tmp_path / "single", *base),
                     device="cpu")
    log, best = _run(tscheduler.main, _argv(corpus, tmp_path / "mesh", *base, *extra),
                     device="cpu")
    assert os.path.basename(best) == os.path.basename(single)
    names = sorted(os.listdir(tmp_path / "single"))
    assert names == sorted(os.listdir(tmp_path / "mesh"))
    for n in names:
        assert (tmp_path / "mesh" / n).read_bytes() == (tmp_path / "single" / n).read_bytes()
    with pytest.raises(ValueError, match="mesh 2x1 needs more than 1 devices"):
        tscheduler.main(_argv(corpus, tmp_path / "w", "--mesh=2x1", *extra[:-1]),
                        device="cpu")


def test_scheduler_requires_its_inputs(tmp_path):
    with pytest.raises(SystemExit, match="--nn-init"):
        tscheduler.main(["--weights-dir", str(tmp_path)], device="cpu")


def test_scheduler_needs_cuda_unless_cpu_is_named(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tscheduler.main(_argv(corpus, tmp_path / "w", "--max-iter=1"))

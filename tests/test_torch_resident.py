"""The port's resident newbob (``scheduler --resident``) on the CPU.

On the corpus of ``tests/test_resident.py`` (6 -> 8 -> 4, bunch 32, cache
128, momentum 0.4, 4 newbob iterations; learning rate 8, where all four
iterations run, with two halvings, where that test's 0.5 stops after two
as the CV accuracy does not move), the port's resident mode must
reproduce the port's streaming mode exactly (the same history and
byte-identical weight files) under f32, bf16 and int8pfsr, and with a
device-memory budget that parks stacks on the host; and it must take the
JAX package's resident run's decisions, with best models within 1e-4.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from nnet_asr_torch.io import htk
from nnet_asr_torch.io.mlf import MlfWriter
from nnet_asr_torch.tools import gen_mlp_init
from nnet_asr_torch.tools import scheduler as tscheduler
from nnet_asr_tpu.models.network import Network as JNetwork
from nnet_asr_tpu.tools import scheduler as jscheduler

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_resident.py's corpus, written by the port's host tools."""
    tmp = tmp_path_factory.mktemp("resident")
    rng = np.random.default_rng(0)
    dim, n_out = 6, 4
    (tmp / "phones.map").write_text("\n".join(f"p{i}" for i in range(n_out)))
    mlf = MlfWriter(str(tmp / "labels.mlf"))
    train_lines, cv_lines = [], []
    for u in range(14):
        T = int(rng.integers(30, 70))
        labels = rng.integers(0, n_out, T)
        feats = (np.eye(dim, dtype=np.float32)[labels % dim] * 2.0
                 + 0.3 * rng.standard_normal((T, dim)).astype(np.float32))
        p = str(tmp / f"u{u}.fea")
        htk.write_htk_file(p, feats, htk.PARMKIND_USER)
        mlf.write_record(f"*/u{u}.lab", [f"{t * 100000} {(t + 1) * 100000} p{l}"
                                         for t, l in enumerate(labels)])
        (train_lines if u < 10 else cv_lines).append(p)
    mlf.close()
    (tmp / "train.scp").write_text("\n".join(train_lines) + "\n")
    (tmp / "cv.scp").write_text("\n".join(cv_lines) + "\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gen_mlp_init.main([f"--dim={dim}:8:{n_out}", "--gauss", "--negbias", "--seed=5"])
    (tmp / "init.mmf").write_text(buf.getvalue())
    return tmp


def _argv(tmp, weights_dir, *extra):
    return ["--nn-init=" + str(tmp / "init.mmf"),
            "--mlf-train=" + str(tmp / "labels.mlf"),
            "--mlf-cv=" + str(tmp / "labels.mlf"),
            "--scp-train=" + str(tmp / "train.scp"),
            "--scp-cv=" + str(tmp / "cv.scp"),
            "--phonelist=" + str(tmp / "phones.map"),
            "--learnrate=8", "--bunchsize=32", "--cachesize=128",
            "--max-iter=4", "--momentum=0.4", "--weightcost=1e-5",
            "--weights-dir=" + str(weights_dir), *extra]


def _run(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv, **kw) == 0
    return buf.getvalue()


def _history(out):
    return re.findall(r"(TR|CV) accuracy:\s*([\d.]+) iter: (\d+)", out)


def _decisions(out):
    return re.findall(r"^(accepting weights|reverting the weights.*|lrate=.*)$", out, re.M)


def _best(out):
    return re.search(r"Best model: (\S+) \(CV", out).group(1)


def _assert_same_weights(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b))
    for n in names:
        assert (dir_a / n).read_bytes() == (dir_b / n).read_bytes(), f"weights differ: {n}"


@pytest.mark.parametrize("dtype", [(), ("--compute-dtype=bf16",),
                                   ("--compute-dtype=int8pfsr",)],
                         ids=["f32", "bf16", "int8pfsr"])
def test_resident_matches_streaming(corpus, tmp_path, dtype):
    out_s = _run(tscheduler.main, _argv(corpus, tmp_path / "w_stream", *dtype), device="cpu")
    out_r = _run(tscheduler.main, _argv(corpus, tmp_path / "w_res", "--resident", *dtype),
                 device="cpu")
    assert len(_history(out_r)) == 8
    assert _history(out_r) == _history(out_s)
    assert _decisions(out_r) == _decisions(out_s)
    assert os.path.basename(_best(out_r)) == os.path.basename(_best(out_s))
    _assert_same_weights(tmp_path / "w_stream", tmp_path / "w_res")


def test_resident_matches_jax_resident(corpus, tmp_path):
    out_j = _run(jscheduler.main, _argv(corpus, tmp_path / "jax", "--resident"))
    out_t = _run(tscheduler.main, _argv(corpus, tmp_path / "torch", "--resident"),
                 device="cpu")
    assert _decisions(out_t) == _decisions(out_j)
    assert re.findall(r"Initial CV accuracy: (\S+)", out_t) == \
        re.findall(r"Initial CV accuracy: (\S+)", out_j)
    best_t, best_j = _best(out_t), _best(out_j)
    assert os.path.basename(best_t) == os.path.basename(best_j)
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    for a, b in zip(JNetwork.read(best_t).params, JNetwork.read(best_j).params):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-4, rtol=0)


def test_resident_budget_parks_stacks_with_the_same_result(corpus, tmp_path):
    """A budget of 0.004 MiB holds one 128x6 stack; the rest park on the
    host and are copied to the device per epoch: the same trajectory."""
    out_full = _run(tscheduler.main, _argv(corpus, tmp_path / "w_full", "--resident"),
                    device="cpu")
    out_part = _run(tscheduler.main, _argv(corpus, tmp_path / "w_part", "--resident",
                                           "--hbm-budget-mb=0.004"), device="cpu")
    assert "host-parked" in out_part and "host-parked" not in out_full
    parked = re.search(r"(\d+) bytes resident, (\d+) bytes host-parked", out_part)
    assert 0 < int(parked.group(1)) <= 0.004 * 1024 * 1024 < int(parked.group(2))
    assert _history(out_part) == _history(out_full)
    _assert_same_weights(tmp_path / "w_full", tmp_path / "w_part")


def test_resident_done_lines(corpus, tmp_path):
    """Each epoch and CV prints its Done line marked (resident), with the
    frames the intake read; no tnet runs."""
    out = _run(tscheduler.main, _argv(corpus, tmp_path / "w", "--resident",
                                      "--max-iter=1"), device="cpu")
    done = re.findall(r"^Done (\d+) frames in \S+s \[FPS:\S+,RT:\S+\] \(resident\)$",
                      out, re.M)
    assert len(done) == 3                       # CV, epoch, CV
    assert done[0] == done[2] and int(done[1]) > int(done[0]) > 0
    assert "TNET" not in out


def test_resident_mesh_1x1_matches_resident(corpus, tmp_path):
    """ResidentNewbob on a one-rank mesh (formed in this process, no
    launcher), under a budget that parks stacks on the host: the history
    and weight files of the plain resident run at momentum 0, byte for
    byte; the mesh's Done lines say so."""
    base = ("--resident", "--momentum=0")
    out_r = _run(tscheduler.main, _argv(corpus, tmp_path / "w_res", *base), device="cpu")
    out_m = _run(tscheduler.main, _argv(corpus, tmp_path / "w_mesh", *base, "--mesh=1x1",
                                        "--hbm-budget-mb=0.004"), device="cpu")
    assert "(resident, mesh)" in out_m and "host-parked" in out_m
    assert _history(out_m) == _history(out_r)
    _assert_same_weights(tmp_path / "w_res", tmp_path / "w_mesh")


def test_resident_needs_cuda_unless_cpu_is_named(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tscheduler.main(_argv(corpus, tmp_path / "w", "--resident", "--max-iter=1"))

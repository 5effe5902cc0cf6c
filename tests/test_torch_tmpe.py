"""The port's ``tmpe`` (``main(argv, device="cpu")``) against the JAX
package's ``tmpe.main`` on the same files.

Each run writes its MMF, which must match JAX's within rtol 1e-4 and atol
1e-5; the ``Avg MPE accuracy`` line within 1e-5 with the same utterance
count; and the same set of skipped files. The fixture is the mini task
of tests/test_tmpe_tool.py (1-state phone HMMs, two-arc-per-segment
lattices), rebuilt here; a second one is a phone-structured corpus from
``tools/synth_corpus.py`` (3-state HMMs from ``gen_gmmbypass``, its
seeded phone lattices, the hamm_dct transform).
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from nnet_asr_torch.io import htk
from nnet_asr_torch.io.htk_hmm import parse_mmf
from nnet_asr_torch.io.mlf import MlfWriter
from nnet_asr_torch.io.slf import Lattice, LatticeArc, LatticeNode, read_slf, write_slf
from nnet_asr_torch.models import components as TC
from nnet_asr_torch.models.network import Network
from nnet_asr_torch.tools import gen_gmmbypass
from nnet_asr_torch.tools import tmpe as ttmpe
from nnet_asr_torch.tools.synth_corpus import CorpusShape, make_corpus, write_phone_lattices
from nnet_asr_torch.train import mpe as tmpe_mod
from nnet_asr_tpu.tools import tmpe as jtmpe
from nnet_asr_tpu.train import mpe as jmpe_mod

torch.set_num_threads(2)

PHONES = ["a", "b", "c"]


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """6 utterances of 20 frames, 2 phone segments of 10 each; per
    segment the correct phone and one competitor in the lattice; a
    weak random 8->16->3 MLP."""
    tmp = tmp_path_factory.mktemp("mpe")
    rng = np.random.default_rng(0)
    dim = 8
    (tmp / "phones.map").write_text("\n".join(f"{p}_s2" for p in PHONES))
    with open(tmp / "hmms.mmf", "w") as f:
        f.write('~o <STREAMINFO> 1 8 <VECSIZE> 8 <USER>\n')
        for p in PHONES:
            f.write(f'~h "{p}"\n<BEGINHMM>\n<NUMSTATES> 3\n<STATE> 2\n'
                    f'~s "{p}_s2"\n<TRANSP> 3\n'
                    ' 0.0 1.0 0.0\n 0.0 0.7 0.3\n 0.0 0.0 0.0\n<ENDHMM>\n')
    mlf = MlfWriter(str(tmp / "labels.mlf"))
    os.makedirs(tmp / "feats")
    os.makedirs(tmp / "lats")
    scp = []
    for u in range(6):
        seq = rng.permutation(3)[:2]
        feats = np.zeros((20, dim), np.float32)
        for seg, ph in enumerate(seq):
            feats[seg * 10:(seg + 1) * 10, ph] = 1.5
        feats += 0.2 * rng.standard_normal(feats.shape).astype(np.float32)
        name = f"u{u}"
        htk.write_htk_file(str(tmp / "feats" / f"{name}.fea"), feats, htk.PARMKIND_USER)
        mlf.write_record(f"*/{name}.lab", [
            f"{seg * 10 * 100000} {(seg + 1) * 10 * 100000} {PHONES[ph]}_s2"
            for seg, ph in enumerate(seq)])
        lat = Lattice(nodes=[LatticeNode(time=0.0), LatticeNode(time=0.1),
                             LatticeNode(time=0.2)])
        for seg, ph in enumerate(seq):
            lat.arcs.append(LatticeArc(seg, seg + 1, PHONES[ph], lm=0.0))
            lat.arcs.append(LatticeArc(seg, seg + 1, PHONES[(ph + 1) % 3], lm=0.0))
        with open(tmp / "lats" / f"{name}.lat", "w") as f:
            write_slf(lat, f)
        scp.append(str(tmp / "feats" / f"{name}.fea"))
    mlf.close()
    (tmp / "train.scp").write_text("\n".join(scp) + "\n")
    rng2 = np.random.default_rng(1)
    net = Network([TC.BiasedLinearity(dim, 16), TC.Sigmoid(16, 16),
                   TC.BiasedLinearity(16, 3), TC.Softmax(3, 3)])
    net.from_numpy_params([
        {"weight": (0.2 * rng2.standard_normal((dim, 16))).astype(np.float32),
         "bias": np.zeros(16, np.float32)}, {},
        {"weight": (0.2 * rng2.standard_normal((16, 3))).astype(np.float32),
         "bias": np.zeros(3, np.float32)}, {}])
    net.write(str(tmp / "init.mmf"))
    # word lattices over the same utterances: one arc across both segments
    # per (segment-1 phone, segment-2 phone) pair of the phone lattice,
    # each word pronounced by its two phones or, as a second variant, with
    # the second phone twice
    os.makedirs(tmp / "wordlats")
    for u in range(6):
        lat = read_slf(str(tmp / "lats" / f"u{u}.lat"))
        first = [a.word for a in lat.arcs if a.start == 0]
        second = [a.word for a in lat.arcs if a.start == 1]
        lat.arcs = [LatticeArc(0, 2, (x + y).upper(), lm=-0.5 * k)
                    for k, (x, y) in enumerate((x, y) for x in first for y in second)]
        with open(tmp / "wordlats" / f"u{u}.lat", "w") as f:
            write_slf(lat, f)
    (tmp / "words.dic").write_text("".join(
        f"{(x + y).upper()} {x} {y}\n{(x + y).upper()} 0.5 {x} {y} {y}\n"
        for x in PHONES for y in PHONES))
    return tmp


def _common(tmp, lats="lats"):
    return ["-I", str(tmp / "labels.mlf"), "-L", "*/", "-X", "lab",
            "-m", str(tmp / "phones.map"), "-S", str(tmp / "train.scp"),
            "--HMM=" + str(tmp / "hmms.mmf"), "--LATTICEDIR=" + str(tmp / lats)]


def _run(main, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(argv, **kw) == 0
    out, err = out.getvalue(), err.getvalue()
    acc = re.search(r"Avg MPE accuracy: (\S+) utts: (\d+)", out)
    assert acc is not None, out
    assert re.search(r"T-read: \S+s T-fwd: \S+s T-decode: \S+s T-update: \S+s", out), out
    return {"acc": float(acc.group(1)), "utts": int(acc.group(2)), "out": out,
            "skipped": set(re.findall(r"skipping file (\S+)", err)), "err": err}


def _compare(d, argv, crossval=False):
    """Run JAX's tmpe and the port's on ``argv``; hold the results."""
    got = {}
    for name, main, kw in (("jax", jtmpe.main, {}), ("torch", ttmpe.main, {"device": "cpu"})):
        target = [] if crossval else ["--TARGETMMF=" + str(d / f"{name}.mmf")]
        got[name] = _run(main, ["tmpe"] + argv + target, **kw)
    j, t = got["jax"], got["torch"]
    assert t["acc"] == pytest.approx(j["acc"], abs=1e-5)
    assert t["utts"] == j["utts"] and t["skipped"] == j["skipped"]
    if crossval:
        assert not (d / "torch.mmf").exists()
    else:
        jp = Network.read(str(d / "jax.mmf")).to_numpy_params()
        tp = Network.read(str(d / "torch.mmf")).to_numpy_params()
        for a, b in zip(tp, jp):
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5)
    return j, t


TRAIN = ["--OUTPSCALE=1.0", "--LEARNINGRATE=2.0"]
CASES = {
    "train": TRAIN,
    "crossvalidate": ["-c", "--LOOKAHEAD=2"],
    "crossvalidate_fbworkers": ["-c", "--FBWORKERS=2"],
    "mmi": ["--MMI=TRUE", "--LEARNINGRATE=1.0"],
    "delayed_update": TRAIN + ["--DELAYEDUPDATE=TRUE"],
    "mlgamma_nframeoutpnorm": TRAIN + ["--MLGAMMA=TRUE", "--NFRAMEOUTPNORM=TRUE",
                                       "--GRADDIVFRM=FALSE", "--LEARNINGRATE=0.1"],
    "device_engine": TRAIN + ["--MPEENGINE=jax"],
    "numpy_engine_showgamma": TRAIN + ["--MPEENGINE=numpy", "--SHOWGAMMA=TRUE"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tmpe_matches_jax(mini, tmp_path, case):
    argv = ["-H", str(mini / "init.mmf")] + _common(mini) + CASES[case]
    j, t = _compare(tmp_path, argv, crossval="-c" in CASES[case])
    if "--SHOWGAMMA=TRUE" in CASES[case]:
        want = re.findall(r"\S+: avgAcc \S+", j["out"])
        assert re.findall(r"\S+: avgAcc \S+", t["out"]) == want and len(want) == 6
    if "-c" not in CASES[case]:
        moved = Network.read(str(tmp_path / "torch.mmf")).to_numpy_params()[0]["weight"]
        init = Network.read(str(mini / "init.mmf")).to_numpy_params()[0]["weight"]
        assert np.abs(moved - init).max() > 1e-4           # the update happened


@pytest.mark.parametrize("exact", [False, True], ids=["map", "exact"])
def test_tmpe_word_lattices_match_jax(mini, tmp_path, exact):
    """--SOURCEDICT expands two-phone words (two variants each) into timed
    phone chains: MAP Viterbi boundaries, or every segmentation."""
    argv = (["-H", str(mini / "init.mmf")] + _common(mini, "wordlats") + TRAIN
            + ["--SOURCEDICT=" + str(mini / "words.dic")]
            + (["--EXACTSEGMENTATION=TRUE"] if exact else []))
    _compare(tmp_path, argv)


def _flaky(monkeypatch, fail):
    """Make each package's MpeComputer.compute raise FloatingPointError on
    the calls ``fail`` picks (by call number); returns the pruning
    thresholds each package's calls saw."""
    seen = {}
    for name, mod in (("jax", jmpe_mod), ("torch", tmpe_mod)):
        calls = seen[name] = []
        real = mod.MpeComputer.compute

        def compute(self, lat, log_post, ref, utt_weight=1.0, frame_weights=None,
                    pruning=None, real=real, calls=calls):
            calls.append(pruning)
            if fail(len(calls)):
                raise FloatingPointError("forced underflow")
            return real(self, lat, log_post, ref, utt_weight, frame_weights, pruning)

        monkeypatch.setattr(mod.MpeComputer, "compute", compute)
    return seen


@pytest.mark.parametrize("beams,fail,skipped", [
    (("100", "50", "250"), lambda n: n <= 2, set()),       # widened twice, then through
    (("100", "50", "150"), lambda n: n <= 2, {"u0"}),      # beam exhausted: file skipped
], ids=["retry", "exhaustion"])
def test_tmpe_pruning_retry_matches_jax(mini, tmp_path, monkeypatch, beams, fail, skipped):
    seen = _flaky(monkeypatch, fail)
    argv = ["-H", str(mini / "init.mmf"), "-t", *beams] + _common(mini) + TRAIN
    j, t = _compare(tmp_path, argv)
    assert seen["torch"] == seen["jax"]
    assert {os.path.splitext(os.path.basename(f))[0] for f in t["skipped"]} == skipped
    assert t["utts"] == 6 - len(skipped)
    assert "trying pruning threshold: 150" in t["err"]


@pytest.fixture(scope="module")
def phone_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("phone_corpus")
    shape = CorpusShape(feat_dim=5, ext=2, dct=3, hidden=16, classes=12, phones=4,
                        n_train=4, n_cv=2, min_frames=30, max_frames=40)
    n = make_corpus(str(d), shape, seed=5)
    counts = write_phone_lattices(str(d), seed=5)
    with contextlib.redirect_stdout(io.StringIO()):
        gen_gmmbypass.main([str(d / "map"), str(d / "hmms.mmf"), "--state-sep=_s"])
    return d, shape, n, counts


def test_phone_corpus_and_lattices(phone_corpus):
    """Tags pK_s2..pK_s4 in order within each phone; per phone segment the
    reference arc and 3 competitors, one arc across each adjacent pair,
    every arc at least 3 frames, LM scores in [-4, 0]."""
    d, shape, n, counts = phone_corpus
    tags = (d / "map").read_text().split()
    assert tags[:4] == ["p0_s2", "p0_s3", "p0_s4", "p1_s2"] and len(tags) == 12
    hmms = parse_mmf(str(d / "hmms.mmf"))
    assert sorted(hmms) == ["p0", "p1", "p2", "p3"]
    assert all(h.n_emitting == 3 for h in hmms.values())
    assert counts["lattices"] == shape.n_train + shape.n_cv
    total = 0
    for name in sorted(os.listdir(d / "lats")):
        lat = read_slf(str(d / "lats" / name))
        frames = [round(nd.time * 100) for nd in lat.nodes]
        k = len(lat.nodes) - 1
        assert len(lat.arcs) == 4 * k + (k - 1)
        assert all(frames[a.end] - frames[a.start] >= 3 for a in lat.arcs)
        assert all(-4.0 <= a.lm <= 0.0 for a in lat.arcs)
        for seg in range(k):
            on = [a.word for a in lat.arcs if (a.start, a.end) == (seg, seg + 1)]
            assert len(set(on)) == 4
        total += len(lat.arcs)
    assert total == counts["arcs"]
    assert n["train"] >= shape.n_train * shape.min_frames


@pytest.mark.parametrize("extra", [["--LEARNINGRATE=0.5"], ["-c"]], ids=["train", "cv"])
def test_tmpe_phone_corpus_matches_jax(phone_corpus, tmp_path, extra):
    """3-state HMMs, the hamm_dct transform, the native engine."""
    d = phone_corpus[0]
    argv = ["-H", str(d / "init.mmf"), "-I", str(d / "labs.mlf"), "-L", "*/", "-X", "lab",
            "-m", str(d / "map"), "-S", str(d / "train.scp"), "--HMM=" + str(d / "hmms.mmf"),
            "--LATTICEDIR=" + str(d / "lats"), "--FEATURETRANSFORM=" + str(d / "transform"),
            "--STARTFRMEXT=2", "--ENDFRMEXT=2", "--OUTPSCALE=0.3", "--MPEENGINE=native"] + extra
    _compare(tmp_path, argv, crossval="-c" in extra)


def test_tmpe_mesh_is_not_ported(mini):
    with pytest.raises(NotImplementedError, match="--MESH .*queue 1 item 14"):
        ttmpe.main(["tmpe", "-H", str(mini / "init.mmf"), "--MESH=8x1"] + _common(mini),
                   device="cpu")


def test_tmpe_runs_on_the_card_unless_told_otherwise(mini):
    """No device argument: --GPUSELECT's card, and no quiet CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU refusal cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttmpe.main(["tmpe", "-H", str(mini / "init.mmf")] + _common(mini))

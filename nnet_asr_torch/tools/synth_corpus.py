"""A synthetic, example-01-shaped training corpus made from a seed.

example-01's data (TIMIT-style HTK features with 135 state labels) is not
part of the repository, so the port's checks build a stand-in with the same
shapes: HTK feature files of ``feat_dim`` coefficients whose frames are a
class-dependent mean plus unit Gaussian noise, state segments of 3-12
frames, an MLF over them, a label map, scripts for a training and a
cross-validation part, example-01's transform (``generators hamm_dct``
followed by a ``<bias>``/``<window>`` normalisation to the data's mean and
standard deviation, as in its ``Hamm_dct_norm``) and a ``gen_mlp_init``
initial model. Files are written with the port's own host tools (HTK,
MLF, SLF and the generators).

``TIMIT`` is the shape of the TIMIT-scale recipe
(``examples/run_timit_scale.sh``: example-02's MLP3 368:500:39 at FRM_EXT
15 and DCT 16, TIMIT's 4620 training utterances, ~1.11M frames); its
recipe makes the transform itself (``generators hamm_dct`` and ``tnorm``),
so ``make_corpus(..., transform=False)`` leaves it out.

For sequence training, ``CorpusShape(phones=P)`` makes the labels
phone-structured (P phones of 3 states, tags ``pK_s2..pK_s4``, the three
states in order within each phone, no phone twice in a row), and
``write_phone_lattices`` writes a seeded SLF phone lattice per utterance
around its reference phone segmentation.
"""

from __future__ import annotations

import contextlib
import io
import os
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..io import htk
from ..io.mlf import MlfReader, MlfWriter
from ..io.slf import Lattice, LatticeArc, LatticeNode, write_slf
from ..tools import gen_mlp_init, generators

from ..models.network import Network


@dataclass(frozen=True)
class CorpusShape:
    feat_dim: int = 23          # example-01: 23 filter-bank energies
    ext: int = 25               # 51-frame context (STARTFRMEXT = ENDFRMEXT)
    dct: int = 26               # DCT bases per band: 23 * 26 = 598 inputs
    hidden: int = 1024
    classes: int = 135
    n_train: int = 120
    n_cv: int = 24
    min_frames: int = 250
    max_frames: int = 350
    # > 0: phone-structured labels, classes == 3 * phones; state segments
    # of 1-4 frames, and each utterance ends at the end of a phone (its
    # length may pass max_frames by up to a phone)
    phones: int = 0

    def tag(self, c: int) -> str:
        """The label-map tag of class ``c``."""
        return f"p{c // 3}_s{c % 3 + 2}" if self.phones else f"s{c}"


# examples/run_timit_scale.sh:28-35 and examples/prepare_timit_scale.py:20:
# 23 filter-bank energies, 31-frame context, 16 DCT bases (368 inputs), 500
# hidden units, TIMIT's 39 folded phones; 4620 + 200 utterances of 160-320
# frames (240 on average: 4620 x 240 = 1.11M training frames)
TIMIT = CorpusShape(feat_dim=23, ext=15, dct=16, hidden=500, classes=39, n_train=4620,
                    n_cv=200, min_frames=160, max_frames=320)


def _stdout_of(fn, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def _phone_segments(rng, min_frames: int, phones: int):
    """(state segment ends, state classes) of whole phones covering at
    least ``min_frames`` frames: each phone's three states in order, 1-4
    frames each, and a phone never follows itself."""
    ends, states = [], []
    p, t = int(rng.integers(0, phones)), 0
    while t < min_frames:
        for j, n in enumerate(rng.integers(1, 5, 3)):
            t += int(n)
            ends.append(t)
            states.append(3 * p + j)
        p = (p + int(rng.integers(1, phones))) % phones
    return np.asarray(ends), np.asarray(states)


def make_corpus(d: str, shape: CorpusShape = CorpusShape(), seed: int = 123,
                transform: bool = True) -> Dict[str, int]:
    """Write the corpus into directory ``d``: ``labs.mlf``, ``map``,
    ``train.scp``, ``cv.scp``, ``init.mmf`` and, with ``transform``,
    ``transform``. Returns the frame count of each part."""
    s = shape
    if s.phones and (s.phones < 2 or s.classes != 3 * s.phones):
        raise ValueError(f"phones={s.phones} needs at least 2 phones and classes == 3 * phones, "
                         f"got classes={s.classes}")
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((s.classes, s.feat_dim)).astype(np.float32)
    mlf = MlfWriter(os.path.join(d, "labs.mlf"))
    scps = {"train": [], "cv": []}
    n_frames = {"train": 0, "cv": 0}
    train_feats = []
    for u in range(s.n_train + s.n_cv):
        part = "train" if u < s.n_train else "cv"
        T = int(rng.integers(s.min_frames, s.max_frames + 1))
        if s.phones:
            ends, states = _phone_segments(rng, T, s.phones)
            T = int(ends[-1])
        else:
            ends = np.minimum(np.cumsum(rng.integers(3, 13, T)), T)
            ends = ends[:np.searchsorted(ends, T) + 1]     # segments ending at T
            states = rng.integers(0, s.classes, len(ends))
        begs = np.concatenate([[0], ends[:-1]])
        x = (means[np.repeat(states, ends - begs)]
             + rng.standard_normal((T, s.feat_dim)).astype(np.float32))
        path = os.path.join(d, f"u{u:03d}.fea")
        htk.write_htk_file(path, x, htk.PARMKIND_USER)
        mlf.write_record(f"*/u{u:03d}.lab", [
            f"{b * 100000} {e * 100000} {s.tag(c)}" for b, e, c in zip(begs, ends, states)])
        scps[part].append(path)
        n_frames[part] += T
        if part == "train" and transform:
            train_feats.append(x)
    mlf.close()
    with open(os.path.join(d, "map"), "w") as f:
        f.write(" ".join(s.tag(i) for i in range(s.classes)) + "\n")
    for part, paths in scps.items():
        with open(os.path.join(d, f"{part}.scp"), "w") as f:
            f.write("".join(p + "\n" for p in paths))

    dim = s.feat_dim * s.dct
    with open(os.path.join(d, "init.mmf"), "w") as f:
        f.write(_stdout_of(gen_mlp_init.main, [
            f"--dim={dim}:{s.hidden}:{s.classes}", "--gauss", "--negbias",
            f"--seed={seed}"]))
    if not transform:
        return n_frames
    hamm = _stdout_of(generators.main, [
        "hamm_dct", f"--dimIn={s.feat_dim}", f"--startFrmExt={s.ext}",
        f"--endFrmExt={s.ext}", f"--dctBaseCnt={s.dct}"])
    net = Network.read(hamm)
    with torch.no_grad():
        ys = np.concatenate([net(torch.from_numpy(x)).numpy()
                             for x in train_feats]).astype(np.float64)
    with open(os.path.join(d, "transform"), "w") as f:
        f.write(hamm)
        f.write(f"<bias> {dim} {dim}\nv {dim}\n"
                + " ".join(repr(float(v)) for v in -ys.mean(0)) + "\n")
        f.write(f"<window> {dim} {dim}\nv {dim}\n"
                + " ".join(repr(float(v)) for v in 1.0 / ys.std(0)) + "\n")
    return n_frames


def write_phone_lattices(d: str, seed: int = 123, competitors: int = 3) -> Dict[str, int]:
    """Write ``lats/<utt>.lat`` for every utterance of a phone-structured
    corpus in ``d``: one node at each reference phone boundary; for each
    reference phone segment the reference arc plus ``competitors`` other
    phones on the same nodes, and one arc of a random phone across each
    pair of adjacent segments. Every arc spans at least one whole phone
    (3 frames or more); LM scores are uniform in [-4, 0]. Returns the
    counts of lattices and arcs."""
    rng = np.random.default_rng(seed)
    with open(os.path.join(d, "map")) as f:
        names = list(dict.fromkeys(t.rsplit("_s", 1)[0] for t in f.read().split()))
    os.makedirs(os.path.join(d, "lats"), exist_ok=True)
    mlf = MlfReader(os.path.join(d, "labs.mlf"))
    recs = sorted(mlf.names())
    n_arcs = 0
    for rec in recs:
        segs = []                       # (start frame, end frame, phone)
        for b, e, tag in mlf.read_intervals(rec):
            phone, state = tag.rsplit("_s", 1)
            if state == "2":
                segs.append([b // 100000, e // 100000, phone])
            else:
                segs[-1][1] = e // 100000
        lat = Lattice(nodes=[LatticeNode(time=t / 100.0)
                             for t in [segs[0][0]] + [e for _, e, _ in segs]])
        for k, (_, _, phone) in enumerate(segs):
            others = [p for p in names if p != phone]
            for p in [phone] + list(rng.choice(others, competitors, replace=False)):
                lat.arcs.append(LatticeArc(k, k + 1, str(p), lm=float(rng.uniform(-4, 0))))
            if k + 1 < len(segs):
                lat.arcs.append(LatticeArc(k, k + 2, str(rng.choice(names)),
                                           lm=float(rng.uniform(-4, 0))))
        base = os.path.splitext(os.path.basename(rec))[0]
        with open(os.path.join(d, "lats", f"{base}.lat"), "w") as f:
            write_slf(lat, f)
        n_arcs += len(lat.arcs)
    mlf.close()
    return {"lattices": len(recs), "arcs": n_arcs}

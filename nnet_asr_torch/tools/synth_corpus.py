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
MLF and the generators).
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
from ..io.mlf import MlfWriter
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


def _stdout_of(fn, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def make_corpus(d: str, shape: CorpusShape = CorpusShape(), seed: int = 123) -> Dict[str, int]:
    """Write the corpus into directory ``d``: ``labs.mlf``, ``map``,
    ``train.scp``, ``cv.scp``, ``transform`` and ``init.mmf``. Returns the
    frame count of each part."""
    s = shape
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((s.classes, s.feat_dim)).astype(np.float32)
    mlf = MlfWriter(os.path.join(d, "labs.mlf"))
    scps = {"train": [], "cv": []}
    n_frames = {"train": 0, "cv": 0}
    train_feats = []
    for u in range(s.n_train + s.n_cv):
        part = "train" if u < s.n_train else "cv"
        T = int(rng.integers(s.min_frames, s.max_frames + 1))
        ends = np.minimum(np.cumsum(rng.integers(3, 13, T)), T)
        ends = ends[:np.searchsorted(ends, T) + 1]     # segments ending at T
        states = rng.integers(0, s.classes, len(ends))
        begs = np.concatenate([[0], ends[:-1]])
        x = (means[np.repeat(states, ends - begs)]
             + rng.standard_normal((T, s.feat_dim)).astype(np.float32))
        path = os.path.join(d, f"u{u:03d}.fea")
        htk.write_htk_file(path, x, htk.PARMKIND_USER)
        mlf.write_record(f"*/u{u:03d}.lab", [
            f"{b * 100000} {e * 100000} s{c}" for b, e, c in zip(begs, ends, states)])
        scps[part].append(path)
        n_frames[part] += T
        if part == "train":
            train_feats.append(x)
    mlf.close()
    with open(os.path.join(d, "map"), "w") as f:
        f.write(" ".join(f"s{i}" for i in range(s.classes)) + "\n")
    for part, paths in scps.items():
        with open(os.path.join(d, f"{part}.scp"), "w") as f:
            f.write("".join(p + "\n" for p in paths))

    hamm = _stdout_of(generators.main, [
        "hamm_dct", f"--dimIn={s.feat_dim}", f"--startFrmExt={s.ext}",
        f"--endFrmExt={s.ext}", f"--dctBaseCnt={s.dct}"])
    net = Network.read(hamm)
    with torch.no_grad():
        ys = np.concatenate([net(torch.from_numpy(x)).numpy()
                             for x in train_feats]).astype(np.float64)
    dim = s.feat_dim * s.dct
    with open(os.path.join(d, "transform"), "w") as f:
        f.write(hamm)
        f.write(f"<bias> {dim} {dim}\nv {dim}\n"
                + " ".join(repr(float(v)) for v in -ys.mean(0)) + "\n")
        f.write(f"<window> {dim} {dim}\nv {dim}\n"
                + " ".join(repr(float(v)) for v in 1.0 / ys.std(0)) + "\n")
    with open(os.path.join(d, "init.mmf"), "w") as f:
        f.write(_stdout_of(gen_mlp_init.main, [
            f"--dim={dim}:{s.hidden}:{s.classes}", "--gauss", "--negbias",
            f"--seed={seed}"]))
    return n_frames

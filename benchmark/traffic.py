"""The one generator every traffic mix is read by: the weights and the
training data of a cell, made from ``--seed``.

A mix is a JSON file of parameters (``traffic/<name>.json``) whose
``kind`` says what is made:

- ``resident``: ``stacks`` stacks of ``stack_bunches`` bunches of unit
  Gaussian feature rows (the configuration's input width, as the global
  normalization leaves them) and uniform labels, made on the device and
  held there, as resident newbob holds its stacks.
- ``stream``: a corpus of HTK feature files written to a directory, an
  MLF of state segments, an SCP, a label map and the front end's
  transform file: ``utterances`` utterances of ``min_frames`` ..
  ``max_frames`` frames of the configuration's bands, each frame a class
  mean plus unit Gaussian noise, over segments of ``segment_frames``
  frames, each of a uniform class. The transform's global normalization
  is the mean and deviation of the first ``norm_utterances`` utterances.

Weights follow the production recipe: ``std`` · N(0, 1) matrices and
zero biases, made on the device in one call.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from .reference import frontend

HERE = os.path.dirname(os.path.abspath(__file__))
PARMKIND_USER, SAMPLE_PERIOD = 9, 100000     # HTK's USER kind, 10 ms frames


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one part of a run, from ``--seed`` and a tag."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def cache_seed(seed: int) -> int:
    """The cache shuffle's srand48 seed: nonzero, 31 bits."""
    return 1 + sub_seed(seed, "shuffle") % (2 ** 31 - 2)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def weights(cfg: dict, seed: int, device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(W (in, out), b) of every layer, from the seed, on ``device``."""
    dims = cfg["dims"]
    init = cfg["weight_init"]
    sizes = [i * o for i, o in zip(dims[:-1], dims[1:])]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights", device),
                       device=device).mul_(init["std"])
    out = []
    for (i, o), w in zip(zip(dims[:-1], dims[1:]), torch.split(flat, sizes)):
        out.append((w.view(i, o), torch.full((o,), float(init["bias"]), device=device)))
    return out


# -- resident -----------------------------------------------------------

def resident_stack(cfg: dict, traffic: dict, seed: int, k: int, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack ``k``: ((nb, bunch, D) f32 rows, (nb, bunch) int32 labels)."""
    g = generator(seed, f"stack{k}", device)
    shape = (traffic["stack_bunches"], cfg["bunch"])
    feats = torch.randn((*shape, cfg["dims"][0]), generator=g, device=device)
    labels = torch.randint(0, cfg["dims"][-1], shape, generator=g, device=device,
                           dtype=torch.int32)
    return feats, labels


def resident_stacks(cfg: dict, traffic: dict, seed: int, device):
    return [resident_stack(cfg, traffic, seed, k, device) for k in range(traffic["stacks"])]


# -- stream -------------------------------------------------------------

def utterances(cfg: dict, traffic: dict, seed: int
               ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(features (T, bands) f32, segment ends, segment classes) of each
    utterance, in corpus order."""
    rng = np.random.default_rng(sub_seed(seed, "corpus"))
    bands, classes = cfg["front_end"]["bands"], cfg["dims"][-1]
    lo, hi = traffic["segment_frames"]
    means = rng.standard_normal((classes, bands), dtype=np.float32)
    for _ in range(traffic["utterances"]):
        T = int(rng.integers(traffic["min_frames"], traffic["max_frames"] + 1))
        ends = np.cumsum(rng.integers(lo, hi + 1, T))
        ends = np.minimum(ends[:np.searchsorted(ends, T) + 1], T)
        cls = rng.integers(0, classes, len(ends))
        lab = np.repeat(cls, np.diff(ends, prepend=0))
        yield means[lab] + rng.standard_normal((T, bands), dtype=np.float32), ends, cls


def frame_labels(ends: np.ndarray, cls: np.ndarray) -> np.ndarray:
    return np.repeat(cls, np.diff(ends, prepend=0)).astype(np.int64)


def _f32_text(v) -> str:
    return " ".join(repr(float(x)) for x in np.asarray(v, np.float32).ravel())


def transform_text(cfg: dict, bias: np.ndarray, window: np.ndarray) -> str:
    """The front end as TNet MMF text: <expand>, <transpose>, the Hamming
    <window>, the DCT <blocklinearity>, then the normalization's <bias>
    and <window>, every number a float32 value."""
    fe = cfg["front_end"]
    bands, ext, k = fe["bands"], fe["frame_ext"], fe["dct_bases"]
    ctx = 2 * ext + 1
    n_in, n_out = bands * ctx, bands * k
    return "".join([
        f"<expand> {n_in} {bands}\nv {ctx}\n" + " ".join(str(o) for o in range(-ext, ext + 1)),
        f"\n<transpose> {n_in} {n_in}\n{ctx}\n",
        f"<window> {n_in} {n_in}\nv {n_in}\n" + _f32_text(np.tile(frontend.hamming(ctx), bands)),
        f"\n<blocklinearity> {n_out} {n_in}\nm {k} {ctx}\n"
        + "\n".join(_f32_text(r) for r in frontend.dct(k, ctx)),
        f"\n<bias> {n_out} {n_out}\nv {n_out}\n" + _f32_text(bias),
        f"\n<window> {n_out} {n_out}\nv {n_out}\n" + _f32_text(window) + "\n"])


def norm_stats(cfg: dict, feats: List[np.ndarray], device) -> Tuple[np.ndarray, np.ndarray]:
    """The global normalization (bias = -mean, window = 1/deviation) of
    the front end's rows over ``feats``, in float64."""
    fe = cfg["front_end"]
    m = torch.from_numpy(frontend.transform_matrix(fe["bands"], fe["frame_ext"],
                                                   fe["dct_bases"])).to(device)
    s1 = s2 = 0.0
    n = 0
    for x in feats:
        y = frontend.splice(torch.from_numpy(x).to(device, torch.float64), fe["frame_ext"]) @ m
        s1, s2, n = s1 + y.sum(0), s2 + (y * y).sum(0), n + y.shape[0]
    mean = s1 / n
    std = torch.sqrt(s2 / n - mean * mean)
    return (-mean).cpu().numpy(), (1.0 / std).cpu().numpy()


def write_corpus(cfg: dict, traffic: dict, seed: int, d: str, device) -> Dict[str, object]:
    """Write the stream corpus into ``d``: ``u<n>.fea`` files, ``train.scp``,
    ``labs.mlf``, ``map`` and ``transform``. Returns the paths, the frame
    count and the normalization (float32)."""
    classes = cfg["dims"][-1]
    mlf, scp, first, frames = ["#!MLF!#\n"], [], [], 0
    for u, (x, ends, cls) in enumerate(utterances(cfg, traffic, seed)):
        path = os.path.join(d, f"u{u:05d}.fea")
        with open(path, "wb") as f:
            f.write(struct.pack(">iihH", x.shape[0], SAMPLE_PERIOD, 4 * x.shape[1],
                                PARMKIND_USER))
            f.write(x.astype(">f4").tobytes())
        begs = np.concatenate([[0], ends[:-1]])
        mlf.append(f'"*/u{u:05d}.lab"\n' + "".join(
            f"{b * SAMPLE_PERIOD} {e * SAMPLE_PERIOD} s{c}\n"
            for b, e, c in zip(begs.tolist(), ends.tolist(), cls.tolist())) + ".\n")
        scp.append(path + "\n")
        frames += x.shape[0]
        if u < traffic["norm_utterances"]:
            first.append(x)
    bias, window = norm_stats(cfg, first, device)
    paths = {k: os.path.join(d, k) for k in ("train.scp", "labs.mlf", "map", "transform")}
    with open(paths["train.scp"], "w") as f:
        f.write("".join(scp))
    with open(paths["labs.mlf"], "w") as f:
        f.write("".join(mlf))
    with open(paths["map"], "w") as f:
        f.write(" ".join(f"s{c}" for c in range(classes)) + "\n")
    with open(paths["transform"], "w") as f:
        f.write(transform_text(cfg, bias, window))
    return {"paths": paths, "frames": frames,
            "bias": bias.astype(np.float32), "window": window.astype(np.float32)}

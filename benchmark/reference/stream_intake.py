"""Plain reference of the streamed cell's intake: the corpus's utterances
in SCP order, each spliced and transformed by the front end
(``frontend.py``) and normalized, their rows concatenated; every
``cache_frames`` rows (then the rest) shuffled by srand48 +
``random_shuffle`` (``rand48.py``, one stream of draws an epoch) and cut
into bunches, the sub-bunch tail dropped, as TNet's cache drains. It
imports nothing of the program under test.
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Tuple

import numpy as np
import torch

from .. import rand48, traffic
from . import frontend

Bunch = Tuple[torch.Tensor, torch.Tensor]


def epoch_bunches(cfg: dict, mix: dict, seed: int, norm: Tuple[np.ndarray, np.ndarray],
                  device) -> Iterator[Bunch]:
    """Every bunch of one streamed epoch, in training order: (rows (bunch,
    D) f32, labels (bunch,) int64). Utterances are transformed as the
    caches need them."""
    fe = cfg["front_end"]
    m = torch.from_numpy(frontend.transform_matrix(
        fe["bands"], fe["frame_ext"], fe["dct_bases"]).astype(np.float32)).to(device)
    bias, window = (torch.from_numpy(np.asarray(v, np.float32)).to(device) for v in norm)
    cache, B = mix["cache_frames"], cfg["bunch"]
    shuffler = rand48.Shuffler(traffic.cache_seed(seed))
    rows: List[torch.Tensor] = []
    labels: List[torch.Tensor] = []
    held = 0

    def drain(n: int) -> Iterator[Bunch]:
        nonlocal rows, labels, held
        r, lab = torch.cat(rows), torch.cat(labels)
        rows, labels, held = [r[n:]], [lab[n:]], held - n
        order = torch.from_numpy(shuffler.order(n)).to(device)
        for i in range(n // B):
            pick = order[i * B:(i + 1) * B]
            yield r[pick], lab[pick]

    for x, ends, cls in traffic.utterances(cfg, mix, seed):
        y = frontend.splice(torch.from_numpy(x).to(device), fe["frame_ext"]) @ m
        rows.append((y + bias) * window)
        labels.append(torch.from_numpy(traffic.frame_labels(ends, cls)).to(device))
        held += x.shape[0]
        while held >= cache:
            yield from drain(cache)
    if held > 0:
        yield from drain(held)


def first_bunches(cfg: dict, mix: dict, seed: int, norm, n: int, device) -> List[Bunch]:
    """The first ``n`` bunches of the epoch."""
    out = list(itertools.islice(epoch_bunches(cfg, mix, seed, norm, device), n))
    if len(out) < n:
        raise ValueError(f"the corpus holds {len(out)} bunches, fewer than {n}")
    return out

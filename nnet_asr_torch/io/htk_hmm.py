"""Minimal HTK MMF (HMM definition) parser for the MPE path.

Parses the subset of STK::ModelSet (STKLib/Models.h ParseMmf) that
TMpeCu actually consumes: per-phone HMM topology (<NUMSTATES>, <TRANSP>)
and the emitting-state → senone-output mapping. State identity comes from
``~s "name"`` macros looked up in the output label map (the ``phone_sN``
convention of the bundled examples), or falls back to ``<phone>_s<N>``
when states are defined inline — the reference's ``PDF_obs_coef`` is
exactly this output index (Decoder.tcc:3220-3221 usage).

The port's copy of ``nnet_asr_tpu/io/htk_hmm.py``, behaviour unchanged.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Hmm:
    name: str
    n_states: int                       # includes entry/exit
    transp: np.ndarray                  # (n_states, n_states) probabilities
    state_names: List[Optional[str]]    # per emitting state (2..N-1)

    @property
    def n_emitting(self) -> int:
        return self.n_states - 2

    def senone_ids(self, label_map: Dict[str, int]) -> List[int]:
        ids = []
        for i, sn in enumerate(self.state_names):
            name = sn if sn is not None else f"{self.name}_s{i + 2}"
            if name not in label_map:
                raise KeyError(f"state '{name}' of HMM '{self.name}' not in "
                               "output label map")
            ids.append(label_map[name])
        return ids


def _tokens(text: str):
    # strings in quotes form single tokens
    return re.findall(r'"[^"]*"|\S+', text)


def parse_mmf(path: str) -> Dict[str, Hmm]:
    with open(path) as f:
        toks = _tokens(f.read())
    pos = 0
    hmms: Dict[str, Hmm] = {}

    def peek():
        return toks[pos] if pos < len(toks) else None

    def next_tok():
        nonlocal pos
        t = peek()
        pos += 1
        return t

    def unquote(s):
        return s[1:-1] if s.startswith('"') else s

    current_name = None
    while pos < len(toks):
        t = next_tok()
        u = t.upper()
        if u == "~H":
            current_name = unquote(next_tok())
        elif u == "<BEGINHMM>":
            hmm = _parse_hmm_body(toks, pos, current_name)
            pos = hmm[1]
            hmms[current_name] = hmm[0]
        # other macros (~o, ~v, ~s at top level, etc.) are skipped token-wise
    return hmms


def _parse_hmm_body(toks, pos, name):
    n_states = 0
    transp = None
    state_names: Dict[int, Optional[str]] = {}
    cur_state = None

    def unquote(s):
        return s[1:-1] if s.startswith('"') else s

    while pos < len(toks):
        t = toks[pos]
        pos += 1
        u = t.upper()
        if u == "<ENDHMM>":
            break
        if u == "<NUMSTATES>":
            n_states = int(toks[pos]); pos += 1
        elif u == "<STATE>":
            cur_state = int(toks[pos]); pos += 1
            state_names.setdefault(cur_state, None)
        elif u == "~S":
            if cur_state is not None:
                state_names[cur_state] = unquote(toks[pos])
            pos += 1
        elif u == "<TRANSP>":
            n = int(toks[pos]); pos += 1
            vals = []
            while len(vals) < n * n:
                vals.append(float(toks[pos])); pos += 1
            transp = np.asarray(vals, dtype=np.float64).reshape(n, n)
            if n_states == 0:
                n_states = n
    if transp is None:
        raise ValueError(f"HMM '{name}' has no <TRANSP>")
    names = [state_names.get(i) for i in range(2, n_states)]
    return Hmm(name=name, n_states=n_states, transp=transp,
               state_names=names), pos

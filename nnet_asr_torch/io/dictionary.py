"""HTK/STK pronunciation dictionary reading.

Re-implements STK's ReadDictionary (STKLib/trunk/src/STKLib/dict.C:24-130)
for the MPE word-lattice expansion path (TMpeCu.cc:397-399): each line is

The port's copy of ``nnet_asr_tpu/io/dictionary.py``, behaviour unchanged.

    WORD [outsym] [prob] phone1 phone2 ...

where ``[outsym]`` is an optional bracketed output symbol, ``prob`` an
optional pronunciation probability (stored as its log, dict.C:97-101), and
repeated WORD lines accumulate pronunciation variants in file order
(``variant_no`` starts at 1, dict.C:80).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .htk import stk_open


@dataclass(frozen=True)
class Pronun:
    word: str
    phones: Tuple[str, ...]
    log_prob: float = 0.0            # log pronunciation probability
    out_symbol: Optional[str] = None  # None when '[]' given (silent word)
    variant: int = 1

    @property
    def nmodels(self) -> int:
        return len(self.phones)


def _htk_str(s: str, pos: int) -> Tuple[str, int]:
    """One HTK-quoted token starting at pos; returns (token, next_pos).
    Mirrors getHTKstr: single/double quotes group, backslash escapes."""
    n = len(s)
    while pos < n and s[pos].isspace():
        pos += 1
    if pos >= n:
        return "", pos
    if s[pos] in "'\"":
        q = s[pos]
        pos += 1
        out = []
        while pos < n and s[pos] != q:
            if s[pos] == "\\" and pos + 1 < n:
                pos += 1
            out.append(s[pos])
            pos += 1
        if pos >= n:
            raise ValueError(f"Unterminated quoted string: {s!r}")
        return "".join(out), pos + 1
    start = pos
    while pos < n and not s[pos].isspace():
        pos += 1
    return s[start:pos], pos


def read_dictionary(path: str) -> Dict[str, List[Pronun]]:
    """Parse an HTK dictionary into {word: [Pronun, ...]} (variant order
    preserved). Accepts STK pipe-filter paths via stk_open."""
    words: Dict[str, List[Pronun]] = {}
    with stk_open(path, "rt") as f:
        for line_no, raw in enumerate(f, 1):
            line = raw.rstrip("\n")
            if not line.strip():
                continue
            word, pos = _htk_str(line, 0)
            if not word:
                continue
            out_symbol: Optional[str] = word
            # optional [outsym]
            n = len(line)
            p = pos
            while p < n and line[p].isspace():
                p += 1
            if p < n and line[p] == "[":
                q = line.index("]", p) if "]" in line[p:] else -1
                if q < 0:
                    raise ValueError(
                        f"Matching ']' is missing ({path}:{line_no})")
                sym = line[p + 1:q]
                out_symbol = sym if sym else None
                pos = q + 1
            # optional probability (a number before the phones)
            log_prob = 0.0
            tok, next_pos = _htk_str(line, pos)
            if tok:
                try:
                    prob = float(tok)
                except ValueError:
                    pass
                else:
                    log_prob = math.log(prob) if prob > 0 else -1e30
                    pos = next_pos
            phones: List[str] = []
            while True:
                tok, pos = _htk_str(line, pos)
                if not tok:
                    break
                phones.append(tok)
            variants = words.setdefault(word, [])
            variants.append(Pronun(word=word, phones=tuple(phones),
                                   log_prob=log_prob, out_symbol=out_symbol,
                                   variant=len(variants) + 1))
    return words

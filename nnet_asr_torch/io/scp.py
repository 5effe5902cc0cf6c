"""SCP file lists with logical=physical mapping, [s,e] ranges and {w} weights.

Mirrors FileListElem parsing (KaldiLib/Features.cc:40-84).

The port's copy of ``nnet_asr_tpu/io/scp.py``, behaviour unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass
class ScpEntry:
    logical: str
    physical: str
    weight: float = 1.0


def parse_scp_entry(line: str) -> ScpEntry:
    s = line.strip().replace("\\", "/")
    weight = 1.0
    pos = s.find("{")
    if pos != -1:
        weight = float(s[pos + 1:].rstrip("}").strip())
        s = s[:pos]
    pos = s.find("=")
    if pos != -1:
        logical = s[:pos].strip()
        physical = s[pos + 1:].strip()
    else:
        logical = physical = s.strip()
    return ScpEntry(logical, physical, weight)


def read_scp(path: str) -> List[ScpEntry]:
    from .htk import stk_open

    entries = []
    with stk_open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            entries.append(parse_scp_entry(line))
    return entries

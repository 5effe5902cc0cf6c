"""HTK SLF (Standard Lattice Format) reading/writing.

Host-side lattice I/O for the MPE path, replacing STK's ReadSTKNetwork
(STKLib/DecoderNetwork_IO.tcc) for the subset TMpeCu exercises: phone/word
lattices with node times and arc scores. Supports labels on arcs (``W=`` on
J lines) or on nodes, ``a=`` acoustic and ``l=`` LM scores, and in-header
``lmscale``/``wdpenalty``.

The port's copy of ``nnet_asr_tpu/io/slf.py``, behaviour unchanged.
"""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TextIO


@dataclass
class LatticeNode:
    time: float = 0.0      # seconds
    word: Optional[str] = None


@dataclass
class LatticeArc:
    start: int
    end: int
    word: Optional[str] = None
    acoustic: float = 0.0
    lm: float = 0.0
    # extra UNSCALED log score (pronunciation prob × PRONUNSCALE + word
    # penalty, attached by the word→phone expansion) — the MPE scorer adds
    # it on top of lm_scale·lm, the way STK enters mPronScale/mWPenalty
    # into the token score outside the lmScale product
    prior: float = 0.0


@dataclass
class Lattice:
    nodes: List[LatticeNode] = field(default_factory=list)
    arcs: List[LatticeArc] = field(default_factory=list)
    header: Dict[str, str] = field(default_factory=dict)

    @property
    def lmscale(self) -> float:
        return float(self.header.get("lmscale", 1.0))

    def frame(self, node: int, rate: float = 100.0) -> int:
        """Node time in frames (default 100 fps)."""
        return int(round(self.nodes[node].time * rate))

    def arc_word(self, arc: LatticeArc) -> Optional[str]:
        if arc.word is not None:
            return arc.word
        return self.nodes[arc.end].word

    def topo_check(self) -> None:
        for a in self.arcs:
            if self.nodes[a.start].time > self.nodes[a.end].time:
                raise ValueError("lattice arc goes backwards in time")


_FIELD_RE = re.compile(r'(\S+?)=("(?:[^"\\]|\\.)*"|\S+)')


def _fields(line: str) -> Dict[str, str]:
    out = {}
    for k, v in _FIELD_RE.findall(line):
        if v.startswith('"') and v.endswith('"'):
            v = v[1:-1]
        out[k] = v
    return out


def read_slf(source) -> Lattice:
    """Parse an SLF lattice from a path or file object."""
    if isinstance(source, str):
        opener = gzip.open if source.endswith(".gz") else open
        with opener(source, "rt") as f:
            return read_slf(f)
    lat = Lattice()
    n_nodes = n_arcs = None
    for raw in source:
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        toks = line.split()
        f = _fields(line)
        # STK node-list dialect (SVite -q J... output, ReadSTKNetwork
        # input): node lines are "<id> t=.. [W=word|M=model]", arc lines
        # are "<start> <end> [a=..] [l=..]" with no I=/J= keys
        if toks[0].isdigit() and "I" not in f and "J" not in f:
            if len(toks) >= 2 and toks[1].isdigit():
                lat.arcs.append(LatticeArc(
                    start=int(toks[0]), end=int(toks[1]),
                    acoustic=float(f.get("a", 0.0)),
                    lm=float(f.get("l", 0.0))))
                continue
            idx = int(toks[0])
            while len(lat.nodes) <= idx:
                lat.nodes.append(LatticeNode())
            word = f.get("W", f.get("M"))
            lat.nodes[idx] = LatticeNode(time=float(f.get("t", 0.0)),
                                         word=word)
            continue
        if "I" in f:
            idx = int(f["I"])
            while len(lat.nodes) <= idx:
                lat.nodes.append(LatticeNode())
            lat.nodes[idx] = LatticeNode(time=float(f.get("t", 0.0)),
                                         word=f.get("W", f.get("M")))
        elif "J" in f:
            lat.arcs.append(LatticeArc(
                start=int(f["S"]), end=int(f["E"]), word=f.get("W"),
                acoustic=float(f.get("a", 0.0)), lm=float(f.get("l", 0.0))))
        else:
            for k, v in f.items():
                if k == "N":
                    n_nodes = int(v)
                elif k == "L":
                    n_arcs = int(v)
                else:
                    lat.header[k] = v
    if n_nodes is not None and len(lat.nodes) != n_nodes:
        raise ValueError(f"SLF declares N={n_nodes} nodes, found {len(lat.nodes)}")
    if n_arcs is not None and len(lat.arcs) != n_arcs:
        raise ValueError(f"SLF declares L={n_arcs} arcs, found {len(lat.arcs)}")
    for a in lat.arcs:
        if not (0 <= a.start < len(lat.nodes) and 0 <= a.end < len(lat.nodes)):
            raise ValueError(
                f"SLF arc references node {max(a.start, a.end)} "
                f"but only {len(lat.nodes)} nodes are defined")
    lat.topo_check()
    return lat


def write_slf(lat: Lattice, out: TextIO) -> None:
    out.write("VERSION=1.0\n")
    for k, v in lat.header.items():
        out.write(f"{k}={v}\n")
    out.write(f"N={len(lat.nodes)}\tL={len(lat.arcs)}\n")
    for i, n in enumerate(lat.nodes):
        w = f"\tW={n.word}" if n.word is not None else ""
        out.write(f"I={i}\tt={n.time:.2f}{w}\n")
    for j, a in enumerate(lat.arcs):
        w = f"\tW={a.word}" if a.word is not None else ""
        out.write(f"J={j}\tS={a.start}\tE={a.end}{w}\ta={a.acoustic:.4f}"
                  f"\tl={a.lm:.4f}\n")


class LatticeArchive:
    """Directory- or MLF-style access to per-utterance lattices.

    The reference fetches numerator/denominator lattices per utterance from
    label-style MLF files (TMpeCu.cc:516-544, OpenInputLabelFile +
    ReadSTKNetwork). Both transports are supported here:
      * ``LatticeArchive(dir)``: ``<dir>/<name>.<ext>`` files (optionally .gz)
      * ``LatticeArchive(mlf_file)``: lattice records inside an MLF
        (what ``SVite -z lat`` produces)
    """

    def __init__(self, path: str, ext: str = "lat",
                 filter_cmd: Optional[str] = None):
        import os

        self.ext = ext
        self.directory = None
        self._mlf = None
        # HNETFILTER (TMpeCu.cc:288-290): shell command run over each
        # lattice file, '$' expanded to the filename
        self.filter_cmd = filter_cmd
        if os.path.isdir(path):
            self.directory = path
        else:
            from .mlf import MlfReader

            self._mlf = MlfReader(path)

    def get(self, logical: str) -> Lattice:
        import io as _io
        import os

        base = os.path.splitext(os.path.basename(logical))[0]
        if self._mlf is not None:
            lines = self._mlf.read_block(base + "." + self.ext)
            return read_slf(_io.StringIO("\n".join(lines)))
        for suffix in (self.ext, self.ext + ".gz"):
            path = os.path.join(self.directory, base + "." + suffix)
            if os.path.exists(path):
                if self.filter_cmd:
                    from .htk import stk_open
                    with stk_open(path, "rt",
                                  filter_cmd=self.filter_cmd) as f:
                        return read_slf(f)
                return read_slf(path)
        raise FileNotFoundError(
            f"No lattice for {logical} in {self.directory} (.{self.ext})")

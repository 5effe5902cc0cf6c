"""Indexed HTK Master Label File (MLF) reading/writing.

Re-implements the capability of KaldiLib/MlfStream.{h,tcc}: the ``Index()``
pass hashes every ``"name"`` block to a stream offset so shuffled SCP lists
get O(1) random access to label records, with the full LabelContainer
wildcard semantics (MlfStream.cc:40-264):

  * names whose only wildcard is a leading ``*`` live in a hash keyed by
    directory depth (count of path separators, MlfStream.cc:22-37); a
    query is matched deepest-first by cropping it to its last N path
    components prefixed with ``*`` (FindInHash, MlfStream.cc:96-195);
  * names with general wildcards (``*?%`` past position 0) live in a
    sequential list matched by the HTK glob (ProcessMask); on a hash hit
    the list is still scanned, limited to patterns inserted EARLIER than
    the hashed record, which therefore take precedence (Find,
    MlfStream.cc:247-264);
  * inserting a non-wildcard name already covered by an earlier pattern
    is a no-op (Insert, MlfStream.cc:78-86).

The port's copy of ``nnet_asr_tpu/io/mlf.py``, behaviour unchanged.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

_MAX_DEPTH = 1 << 30          # MAX_LABEL_DEPTH analog
_WILDCARDS = set("*?%")


def _strip_quotes(s: str) -> str:
    if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
        return s[1:-1]
    return s


def _glob_match(logical: str, mask: str) -> bool:
    from .htk import process_mask
    try:
        process_mask(logical, mask)
        return True
    except ValueError:
        return False


def _dir_depth(label: str) -> int:
    """Count of path separators (MlfStream.cc:22-37)."""
    return sum(1 for c in label if c in "/\\")


class MlfReader:
    """Random-access MLF reader with a name → byte-offset index."""

    def __init__(self, path: str):
        import threading

        self.path = path
        self._lock = threading.Lock()   # seek+read must be atomic
        if path.startswith("|") or path == "-":
            # shell-pipe MLF (StkStream semantics): pipes can't seek, so
            # buffer the stream in memory and index that
            import io as _io

            from .htk import stk_open

            with stk_open(path, "rb") as src:
                self._f = _io.BytesIO(src.read())
        else:
            self._f = open(path, "rb")
        first = self._f.readline().decode("utf-8", "replace").strip()
        if first != "#!MLF!#":
            raise ValueError(f"Not an MLF file (missing #!MLF!#): {path}")
        self._index: Dict[str, Tuple[int, int]] = {}    # name -> (pos, seq)
        self._patterns: List[Tuple[str, int, int]] = []  # (mask, pos, seq)
        self._depths = set()
        self._base_index: Dict[str, int] = {}
        self._build_index()

    def _insert(self, name: str, body: int, seq: int) -> None:
        """LabelContainer::Insert (MlfStream.cc:40-92)."""
        if _WILDCARDS & set(name[1:]):
            self._patterns.append((name, body, seq))
            return
        depth = _dir_depth(name) if name.startswith("*") else _MAX_DEPTH
        self._depths.add(depth)
        # a name already covered by an earlier, more general definition
        # is not re-inserted (MlfStream.cc:78-86)
        if self._lookup(name) is None:
            self._index[name] = (body, seq)
        base = name.split("/")[-1]
        self._base_index.setdefault(base, body)

    def _build_index(self) -> None:
        f = self._f
        seq = 0
        while True:
            line = f.readline()
            if not line:
                break
            s = line.decode("utf-8", "replace").strip()
            if s.startswith('"') and s.endswith('"'):
                name = _strip_quotes(s)
                body = f.tell()
                self._insert(name, body, seq)
                seq += 1
                # skip to terminating '.'
                while True:
                    l2 = f.readline()
                    if not l2 or l2.strip() == b".":
                        break

    def names(self) -> List[str]:
        return list(self._index.keys()) + [p[0] for p in self._patterns]

    def _find_in_hash(self, name: str) -> Optional[Tuple[int, int]]:
        """Deepest-first cropped lookup (FindInHash, MlfStream.cc:96-195)."""
        for depth in sorted(self._depths, reverse=True):
            if depth == _MAX_DEPTH:
                hit = self._index.get(name)
                if hit is not None:
                    return hit
                continue
            if depth == 0:
                key = "*" + name
            else:
                idx = len(name)
                for _ in range(depth):
                    idx = max(name.rfind("/", 0, idx),
                              name.rfind("\\", 0, idx))
                    if idx < 0:
                        break
                if idx < 0:
                    continue
                key = "*" + name[idx:]
            hit = self._index.get(key)
            if hit is not None:
                return hit
        return None

    def _find_in_list(self, name: str,
                      seq_limit: Optional[int] = None) -> Optional[int]:
        for mask, pos, seq in self._patterns:
            if seq_limit is not None and seq >= seq_limit:
                break
            if _glob_match(name, mask):
                return pos
        return None

    def _lookup(self, name: str) -> Optional[int]:
        """LabelContainer::Find (MlfStream.cc:247-264): hash hit, but
        EARLIER list patterns take precedence."""
        hit = self._find_in_hash(name)
        if hit is not None:
            pos, seq = hit
            early = self._find_in_list(name, seq_limit=seq)
            return early if early is not None else pos
        return self._find_in_list(name)

    def _find(self, name: str) -> Optional[int]:
        pos = self._lookup(name)
        if pos is not None:
            return pos
        # convenience fallbacks beyond the reference: queries with a
        # '*/' mask match plain-stored records by basename and vice
        # versa, and a bare-name query matches a '*/name' record
        base = name.split("/")[-1]
        if name.startswith("*/") and base in self._base_index:
            return self._base_index[base]
        hit = self._index.get("*/" + base)
        if hit is not None:
            return hit[0]
        # covers base != name (pathful query vs plain-stored record) AND
        # base == name (bare-name query vs full-path record — how tmpe
        # fetches '001.lat' from SVite's '"/workdir/001.lat"' lattice MLF)
        if base in self._base_index:
            return self._base_index[base]
        return None

    def __contains__(self, name: str) -> bool:
        return self._find(name) is not None

    def read_block(self, name: str) -> List[str]:
        """Return the raw label lines of a record (without the closing '.')."""
        pos = self._find(name)
        if pos is None:
            raise KeyError(f"Cannot open label MLF record: {name}")
        lines = []
        with self._lock:
            self._f.seek(pos)
            while True:
                raw = self._f.readline()
                if not raw:
                    break
                s = raw.decode("utf-8", "replace").rstrip("\n")
                if s.strip() == ".":
                    break
                lines.append(s)
        return lines

    def read_intervals(self, name: str) -> List[Tuple[int, int, str]]:
        """Parse a record into (begin, end, tag) label intervals.

        Lines without times (bare tags) get (-1, -1, tag).
        """
        out = []
        for line in self.read_block(name):
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            parts = s.split()
            if len(parts) >= 3:
                try:
                    b, e = int(parts[0]), int(parts[1])
                    out.append((b, e, parts[2]))
                    continue
                except ValueError:
                    pass
            out.append((-1, -1, parts[0]))
        return out

    def close(self) -> None:
        self._f.close()


class MlfWriter:
    """Sequential MLF writer."""

    def __init__(self, path: str):
        self._f = open(path, "w")
        self._f.write("#!MLF!#\n")

    def write_record(self, name: str, lines) -> None:
        self._f.write(f'"{name}"\n')
        for line in lines:
            self._f.write(line.rstrip("\n") + "\n")
        self._f.write(".\n")

    def close(self) -> None:
        self._f.close()

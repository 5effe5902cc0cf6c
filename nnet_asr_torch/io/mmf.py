"""ASCII matrix/vector stream format used by TNet model (MMF) files.

Format (KaldiLib/Matrix.tcc:539-607, Vector.tcc:527-580):
    m <rows> <cols>\n  v11 v12 ... \n v21 ...
    v <dim>\n  v1 v2 ...
A matrix/vector may also appear headerless when the consumer knows the size.

Floats are written with 9 significant digits (exact float32 round-trip);
the reference wrote C++ default 6-digit precision, which parses identically.

The port's copy of ``nnet_asr_tpu/io/mmf.py``, behaviour unchanged.
"""

from __future__ import annotations

from typing import Optional, TextIO

import numpy as np


class TokenStream:
    """Whitespace token stream over a text file or string, with peek."""

    def __init__(self, source):
        if hasattr(source, "read"):
            text = source.read()
        else:
            text = source
        self._toks = text.split()
        self._pos = 0

    def peek(self) -> Optional[str]:
        return self._toks[self._pos] if self._pos < len(self._toks) else None

    def next(self) -> str:
        tok = self.peek()
        if tok is None:
            raise EOFError("Unexpected end of stream")
        self._pos += 1
        return tok

    def eof(self) -> bool:
        return self._pos >= len(self._toks)

    def read_floats(self, n: int) -> np.ndarray:
        if self._pos + n > len(self._toks):
            raise EOFError("Unexpected end of stream while reading floats")
        vals = np.array([float(t) for t in self._toks[self._pos:self._pos + n]],
                        dtype=np.float32)
        self._pos += n
        return vals

    def read_ints(self, n: int) -> np.ndarray:
        if self._pos + n > len(self._toks):
            raise EOFError("Unexpected end of stream while reading ints")
        vals = np.array([int(t) for t in self._toks[self._pos:self._pos + n]],
                        dtype=np.int32)
        self._pos += n
        return vals


def read_matrix(ts: TokenStream, dtype=np.float32) -> np.ndarray:
    """Read an 'm R C' headed matrix."""
    tag = ts.next()
    if tag != "m":
        raise ValueError(f"Expected matrix header 'm', got {tag!r}")
    rows, cols = int(ts.next()), int(ts.next())
    if dtype == np.int32:
        return ts.read_ints(rows * cols).reshape(rows, cols)
    return ts.read_floats(rows * cols).reshape(rows, cols)


def read_vector(ts: TokenStream, dtype=np.float32) -> np.ndarray:
    """Read a 'v N' headed vector."""
    tag = ts.next()
    if tag != "v":
        raise ValueError(f"Expected vector header 'v', got {tag!r}")
    n = int(ts.next())
    if dtype == np.int32:
        return ts.read_ints(n)
    return ts.read_floats(n)


def _fmt(v: float) -> str:
    return f"{v:.9g}"


def write_matrix(out: TextIO, mat: np.ndarray) -> None:
    out.write(f"m {mat.shape[0]} {mat.shape[1]}\n")
    for row in mat:
        out.write(" ".join(_fmt(v) for v in row))
        out.write(" \n")


def write_vector(out: TextIO, vec: np.ndarray) -> None:
    out.write(f"v {len(vec)}\n")
    out.write(" ".join(_fmt(v) for v in vec))
    out.write(" \n")


# convenience aliases used by package __init__
def read_matrix_ascii(text: str) -> np.ndarray:
    return read_matrix(TokenStream(text))


def write_matrix_ascii(mat: np.ndarray) -> str:
    import io
    buf = io.StringIO()
    write_matrix(buf, mat)
    return buf.getvalue()


def read_vector_ascii(text: str) -> np.ndarray:
    return read_vector(TokenStream(text))


def write_vector_ascii(vec: np.ndarray) -> str:
    import io
    buf = io.StringIO()
    write_vector(buf, vec)
    return buf.getvalue()

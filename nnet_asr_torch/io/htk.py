"""HTK feature-file reading/writing with TNet's feature-pipeline semantics.

The port's copy of ``nnet_asr_tpu/io/htk.py``, behaviour unchanged.

Reference behavior re-implemented (not translated) from the reference's
src/KaldiLib/Features.{h,cc}:
  - HTK binary header + big-endian byte order       (Features.cc:502-533)
  - compressed (_C) scale/bias int16 decode          (Features.cc:540-566, x=(s+B)/A)
  - frame-range suffix ``file.fea[s,e]``             (Features.cc:1045-1056)
  - start/end frame extension by edge replication,
    consuming real frames outside the range first    (Features.cc:1185-1199, 1264-1279)
  - parmKind algebra / target-kind conversion        (Features.cc:1124-1183)
  - per-sentence cepstral mean normalization (_Z)    (Features.cc:1281-1302)
  - HTK delta/accel computation                      (Features.cc:1304-1350)
  - file-based CMN/CVN with filename masks, global
    variance scale file                              (Features.cc:97-185, 1352-1430)
  - HTK feature writing                              (Features.cc:485-538, 602-660)

Everything here is host-side NumPy: it feeds the device input pipeline.
"""

from __future__ import annotations

import os
import re
import struct
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# parmKind constants (HTK encoding; values match KaldiLib/Features.h:46-69)
# ---------------------------------------------------------------------------

PARMKIND_BASE_NAMES = [
    "WAVEFORM", "LPC", "LPREFC", "LPCEPSTRA", "LPDELCEP", "IREFC",
    "MFCC", "FBANK", "MELSPEC", "USER", "DISCRETE", "PLP", "ANON",
]
PARMKIND_WAVEFORM = 0
PARMKIND_LPC = 1
PARMKIND_LPREFC = 2
PARMKIND_LPCEPSTRA = 3
PARMKIND_LPDELCEP = 4
PARMKIND_IREFC = 5
PARMKIND_MFCC = 6
PARMKIND_FBANK = 7
PARMKIND_MELSPEC = 8
PARMKIND_USER = 9
PARMKIND_DISCRETE = 10
PARMKIND_PLP = 11
PARMKIND_ANON = 12

PARMKIND_E = 0o000100  # has energy
PARMKIND_N = 0o000200  # absolute energy suppressed
PARMKIND_D = 0o000400  # has delta coefficients
PARMKIND_A = 0o001000  # has acceleration coefficients
PARMKIND_C = 0o002000  # is compressed
PARMKIND_Z = 0o004000  # has zero mean static coef.
PARMKIND_K = 0o010000  # has CRC checksum
PARMKIND_0 = 0o020000  # has 0'th cepstral coef.
PARMKIND_V = 0o040000  # has VQ codebook index
PARMKIND_T = 0o100000  # has triple delta coefficients

_QUALIFIER_BITS = {
    "E": PARMKIND_E, "N": PARMKIND_N, "D": PARMKIND_D, "A": PARMKIND_A,
    "C": PARMKIND_C, "Z": PARMKIND_Z, "K": PARMKIND_K, "0": PARMKIND_0,
    "V": PARMKIND_V, "T": PARMKIND_T,
}


def parse_parmkind(s: str) -> int:
    """Parse an HTK parameter-kind string like ``MFCC_E_D_A_Z`` to its code.

    Mirrors FeatureRepository::ReadParmKind (Features.cc:1442+).
    """
    s = s.strip().upper()
    if s.startswith("<") and s.endswith(">"):
        s = s[1:-1]
    parts = s.split("_")
    base = parts[0]
    if base not in PARMKIND_BASE_NAMES:
        raise ValueError(f"Unknown parameter kind base: {base!r}")
    kind = PARMKIND_BASE_NAMES.index(base)
    for q in parts[1:]:
        for ch in q:
            if ch not in _QUALIFIER_BITS:
                raise ValueError(f"Unknown parmKind qualifier {ch!r} in {s!r}")
            kind |= _QUALIFIER_BITS[ch]
    return kind


def parmkind_to_str(kind: int) -> str:
    base = kind & 0o77
    name = PARMKIND_BASE_NAMES[base] if base < len(PARMKIND_BASE_NAMES) else f"?{base}"
    out = name
    for ch, bit in _QUALIFIER_BITS.items():
        if kind & bit:
            out += "_" + ch
    return out


# ---------------------------------------------------------------------------
# Raw file read/write
# ---------------------------------------------------------------------------

@dataclass
class HtkHeader:
    n_samples: int
    sample_period: int
    sample_size: int
    sample_kind: int

    def pack(self, big_endian: bool = True) -> bytes:
        fmt = ">iihH" if big_endian else "<iihH"
        return struct.pack(fmt, self.n_samples, self.sample_period,
                           self.sample_size, self.sample_kind)


def _read_header(f, big_endian: bool = True) -> HtkHeader:
    data = f.read(12)
    if len(data) != 12:
        raise ValueError("Truncated HTK header")
    fmt = ">iihH" if big_endian else "<iihH"
    n, per, sz, kind = struct.unpack(fmt, data)
    if per < 0 or per > 100000 or n < 0 or sz < 0:
        raise ValueError("Invalid HTK header (byte order?)")
    return HtkHeader(n, per, sz, kind)


def stk_open(path: str, mode: str = "rb", filter_cmd: Optional[str] = None):
    """Open a file OR a shell pipe, StkStream-style (StkStream.tcc:100-180):
    a leading ``|`` runs the rest as a shell command and streams its stdout
    (read modes) / stdin (write modes); ``-`` is stdio. ``filter_cmd`` is
    the HTK filter mechanism (H*FILTER configs): a shell command run over
    the file with every ``$`` replaced by the filename
    (ExpandHtkFilterCmd, Common.cc:203-227) — e.g. ``'gunzip -c $'``.
    Returns a file-like object whose ``close()`` also reaps the
    subprocess."""
    import io as _io
    import subprocess
    import sys as _sys

    text = "b" not in mode
    if path == "-":
        if "r" in mode:
            return _sys.stdin if text else _sys.stdin.buffer
        return _sys.stdout if text else _sys.stdout.buffer
    if filter_cmd and not path.startswith("|"):
        path = "|" + filter_cmd.replace("$", path)
    if path.startswith("|"):
        cmd = path[1:].strip()
        if "r" in mode:
            proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE)
            stream = proc.stdout
        else:
            proc = subprocess.Popen(cmd, shell=True, stdin=subprocess.PIPE)
            stream = proc.stdin
        if text:
            stream = _io.TextIOWrapper(stream)

        class _PipeStream:
            def __init__(self, f, p, c):
                self._f, self._p, self._cmd = f, p, c

            def __getattr__(self, name):
                return getattr(self._f, name)

            def __iter__(self):
                return iter(self._f)

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                self.close()

            def close(self):
                self._f.close()
                rc = self._p.wait()
                # a failing pipe command must not read as a valid
                # empty/truncated stream (an empty SCP would silently
                # train on nothing); STK's stream-error checks fail hard
                if rc != 0:
                    raise IOError(
                        f"pipe command failed (exit {rc}): {self._cmd!r}")

        return _PipeStream(stream, proc, cmd)
    return open(path, mode)


def read_htk_file(path: str, big_endian: bool = True):
    """Read a whole HTK feature file.

    Returns ``(data, header)`` where ``data`` is float32 (n_frames, dim) with
    compression already undone and the header reflects the decompressed view
    (C bit cleared, n_samples corrected for the A/B rows).
    """
    def _read_exact(f, nbytes):
        # fail fast on truncation, like the reference's fread checks
        # (Features.cc:700 "Cannot read feature file")
        buf = f.read(nbytes)
        if len(buf) != nbytes:
            raise ValueError(f"Cannot read feature file: '{path}' "
                             f"(truncated: wanted {nbytes} data bytes, "
                             f"got {len(buf)})")
        return buf

    with stk_open(path, "rb") as f:
        hdr = _read_header(f, big_endian)
        bo = ">" if big_endian else "<"
        if hdr.sample_kind & PARMKIND_C:
            coefs = hdr.sample_size // 2
            A = np.frombuffer(_read_exact(f, 4 * coefs),
                              dtype=bo + "f4").astype(np.float32)
            B = np.frombuffer(_read_exact(f, 4 * coefs),
                              dtype=bo + "f4").astype(np.float32)
            n = hdr.n_samples - 4  # 2 * sizeof(float32)/sizeof(int16)
            raw = np.frombuffer(_read_exact(f, 2 * coefs * n), dtype=bo + "i2")
            raw = raw.reshape(n, coefs).astype(np.float32)
            data = (raw + B[None, :]) / A[None, :]
            hdr = HtkHeader(n, hdr.sample_period, hdr.sample_size,
                            hdr.sample_kind & ~PARMKIND_C)
        else:
            dim = hdr.sample_size // 4
            raw = np.frombuffer(_read_exact(f, 4 * dim * hdr.n_samples),
                                dtype=bo + "f4")
            data = raw.reshape(hdr.n_samples, dim).astype(np.float32)
    return data, hdr


def write_htk_file(path: str, data: np.ndarray, sample_kind: int,
                   sample_period: int = 100000, big_endian: bool = True) -> None:
    """Write an HTK feature file; a ``_C`` sample kind compresses to int16.

    Mirrors WriteHTKFeatures (Features.cc:1564-1612): per-coefficient
    ``scale = 2*32767/(max-min)``, ``bias = scale*(max+min)/2``, the A/B
    rows written as float32 before the int16 samples, header nSamples
    padded by 4 (2*sizeof(float32)/sizeof(int16)) and sampleSize in int16
    units; values quantize as C's float→int16 cast, i.e. truncation toward
    zero (WriteHTKFeature, Features.cc:1510-1533).
    """
    data = np.ascontiguousarray(data, dtype=np.float32)
    n, dim = data.shape
    bo = ">" if big_endian else "<"
    if sample_kind & PARMKIND_C:
        xmin = data.min(axis=0)
        xmax = data.max(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            scale = np.float32(2 * 32767) / (xmax - xmin)
            bias = scale * (xmax + xmin) / np.float32(2)
            q = data * scale[None, :] - bias[None, :]
        # C float->int16 conversion truncates toward zero; non-finite
        # (constant column => inf scale) lands at INT16_MIN like x86's
        # cvttss2si — the reference doesn't guard that case either
        q = np.trunc(q)
        q = np.where(np.isfinite(q), q, -32768.0)
        samples = np.clip(q, -32768, 32767).astype(bo + "i2")
        hdr = HtkHeader(n + 4, sample_period, dim * 2, sample_kind)
        with open(path, "wb") as f:
            f.write(hdr.pack(big_endian))
            f.write(scale.astype(bo + "f4").tobytes())
            f.write(bias.astype(bo + "f4").tobytes())
            f.write(samples.tobytes())
        return
    hdr = HtkHeader(n, sample_period, dim * 4, sample_kind)
    with open(path, "wb") as f:
        f.write(hdr.pack(big_endian))
        f.write(data.astype(bo + "f4").tobytes())


# ---------------------------------------------------------------------------
# HTK filename masks (ProcessMask) and composition (MakeHtkFileName)
# ---------------------------------------------------------------------------

def make_htk_filename(logical: str, directory: Optional[str], ext: Optional[str]) -> str:
    """Compose dir/name.ext the way MakeHtkFileName does (Common.h:115).

    The directory replaces the path portion of ``logical``; the extension
    replaces the existing extension (if ext is non-empty).
    """
    name = logical
    if directory:
        base = os.path.basename(name)
        name = os.path.join(directory, base)
    if ext:
        root, _ = os.path.splitext(name)
        name = root + "." + ext
    return name


def process_mask(logical: str, mask: str) -> str:
    """HTK-style '%' mask extraction (Common.cc ProcessMask).

    ``mask`` contains '%' characters marking which characters of ``logical``
    are extracted; '*' and '?' match as in HTK globs. Returns the extracted
    string, or raises on mismatch.
    """
    out = []

    def match(li: int, mi: int) -> bool:
        # backtracking glob matcher that records '%' captures
        while mi < len(mask):
            mc = mask[mi]
            if mc == "*":
                # try to match rest at every position
                for skip in range(len(logical) - li, -1, -1):
                    save = len(out)
                    if match(li + skip, mi + 1):
                        return True
                    del out[save:]
                return False
            if li >= len(logical):
                return False
            if mc == "%":
                out.append(logical[li])
            elif mc == "?":
                pass
            elif mc != logical[li]:
                return False
            li += 1
            mi += 1
        return li == len(logical)

    if not match(0, 0):
        raise ValueError(f"Mask {mask!r} does not match {logical!r}")
    return "".join(out)


# ---------------------------------------------------------------------------
# CMN / CVN / VarScale files (ReadCepsNormFile, Features.cc:97-185)
# ---------------------------------------------------------------------------

def read_cepsnorm_file(path: str, kind: str, expect_parmkind: Optional[int],
                       expect_coefs: Optional[int] = None) -> np.ndarray:
    """Read a CEPSNORM file. ``kind`` is 'MEAN', 'VARIANCE' or 'VARSCALE'.

    Returns the transformed vector exactly as the reference applies it:
    MEAN as-is (subtracted), VARIANCE as 1/sqrt(v) (multiplied),
    VARSCALE as sqrt(v) (multiplied).
    """
    with open(path, "r") as f:
        text = f.read()
    toks = re.findall(r"<[^>]*>|\S+", text)
    pos = 0
    if kind != "VARSCALE":
        if len(toks) < 2 or toks[0].upper() != "<CEPSNORM>":
            raise ValueError(f"<CEPSNORM> expected in {path}")
        file_kind = parse_parmkind(toks[1])
        if expect_parmkind is not None and file_kind != expect_parmkind:
            raise ValueError(
                f"parmKind mismatch in {path}: file has "
                f"{parmkind_to_str(file_kind)}, expected {parmkind_to_str(expect_parmkind)}")
        pos = 2
    tag = toks[pos].upper()
    if tag != f"<{kind}>":
        raise ValueError(f"<{kind}> expected in {path}, found {tag}")
    n = int(toks[pos + 1])
    vals = np.array([float(t) for t in toks[pos + 2: pos + 2 + n]], dtype=np.float64)
    if len(vals) != n:
        raise ValueError(f"Unexpected end of {kind} file {path}")
    if pos + 2 + n != len(toks):
        raise ValueError(f"End of file expected in {path}")
    if expect_coefs is not None and n != expect_coefs:
        raise ValueError(f"{kind} file {path} has {n} coefs, expected {expect_coefs}")
    if kind == "VARIANCE":
        vals = 1.0 / np.sqrt(vals)
    elif kind == "VARSCALE":
        vals = np.sqrt(vals)
    return vals.astype(np.float32)


def write_cepsnorm_file(path: str, kind: str, parmkind: int, values: np.ndarray) -> None:
    """Write a CEPSNORM file with *raw* values (mean, or variance, not 1/sqrt)."""
    with open(path, "w") as f:
        if kind != "VARSCALE":
            f.write(f"<CEPSNORM> <{parmkind_to_str(parmkind)}>\n")
        f.write(f"<{kind}> {len(values)}\n")
        f.write(" ".join(repr(float(v)) for v in values))
        f.write("\n")


# ---------------------------------------------------------------------------
# The full feature-reading pipeline (FeatureRepository.ReadHTKFeatures)
# ---------------------------------------------------------------------------

_RANGE_RE = re.compile(r"^(.*)\[(\d+),(\d+)\]$")


class FeatureReader:
    """Reads HTK features with TNet's conversion pipeline.

    Equivalent to FeatureRepository's live read path (Features.cc:1011-1430):
    range selection, frame extension, parmKind conversion, per-sentence CMN,
    delta/accel computation, file CMN/CVN, global variance scaling.
    """

    def __init__(
        self,
        target_kind: int = PARMKIND_ANON,
        deriv_order: int = -1,
        deriv_win_lengths: Optional[Sequence[int]] = None,
        start_frm_ext: int = 0,
        end_frm_ext: int = 0,
        cmn_path: Optional[str] = None,
        cmn_mask: Optional[str] = None,
        cvn_path: Optional[str] = None,
        cvn_mask: Optional[str] = None,
        cvg_file: Optional[str] = None,
        big_endian: bool = True,
    ):
        self.target_kind = target_kind
        self.deriv_order = deriv_order
        self.deriv_win_lengths = list(deriv_win_lengths) if deriv_win_lengths else []
        self.start_frm_ext = start_frm_ext
        self.end_frm_ext = end_frm_ext
        self.cmn_path, self.cmn_mask = cmn_path, cmn_mask
        self.cvn_path, self.cvn_mask = cvn_path, cvn_mask
        self.cvg_file = cvg_file
        self.big_endian = big_endian
        self._cmn_cache = {}
        self._cvn_cache = {}
        self._cvg_cache = None
        self.last_header: Optional[HtkHeader] = None

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def split_range(physical: str):
        m = _RANGE_RE.match(physical)
        if m:
            return m.group(1), int(m.group(2)), int(m.group(3))
        return physical, None, None

    def _read_gzip_ascii(self, file_name):
        import gzip

        with gzip.open(file_name, "rt") as f:
            rows = [[float(v) for v in line.split()]
                    for line in f if line.strip()]
        data = np.asarray(rows, dtype=np.float32)
        ext_l, ext_r = self.start_frm_ext, self.end_frm_ext
        if ext_l or ext_r:
            data = np.concatenate(
                [np.repeat(data[:1], ext_l, axis=0), data,
                 np.repeat(data[-1:], ext_r, axis=0)], axis=0)
        self.last_header = HtkHeader(data.shape[0], 100000,
                                     data.shape[1] * 4, PARMKIND_USER)
        return data

    def _native_fast_read(self, file_name, logical, from_frame, to_frame):
        """Native read when no parmkind conversion is required, else None."""
        from . import native

        if not native.available():
            return None
        try:
            n, per, sz, kind = native.read_header(file_name, self.big_endian)
        except IOError:
            return None
        target = self.target_kind
        if target == PARMKIND_ANON:
            target = kind
        elif (target & 0o77) == PARMKIND_ANON:
            target = (target & ~0o77) | (kind & 0o77)
        src_deriv = (3 if kind & PARMKIND_T else 2 if kind & PARMKIND_A else
                     1 if kind & PARMKIND_D else 0)
        deriv = self.deriv_order if self.deriv_order >= 0 else src_deriv
        # conversion-free: same qualifiers apart from _Z (sentence CMN)
        if (target & ~PARMKIND_Z) != (kind & ~PARMKIND_Z) or deriv != src_deriv:
            return None
        out = native.read_frames(
            file_name, self.big_endian,
            from_frame if from_frame is not None else 0,
            to_frame if to_frame is not None else -1,
            self.start_frm_ext, self.end_frm_ext)
        tot = out.shape[0]
        coefs_full = out.shape[1] // (src_deriv + 1)
        if (self.cmn_path is None and not (kind & PARMKIND_Z)
                and (target & PARMKIND_Z)):
            seg = out[:, :coefs_full]
            norm = seg.sum(axis=0, dtype=np.float32) / np.float32(tot)
            out[:, :coefs_full] = seg - norm[None, :]
        out = self._apply_norm_files(out, logical, target, coefs_full,
                                     src_deriv)
        self.last_header = HtkHeader(tot, per, out.shape[1] * 4, target)
        return out

    def _apply_norm_files(self, out, logical, full_kind, coefs_full, deriv):
        trg_vec_size = out.shape[1]
        if self.cmn_path is not None and self.cmn_mask is not None:
            key = process_mask(logical, self.cmn_mask)
            fn = os.path.join(self.cmn_path, key)
            if fn not in self._cmn_cache:
                self._cmn_cache[fn] = read_cepsnorm_file(
                    fn, "MEAN",
                    full_kind & ~(PARMKIND_D | PARMKIND_A | PARMKIND_T
                                  | PARMKIND_Z),
                    coefs_full)
            out[:, :coefs_full] -= self._cmn_cache[fn][None, :]
        if self.cvn_path is not None and self.cvn_mask is not None:
            key = process_mask(logical, self.cvn_mask)
            fn = os.path.join(self.cvn_path, key)
            if fn not in self._cvn_cache:
                self._cvn_cache[fn] = read_cepsnorm_file(
                    fn, "VARIANCE", full_kind, trg_vec_size)
            out[:, :trg_vec_size] *= self._cvn_cache[fn][None, :]
        if self.cvg_file is not None:
            if self._cvg_cache is None:
                self._cvg_cache = read_cepsnorm_file(
                    self.cvg_file, "VARSCALE", None, trg_vec_size)
            out[:, :trg_vec_size] *= self._cvg_cache[None, :]
        return out

    def read(self, physical: str, logical: Optional[str] = None) -> np.ndarray:
        """Read one utterance with the full pipeline. Returns float32 (T, D).

        Scans the result for NaN/Inf like the reference does after every
        feature read (Matrix::CheckData, KaldiLib/Matrix.h:238-250, called
        from Platform.h:218 and TNetCu.cc:386) — corrupt feature files
        fail fast with the utterance name instead of poisoning training."""
        out = self._read_impl(physical, logical)
        if not np.isfinite(out).all():
            bad = np.argwhere(~np.isfinite(out))[0]
            raise ValueError(
                f"Invalid value: {out[bad[0], bad[1]]} in matrix"
                f" row: {bad[0]} col: {bad[1]}"
                f" file: {logical if logical is not None else physical}")
        return out

    def _read_impl(self, physical: str, logical: Optional[str] = None) -> np.ndarray:
        logical = logical if logical is not None else physical
        file_name, from_frame, to_frame = self.split_range(physical)

        # gzipped ASCII features (Features.cc:1681 ReadGzipAsciiFeatures)
        if file_name.endswith(".gz"):
            return self._read_gzip_ascii(file_name)

        # fast path: raw read + range + extension in native code when no
        # parmkind conversion / derivative work is needed
        fast = self._native_fast_read(file_name, logical, from_frame, to_frame)
        if fast is not None:
            return fast

        data, hdr = read_htk_file(file_name, self.big_endian)
        sample_kind = hdr.sample_kind  # C bit already cleared by read_htk_file
        n_samples = hdr.n_samples

        if from_frame is None:
            from_frame, to_frame = 0, n_samples - 1

        src_deriv_order = (3 if sample_kind & PARMKIND_T else
                           2 if sample_kind & PARMKIND_A else
                           1 if sample_kind & PARMKIND_D else 0)
        src_E = int(bool(sample_kind & PARMKIND_E))
        src_0 = int(bool(sample_kind & PARMKIND_0))
        src_N = int(bool(sample_kind & PARMKIND_N)) * (src_E + src_0)

        target_kind = self.target_kind
        if target_kind == PARMKIND_ANON:
            target_kind = sample_kind
        elif (target_kind & 0o77) == PARMKIND_ANON:
            target_kind = (target_kind & ~0o77) | (sample_kind & 0o77)

        trg_E = int(bool(target_kind & PARMKIND_E))
        trg_0 = int(bool(target_kind & PARMKIND_0))
        trg_N = int(bool(target_kind & PARMKIND_N)) * (trg_E + trg_0)

        src_vec_size = data.shape[1]
        coefs = (src_vec_size + src_N) // (src_deriv_order + 1) - src_E - src_0
        if (coefs + src_E + src_0) * (src_deriv_order + 1) - src_N != src_vec_size:
            raise ValueError(f"Invalid HTK header in {file_name}: sampSize/parmKind mismatch")

        deriv_order = self.deriv_order
        if deriv_order < 0:
            deriv_order = src_deriv_order

        if ((not src_E and trg_E) or (not src_0 and trg_0) or (src_N and not trg_N)
                or (trg_N and not trg_E and not trg_0) or (trg_N and not deriv_order)
                or (src_N and not src_deriv_order and deriv_order)
                or ((sample_kind & 0o77) != (target_kind & 0o77)
                    and (sample_kind & 0o77) != PARMKIND_ANON)):
            raise ValueError(
                f"Cannot convert {parmkind_to_str(sample_kind)} "
                f"to {parmkind_to_str(target_kind)}")

        lo = min(src_deriv_order, deriv_order)
        trg_vec_size = (coefs + trg_E + trg_0) * (deriv_order + 1) - trg_N

        # Frame extension consumes real frames outside the range first
        # (Features.cc:1185-1192), then replicates edges.
        ext_left, ext_right = self.start_frm_ext, self.end_frm_ext
        i = min(from_frame, self.start_frm_ext)
        from_frame -= i
        ext_left -= i
        i = min(n_samples - to_frame - 1, self.end_frm_ext)
        to_frame += i
        ext_right -= i
        if from_frame > to_frame or from_frame >= n_samples or to_frame < 0:
            raise ValueError(f"Invalid frame range for feature file {file_name}")
        tot_frames = to_frame - from_frame + 1 + ext_left + ext_right

        # Column gather implementing the per-frame copy loop
        # (Features.cc:1206-1246): keep the coef block of each derivative
        # order up to `lo`, plus 0'th/energy where the target wants them.
        src_block = coefs + src_E + src_0   # stride between deriv orders in src
        cols = []
        pad_cols = []  # positions (in target layout) to zero-fill (trg wants, src lacks)
        src_off = 0
        for order in range(lo + 1):
            cols.extend(range(src_off, src_off + coefs))
            src_off += coefs
            # source 0'th / E presence at this order
            s0 = src_0 and (order > 0 or not src_N)
            sE = src_E and (order > 0 or not src_N)
            t0 = trg_0 and (order > 0 or not trg_N)
            tE = trg_E and (order > 0 or not trg_N)
            if t0:
                cols.append(src_off if s0 else -1)
            if s0:
                src_off += 1
            if tE:
                cols.append(src_off if sE else -1)
            if sE:
                src_off += 1
        del pad_cols

        sel = data[from_frame:to_frame + 1]
        gathered = np.empty((sel.shape[0], len(cols)), dtype=np.float32)
        for j, c in enumerate(cols):
            gathered[:, j] = sel[:, c] if c >= 0 else 0.0

        # allocate the full target matrix, copy, edge-extend
        out = np.zeros((tot_frames, trg_vec_size), dtype=np.float32)
        ncopied = gathered.shape[1]
        out[ext_left:tot_frames - ext_right, :ncopied] = gathered
        if ext_left > 0:
            out[:ext_left, :ncopied] = out[ext_left, :ncopied]
        if ext_right > 0:
            out[tot_frames - ext_right:, :ncopied] = out[tot_frames - ext_right - 1, :ncopied]

        # From here `coefs` includes trg_0+trg_E (Features.cc:1262)
        coefs_full = coefs + trg_0 + trg_E

        # Per-sentence CMN: no CMN dir, src lacks _Z, target wants _Z
        # (Features.cc:1281-1302). Normalizes the first `coefs_full` columns
        # over the *extended* matrix, in float32 accumulation like BaseFloat.
        if (self.cmn_path is None and not (sample_kind & PARMKIND_Z)
                and (target_kind & PARMKIND_Z)):
            seg = out[:, :coefs_full]
            norm = seg.sum(axis=0, dtype=np.float32) / np.float32(tot_frames)
            out[:, :coefs_full] = seg - norm[None, :]

        # Compute missing derivatives with the HTK regression formula
        # (Features.cc:1304-1350), operating on the extended matrix.
        for order in range(src_deriv_order, deriv_order):
            win = self.deriv_win_lengths[order]
            norm = np.float32(sum(2 * k * k for k in range(1, win + 1)))
            base = order * coefs_full - trg_N
            src_blk = out[:, base:base + coefs_full] if base >= 0 else out[:, :base + coefs_full]
            # handle trg_N offset: base columns may start at negative index
            lo_col = order * coefs_full - trg_N
            src_blk = out[:, max(lo_col, 0): lo_col + coefs_full]
            dst_lo = (order + 1) * coefs_full - trg_N
            T = tot_frames
            acc = np.zeros_like(src_blk)
            for k in range(1, win + 1):
                up = np.empty_like(src_blk)
                dn = np.empty_like(src_blk)
                # src[min(T-1-i,k)] ahead, src[-min(i,k)] behind (edge-clamped)
                up[:T - k] = src_blk[k:]
                up[T - k:] = src_blk[T - 1]
                dn[k:] = src_blk[:T - k]
                dn[:k] = src_blk[0]
                acc += np.float32(k) * (up - dn)
            out[:, dst_lo:dst_lo + src_blk.shape[1]] = acc / norm

        # File-based CMN
        current_kind = target_kind & ~(PARMKIND_D | PARMKIND_A | PARMKIND_T)
        if self.cmn_path is not None and self.cmn_mask is not None:
            key = process_mask(logical, self.cmn_mask)
            fn = os.path.join(self.cmn_path, key)
            if fn not in self._cmn_cache:
                self._cmn_cache[fn] = read_cepsnorm_file(
                    fn, "MEAN", current_kind & ~PARMKIND_Z, coefs_full)
            cmn = self._cmn_cache[fn]
            out[:, :coefs_full - trg_N] -= cmn[None, trg_N:coefs_full]

        full_kind = current_kind | (
            (PARMKIND_D | PARMKIND_A | PARMKIND_T) if deriv_order == 3 else
            (PARMKIND_D | PARMKIND_A) if deriv_order == 2 else
            PARMKIND_D if deriv_order == 1 else 0)

        # File-based CVN (multiplies 1/sqrt(var))
        if self.cvn_path is not None and self.cvn_mask is not None:
            key = process_mask(logical, self.cvn_mask)
            fn = os.path.join(self.cvn_path, key)
            if fn not in self._cvn_cache:
                self._cvn_cache[fn] = read_cepsnorm_file(fn, "VARIANCE", full_kind, trg_vec_size)
            cvn = self._cvn_cache[fn]
            out[:, :trg_vec_size - trg_N] *= cvn[None, trg_N:trg_vec_size]

        # Global variance scale (multiplies sqrt(varscale))
        if self.cvg_file is not None:
            if self._cvg_cache is None:
                self._cvg_cache = read_cepsnorm_file(self.cvg_file, "VARSCALE", None, trg_vec_size)
            out[:, :trg_vec_size - trg_N] *= self._cvg_cache[None, trg_N:trg_vec_size]

        self.last_header = HtkHeader(
            tot_frames, hdr.sample_period, trg_vec_size * 4, full_kind)
        return out

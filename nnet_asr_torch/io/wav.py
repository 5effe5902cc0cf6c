"""Waveform input for the native front end (the HCopy source side).

Formats the reference recipe's extraction stage consumes
(examples/02train_MLP3_newbob_timit/prepare_timit/hcopy23mel_16k_0.sh:
SOURCEFORMAT=NOHEAD + BYTEORDER=VAX raw PCM16), plus RIFF WAV, NIST
SPHERE (what real TIMIT discs ship, replacing the recipe's ``sox -t
.sph`` stage — prepare_timit.sh:26), and the HTK WAVEFORM file format
(12-byte HTK header, sampSize=2), so a user can point the recipe at
whichever audio container they have.  ``read_audio_auto`` dispatches by
magic bytes — TIMIT names SPHERE files ``.wav``, so extensions lie.

The port's copy of ``nnet_asr_tpu/io/wav.py``, behaviour unchanged.
"""

from __future__ import annotations

import struct

import numpy as np

from .htk import _read_header, stk_open


def read_raw(path: str, byte_order: str = "vax") -> np.ndarray:
    """SOURCEFORMAT=NOHEAD: bare PCM16 samples. BYTEORDER=VAX means
    little-endian (the HTK config name), anything else big-endian."""
    dt = "<i2" if byte_order.lower() in ("vax", "le", "little") else ">i2"
    with stk_open(path, "rb") as f:
        data = f.read()
    if len(data) % 2:
        raise ValueError(f"raw PCM16 file has odd byte count: {path}")
    return np.frombuffer(data, dtype=dt).astype(np.int16)


def read_wav(path: str) -> tuple:
    """RIFF WAV, PCM16 (first channel of multi-channel files).
    Returns (samples, sample_rate)."""
    with stk_open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) != 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"Not a RIFF WAV file: {path}")
        fmt = None
        while True:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"WAV file missing data chunk: {path}")
            cid, size = head[:4], struct.unpack("<I", head[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
                if len(fmt) < 16:
                    raise ValueError(f"Truncated WAV fmt chunk: {path}")
            elif cid == b"data":
                raw = f.read(size)
                if len(raw) < size:
                    raise ValueError(f"Truncated WAV data chunk: {path}")
                break
            else:
                f.read(size + (size & 1))
        if fmt is None:
            raise ValueError(f"WAV file missing fmt chunk: {path}")
        audio_fmt, n_ch, rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
        if audio_fmt != 1 or bits != 16:
            raise ValueError(
                f"Only PCM16 WAV supported (fmt={audio_fmt}, bits={bits}): "
                f"{path}")
        samples = np.frombuffer(raw, dtype="<i2")
        if n_ch > 1:
            samples = samples[::n_ch]          # first channel
        return samples.astype(np.int16), rate


def read_sphere(path: str) -> tuple:
    """NIST SPHERE audio (real TIMIT discs ship these, usually named
    ``.wav``): a 1024-byte ASCII header — ``NIST_1A\\n   1024\\n`` then
    ``name -tN value`` lines up to ``end_head`` — followed by PCM
    samples.  The reference recipe converts these with ``sox -t .sph``
    (prepare_timit/prepare_timit.sh:26); this reader makes the from-audio
    path self-contained.  Shorten-compressed files error loudly.
    Returns (samples, sample_rate)."""
    with stk_open(path, "rb") as f:
        magic = f.read(8)
        if magic != b"NIST_1A\n":
            raise ValueError(f"Not a NIST SPHERE file: {path}")
        hsz_line = f.read(8)
        try:
            hdr_size = int(hsz_line.strip())
        except ValueError:
            raise ValueError(f"Bad SPHERE header-size line: {path}")
        rest = f.read(hdr_size - 16)
        if len(rest) != hdr_size - 16:
            raise ValueError(f"Truncated SPHERE header: {path}")
        fields = {}
        for ln in rest.decode("ascii", "replace").splitlines():
            ln = ln.strip()
            if ln == "end_head":
                break
            parts = ln.split(None, 2)
            if len(parts) == 3 and parts[1].startswith("-"):
                fields[parts[0]] = parts[2]
        coding = fields.get("sample_coding", "pcm")
        if "shorten" in coding or "embedded" in coding:
            raise ValueError(
                f"SPHERE file is shorten-compressed (sample_coding="
                f"{coding}); decompress with 'sph2pipe' or 'sox' first: "
                f"{path}")
        if coding not in ("pcm", "pcm-2", "linear"):
            raise ValueError(f"Unsupported SPHERE sample_coding "
                             f"{coding!r}: {path}")
        n_bytes = int(fields.get("sample_n_bytes", "2"))
        if n_bytes != 2:
            raise ValueError(
                f"Only 16-bit SPHERE PCM supported (sample_n_bytes="
                f"{n_bytes}): {path}")
        try:
            rate = int(fields["sample_rate"])
        except KeyError:
            raise ValueError(f"SPHERE header missing sample_rate: {path}")
        n_ch = int(fields.get("channel_count", "1"))
        # sample_byte_format: "01" = little-endian, "10" = big-endian
        fmt = fields.get("sample_byte_format", "10")
        dt = "<i2" if fmt == "01" else ">i2"
        raw = f.read()
    samples = np.frombuffer(raw, dtype=dt)
    want = fields.get("sample_count")
    if want is not None and samples.size // max(n_ch, 1) < int(want):
        raise ValueError(
            f"Truncated SPHERE data: header says {want} samples, "
            f"file has {samples.size // max(n_ch, 1)}: {path}")
    if n_ch > 1:
        samples = samples[::n_ch]              # first channel
    return samples.astype(np.int16), rate


def sniff_audio(path: str) -> str:
    """Detect the audio container by magic bytes: 'wav' (RIFF), 'nist'
    (SPHERE), 'htk-be'/'htk-le' (HTK WAVEFORM whose 12-byte header is
    consistent with the file size) or 'raw'.  Real TIMIT names SPHERE
    files '.wav', so extension-based dispatch mis-reads them — sniff
    instead."""
    with stk_open(path, "rb") as f:
        head = f.read(12)
        f.seek(0, 2)
        size = f.tell()
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return "wav"
    if head[:8] == b"NIST_1A\n":
        return "nist"
    if len(head) == 12:
        # HTK WAVEFORM: kind 0, sampSize 2, nSamples matching the size
        for bo, tag in ((">", "htk-be"), ("<", "htk-le")):
            n, _per, sz, kind = struct.unpack(bo + "iihH", head)
            if kind == 0 and sz == 2 and n > 0 and size == 12 + 2 * n:
                return tag
    return "raw"


def read_audio_auto(path: str, rate_hint: int = 16000) -> tuple:
    """Magic-sniffed audio read for intake tools.  Raw files carry no
    rate; ``rate_hint`` is assumed.  Returns (samples, rate)."""
    kind = sniff_audio(path)
    if kind == "wav":
        return read_wav(path)
    if kind == "nist":
        return read_sphere(path)
    if kind.startswith("htk"):
        samples, period = read_htk_waveform(path, kind == "htk-be")
        return samples, int(round(1.0e7 / period))
    return read_raw(path), rate_hint


def read_htk_waveform(path: str, big_endian: bool = True) -> tuple:
    """HTK WAVEFORM file (sampleKind 0, sampSize 2, PCM16 samples).
    Returns (samples, sample_period_100ns)."""
    with stk_open(path, "rb") as f:
        hdr = _read_header(f, big_endian)
        if (hdr.sample_kind & 0o77) != 0 or hdr.sample_size != 2:
            raise ValueError(
                f"Not an HTK WAVEFORM file (kind={hdr.sample_kind}, "
                f"size={hdr.sample_size}): {path}")
        raw = f.read(2 * hdr.n_samples)
        if len(raw) != 2 * hdr.n_samples:
            raise ValueError(f"Truncated HTK waveform: {path}")
    bo = ">" if big_endian else "<"
    return np.frombuffer(raw, dtype=bo + "i2").astype(np.int16), \
        hdr.sample_period


def write_sphere(path: str, samples: np.ndarray, rate: int,
                 byte_format: str = "01") -> None:
    """PCM16 mono NIST SPHERE writer (for fixtures and tests)."""
    s = np.asarray(samples, np.int16)
    body = (f"channel_count -i 1\n"
            f"sample_count -i {s.size}\n"
            f"sample_rate -i {rate}\n"
            f"sample_n_bytes -i 2\n"
            f"sample_byte_format -s2 {byte_format}\n"
            f"sample_coding -s3 pcm\n"
            f"end_head\n")
    hdr = ("NIST_1A\n   1024\n" + body).encode("ascii")
    if len(hdr) > 1024:
        raise ValueError("SPHERE header overflow")
    hdr += b" " * (1024 - len(hdr))
    dt = "<i2" if byte_format == "01" else ">i2"
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(s.astype(dt).tobytes())


def write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    """PCM16 mono RIFF WAV writer (for toy corpora and tests)."""
    s = np.asarray(samples, np.int16)
    data = s.astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate,
                                      rate * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(data)))
        f.write(data)

"""Native HCopy-equivalent front end: waveform → FBANK / MELSPEC / MFCC.

The reference's TIMIT recipe delegates feature extraction to HTK's HCopy
(examples/02train_MLP3_newbob_timit/prepare_timit/hcopy23mel_16k_0.sh:
FBANK, 23 channels, USEPOWER, Hamming, no pre-emphasis, 25ms/10ms;
MFCC_D_A_0 as the documented alternative) — HTK itself ships with
neither repo, so this module re-implements the HTK-book front end
(HTK book ch. 5 / HSigP's Wave2FBank+Wave2MFCC algorithms, re-derived,
not translated) so the recipe is self-contained from audio:

  frame grab → [ZMEANSOURCE] → [raw energy] → pre-emphasis → Hamming →
  zero-padded FFT → triangular mel filterbank (HTK channel-center
  spacing, natural-log mel, melfloor) → log → [DCT-II cepstra +
  ceplifter + c0] → [_E energy w/ ENORMALISE] → [_Z utterance CMN] →
  [_D/_A/_T HTK regression deltas (Features.cc:1304-1350 formula)]

Everything is host-side NumPy: extraction feeds the input pipeline the
same way the delegated HCopy stage feeds the reference's. Output
parmkind/layout matches what io/htk.py's FeatureReader expects
([c1..cN, c0?, E?] per derivative order).

The port's copy of ``nnet_asr_tpu/ops/mfcc.py``, behaviour unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..io.htk import (PARMKIND_0, PARMKIND_A, PARMKIND_BASE_NAMES,
                      PARMKIND_D, PARMKIND_E, PARMKIND_FBANK,
                      PARMKIND_MELSPEC, PARMKIND_MFCC, PARMKIND_T,
                      PARMKIND_Z, parse_parmkind)


@dataclass(frozen=True)
class FrontendConfig:
    """HCopy-config subset (HTK names; defaults = HTK's)."""
    target_kind: str = "MFCC_0_D_A"
    source_rate: float = 625.0        # sample period, 100ns units (16 kHz)
    target_rate: float = 100000.0     # frame shift, 100ns units (10 ms)
    window_size: float = 250000.0     # window length, 100ns units (25 ms)
    use_hamming: bool = True          # USEHAMMING
    preemcoef: float = 0.97           # PREEMCOEF
    zmean_source: bool = False        # ZMEANSOURCE
    use_power: bool = False           # USEPOWER (F: magnitude spectrum)
    numchans: int = 20                # NUMCHANS
    lofreq: float = -1.0              # LOFREQ Hz (-1: 0)
    hifreq: float = -1.0              # HIFREQ Hz (-1: Nyquist)
    numceps: int = 12                 # NUMCEPS
    ceplifter: int = 22               # CEPLIFTER
    melfloor: float = 1.0             # the HTK melFloor constant
    raw_energy: bool = True           # RAWENERGY
    enormalise: bool = True           # ENORMALISE
    escale: float = 0.1               # ESCALE
    silfloor: float = 50.0            # SILFLOOR (dB)
    deltawindow: int = 2              # DELTAWINDOW
    accwindow: int = 2                # ACCWINDOW
    thirdwindow: int = 2              # THIRDWINDOW


def htk_regression_deltas(x: np.ndarray, win: int) -> np.ndarray:
    """HTK delta regression with edge replication — the same formula the
    reader applies for missing derivative orders (Features.cc:1304-1350,
    io/htk.py)."""
    T = x.shape[0]
    norm = np.float32(sum(2 * k * k for k in range(1, win + 1)))
    acc = np.zeros_like(x)
    for k in range(1, win + 1):
        up = np.empty_like(x)
        dn = np.empty_like(x)
        up[:T - k] = x[k:]
        up[max(T - k, 0):] = x[T - 1]
        dn[k:] = x[:T - k]
        dn[:min(k, T)] = x[0]
        acc += np.float32(k) * (up - dn)
    return acc / norm


class Frontend:
    def __init__(self, cfg: FrontendConfig):
        self.cfg = cfg
        kind = parse_parmkind(cfg.target_kind)
        base = kind & 0o77
        if base not in (PARMKIND_MFCC, PARMKIND_FBANK, PARMKIND_MELSPEC):
            raise ValueError(
                f"Frontend supports MFCC/FBANK/MELSPEC targets, got "
                f"{PARMKIND_BASE_NAMES[base] if base < 13 else base}")
        if base != PARMKIND_MFCC and (kind & PARMKIND_0):
            raise ValueError("_0 qualifier requires an MFCC target")
        # Qualifiers the front end does not implement must not pass
        # through silently: the written header would advertise (say) _N
        # while the payload still carried c0/E, and io/htk.py readers —
        # which honor PARMKIND_N — would mis-slice the feature layout.
        from ..io.htk import PARMKIND_C, PARMKIND_K, PARMKIND_N, PARMKIND_V
        for flag, name in ((PARMKIND_N, "_N"), (PARMKIND_C, "_C"),
                           (PARMKIND_K, "_K"), (PARMKIND_V, "_V")):
            if kind & flag:
                raise ValueError(
                    f"Frontend does not implement the {name} qualifier "
                    f"(TARGETKIND={cfg.target_kind}); supported: "
                    "_E _D _A _T _Z (+_0 on MFCC)")
        self.kind = kind
        self.base = base

        self.frame_len = int(round(cfg.window_size / cfg.source_rate))
        self.frame_shift = int(round(cfg.target_rate / cfg.source_rate))
        if self.frame_len <= 0 or self.frame_shift <= 0:
            raise ValueError("WINDOWSIZE/TARGETRATE must exceed SOURCERATE")
        self.fs = 1.0e7 / cfg.source_rate          # sample rate, Hz
        n_fft = 2
        while n_fft < self.frame_len:
            n_fft *= 2
        self.n_fft = n_fft
        self._init_fbank()
        if cfg.use_hamming:
            a = 2.0 * np.pi / (self.frame_len - 1)
            self.window = (0.54 - 0.46 * np.cos(
                a * np.arange(self.frame_len))).astype(np.float64)
        else:
            self.window = None

    # -- mel filterbank (HTK InitFBank scheme) --------------------------
    @staticmethod
    def _mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    def _init_fbank(self):
        cfg = self.cfg
        lo = 0.0 if cfg.lofreq < 0 else cfg.lofreq
        hi = self.fs / 2.0 if cfg.hifreq < 0 else cfg.hifreq
        if not (0 <= lo < hi <= self.fs / 2.0 + 1e-9):
            raise ValueError(f"bad LOFREQ/HIFREQ: {lo}..{hi} at fs={self.fs}")
        mlo, mhi = self._mel(lo), self._mel(hi)
        P = cfg.numchans
        # channel centres equally spaced on mel INCLUDING the edges:
        # cf[0]=mlo, cf[1..P] centres, cf[P+1]=mhi
        cf = mlo + (mhi - mlo) * np.arange(P + 2) / (P + 1)
        # FFT bins (skip DC), triangle weights between adjacent centres
        k = np.arange(1, self.n_fft // 2 + 1)
        fk = k * self.fs / self.n_fft
        mk = self._mel(fk)
        in_range = (fk >= lo) & (fk <= hi)
        # channel index c such that cf[c] <= mk < cf[c+1]  (c in 0..P)
        c = np.clip(np.searchsorted(cf, mk, side="right") - 1, 0, P)
        lo_wt = (cf[c + 1] - mk) / np.maximum(cf[c + 1] - cf[c], 1e-12)
        # weight matrix (P, n_bins): bin k adds lo_wt to channel c and
        # (1-lo_wt) to channel c+1 (channel 0 / P+1 contributions drop)
        W = np.zeros((P, k.shape[0]))
        for j in range(k.shape[0]):
            if not in_range[j]:
                continue
            ch = int(c[j])
            if 1 <= ch <= P:
                W[ch - 1, j] += lo_wt[j]
            if 1 <= ch + 1 <= P:
                W[ch, j] += 1.0 - lo_wt[j]
        self.fbank_weights = W

        if self.base == PARMKIND_MFCC:
            i = np.arange(1, cfg.numceps + 1)
            j = np.arange(1, P + 1)
            self.dct = (np.sqrt(2.0 / P) * np.cos(
                np.pi * i[:, None] * (j[None, :] - 0.5) / P))
            L = cfg.ceplifter
            self.lifter = (1.0 + (L / 2.0) * np.sin(np.pi * i / L)
                           if L > 0 else np.ones_like(i, np.float64))

    # -- per-utterance extraction ---------------------------------------
    def extract(self, samples: np.ndarray) -> np.ndarray:
        """samples: 1-D int16/float array → (T, D) float32 features."""
        cfg = self.cfg
        s = np.asarray(samples, np.float64)
        n = s.shape[0]
        if n < self.frame_len:
            raise ValueError(
                f"waveform too short: {n} samples < frame {self.frame_len}")
        T = (n - self.frame_len) // self.frame_shift + 1
        idx = (np.arange(T)[:, None] * self.frame_shift
               + np.arange(self.frame_len)[None, :])
        frames = s[idx]                                   # (T, N)
        if cfg.zmean_source:
            frames = frames - frames.mean(axis=1, keepdims=True)

        want_E = bool(self.kind & PARMKIND_E)
        if want_E and cfg.raw_energy:
            energy = np.log(np.maximum(np.sum(frames * frames, axis=1),
                                       1e-10))
        # pre-emphasis within the frame (HSigP PreEmphasise: descending
        # in place, s[0] *= (1-k))
        if cfg.preemcoef > 0:
            pre = np.empty_like(frames)
            pre[:, 1:] = frames[:, 1:] - cfg.preemcoef * frames[:, :-1]
            pre[:, 0] = frames[:, 0] * (1.0 - cfg.preemcoef)
            frames = pre
        if self.window is not None:
            frames = frames * self.window[None, :]
        if want_E and not cfg.raw_energy:
            energy = np.log(np.maximum(np.sum(frames * frames, axis=1),
                                       1e-10))

        spec = np.abs(np.fft.rfft(frames, self.n_fft, axis=1))[:, 1:]
        if cfg.use_power:
            spec = spec * spec
        bins = spec @ self.fbank_weights.T                # (T, P)

        if self.base == PARMKIND_MELSPEC:
            stat = bins
        else:
            logm = np.log(np.maximum(bins, cfg.melfloor))
            if self.base == PARMKIND_FBANK:
                stat = logm
            else:
                ceps = (logm @ self.dct.T) * self.lifter[None, :]
                cols = [ceps]
                if self.kind & PARMKIND_0:
                    c0 = np.sqrt(2.0 / cfg.numchans) * logm.sum(axis=1)
                    cols.append(c0[:, None])
                stat = np.concatenate(cols, axis=1)

        if want_E:
            if cfg.enormalise:
                emax = energy.max()
                efloor = emax - (cfg.silfloor * np.log(10.0)) / 10.0
                energy = 1.0 - (emax - np.maximum(energy, efloor)) \
                    * cfg.escale
            stat = np.concatenate([stat, energy[:, None]], axis=1)

        if self.kind & PARMKIND_Z:
            # utterance CMN over the static coefficients except energy
            ncmn = stat.shape[1] - int(want_E)
            stat[:, :ncmn] -= stat[:, :ncmn].mean(axis=0, keepdims=True)

        out = [stat]
        wins = [self.cfg.deltawindow, self.cfg.accwindow,
                self.cfg.thirdwindow]
        n_deriv = (3 if self.kind & PARMKIND_T else
                   2 if self.kind & PARMKIND_A else
                   1 if self.kind & PARMKIND_D else 0)
        for o in range(n_deriv):
            out.append(htk_regression_deltas(out[-1], wins[o]))
        return np.concatenate(out, axis=1).astype(np.float32)

    @property
    def sample_period(self) -> int:
        return int(round(self.cfg.target_rate))

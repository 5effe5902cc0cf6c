"""ctypes binding for the native MPE lattice-FB engine (native/mpefb.cc).

Same g++-on-demand pattern as io/native.py: the shared library compiles
on first use into the per-user cache, and every caller has the NumPy
engine as a pure-Python fallback (``MpeComputer(engine="numpy")``).  The
native engine replicates train/mpe.py's recursions operation for
operation (reference: Decoder.tcc:2443-2578, TMpeCu.cc:461-672); parity
is gated by tests/test_mpe.py.

The port's copy of ``nnet_asr_tpu/train/mpe_native.py``: it builds the
port's own ``native/mpefb.cc`` into ``build/native/`` beside the package
(``io/native.py``'s ``CACHE_DIR``), so neither package loads the other's
library; behaviour otherwise unchanged.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..io.native import CACHE_DIR

_lock = threading.Lock()
_lib = None
_tried = False

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)


def _source_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "native", "mpefb.cc")


def _build_lib():
    try:
        os.makedirs(CACHE_DIR, exist_ok=True)
    except OSError:
        return None
    so = os.path.join(CACHE_DIR, "libmpefb.so")
    src = _source_path()
    if (os.path.exists(so)
            and os.path.getmtime(so) >= os.path.getmtime(src)):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"     # per-pid: concurrent cold-cache
    try:                                # builds must not corrupt the .so
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, src],
            check=True, capture_output=True)
        os.replace(tmp, so)
        return so
    except Exception:
        return None


def get_lib():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build_lib()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.mpe_fb.argtypes = [
            ctypes.c_int64, _f64p,                       # nodes
            ctypes.c_int64, _i32p, _i32p, _f64p, _i32p,  # arcs
            _i32p, _i32p,                                # t0/t1
            ctypes.c_int32, _i32p, _i64p, _i32p, _i64p, _f64p,  # hmm table
            ctypes.c_int64, ctypes.c_int64, _f64p, ctypes.c_double,  # post
            ctypes.c_int64, _f64p, _f64p, _i32p,         # segments
            ctypes.c_double, ctypes.c_int32, ctypes.c_double,  # beam/ml/ocp
            ctypes.c_double, _f64p,                      # utt_w / frame_w
            _f64p, _f64p,                                # gammas / out2
        ]
        lib.mpe_fb.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _p(a, ptr_t):
    return a.ctypes.data_as(ptr_t)


class NativeTables:
    """Per-MpeComputer flattened HMM table: state counts, senone id
    lists, and the transp-scaled log transition matrices, verbatim from
    MpeComputer's caches so both engines see identical bits."""

    def __init__(self, hmm_names, senone_cache, log_tp):
        self.id_of = {nm: i for i, nm in enumerate(hmm_names)}
        n = len(hmm_names)
        self.h_S = np.empty(n, np.int32)
        sen_off = np.empty(n, np.int64)
        tp_off = np.empty(n, np.int64)
        sens, tps = [], []
        so = to = 0
        for i, nm in enumerate(hmm_names):
            ids = senone_cache[nm]
            tp = np.ascontiguousarray(log_tp[nm], np.float64)
            self.h_S[i] = tp.shape[0] - 2
            if len(ids) != tp.shape[0] - 2:
                raise ValueError(
                    f"HMM {nm}: {len(ids)} senones vs "
                    f"{tp.shape[0] - 2} emitting states")
            sen_off[i] = so
            tp_off[i] = to
            sens.append(np.asarray(ids, np.int32))
            tps.append(tp.ravel())
            so += len(ids)
            to += tp.size
        self.h_sen = (np.concatenate(sens) if sens
                      else np.empty(0, np.int32)).astype(np.int32)
        self.h_tp = (np.concatenate(tps) if tps
                     else np.empty(0, np.float64))
        self.h_sen_off = sen_off
        self.h_tp_off = tp_off
        # seg phones outside the HMM set can never match an arc phone;
        # give them stable codes < -1
        self._extra_codes = {}

    def seg_code(self, phone: str) -> int:
        c = self.id_of.get(phone)
        if c is not None:
            return c
        c = self._extra_codes.get(phone)
        if c is None:
            c = -2 - len(self._extra_codes)
            self._extra_codes[phone] = c
        return c


def flatten_lattice(lat, tables: NativeTables):
    """Lattice → flat arrays for the native engine (weight-independent,
    so tmpe's prefetch pool can run it ahead of the training loop).
    Cached on the lattice object keyed by the table identity."""
    cached = getattr(lat, "_native_flat", None)
    if cached is not None and cached[0] is tables:
        return cached[1]
    n = len(lat.nodes)
    m = len(lat.arcs)
    times = np.fromiter((nd.time for nd in lat.nodes), np.float64, n)
    a_start = np.fromiter((a.start for a in lat.arcs), np.int32, m)
    a_end = np.fromiter((a.end for a in lat.arcs), np.int32, m)
    a_lm = np.fromiter((a.lm for a in lat.arcs), np.float64, m)
    a_prior = np.fromiter((a.prior for a in lat.arcs), np.float64, m)
    a_hmm = np.empty(m, np.int32)
    id_of = tables.id_of
    for i, a in enumerate(lat.arcs):
        ph = lat.arc_word(a)
        if ph is None or ph in ("!NULL", "<s>", "</s>"):
            a_hmm[i] = -1
        else:
            hid = id_of.get(ph)
            if hid is None:
                raise KeyError(f"Phone '{ph}' not in HMM set")
            a_hmm[i] = hid
    flat = (times, a_start, a_end, a_lm, a_prior, a_hmm)
    try:
        lat._native_flat = (tables, flat)
    except AttributeError:
        pass                     # frozen lattice types: just recompute
    return flat


def compute_native(lat, log_post, ref_segments, tables: NativeTables,
                   cfg, kappa: float, utt_weight: float = 1.0,
                   frame_weights=None, beam=None):
    """Native-engine equivalent of MpeComputer.compute()'s post-expansion
    body. Returns (gammas f32 (T, C), c_avg, logZ); raises
    FloatingPointError on lattice-FB underflow like the NumPy engine."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native mpefb unavailable")
    T, C = log_post.shape
    times, a_start, a_end, a_lm, a_prior, a_hmm = \
        flatten_lattice(lat, tables)
    n, m = times.shape[0], a_start.shape[0]

    if m and (a_start.min() < 0 or a_start.max() >= n
              or a_end.min() < 0 or a_end.max() >= n):
        raise ValueError("lattice arc references a node out of range")
    if tables.h_sen.size and int(tables.h_sen.max()) >= C:
        # the numpy engine raised a clean IndexError here; the C++
        # engine would read out of bounds (mismatched model/phone list)
        raise ValueError(
            f"HMM senone id {int(tables.h_sen.max())} >= NN output "
            f"width {C} (wrong --HMM / output label map?)")
    if frame_weights is not None and len(frame_weights) < T:
        raise ValueError(
            f"frame_weights length {len(frame_weights)} < T={T}")
    sh0 = int(round(cfg.start_time_shift * cfg.frame_rate))
    sh1 = int(round(cfg.end_time_shift * cfg.frame_rate))
    nframe = np.rint(times * cfg.frame_rate).astype(np.int64)
    t0s = np.clip(nframe[a_start] + sh0, 0, T).astype(np.int32)
    t1s = np.clip(nframe[a_end] + sh1, 0, T).astype(np.int32)
    phone_arc = a_hmm >= 0
    bad = phone_arc & (t1s <= t0s)
    if np.any(bad):
        i = int(np.nonzero(bad)[0][0])
        nm = [nm for nm, hid in tables.id_of.items()
              if hid == a_hmm[i]][0]
        raise ValueError(f"Zero-length arc for phone {nm}")
    a_base = cfg.lm_scale * a_lm + a_prior
    if cfg.model_penalty != 0.0:
        a_base = a_base + np.where(phone_arc, cfg.model_penalty, 0.0)
    a_base = np.ascontiguousarray(a_base, np.float64)

    nseg = len(ref_segments)
    seg_t0 = np.fromiter((s[0] for s in ref_segments), np.float64, nseg)
    seg_t1 = np.fromiter((s[1] for s in ref_segments), np.float64, nseg)
    seg_code = np.fromiter((tables.seg_code(s[2]) for s in ref_segments),
                           np.int32, nseg)

    log_post = np.ascontiguousarray(log_post, np.float64)
    fw = None
    if frame_weights is not None:
        fw = np.ascontiguousarray(frame_weights, np.float64)
    gammas = np.zeros(T * C, np.float64)
    out2 = np.zeros(2, np.float64)
    beam_v = 0.0 if beam is None else float(beam)

    rc = lib.mpe_fb(
        n, _p(times, _f64p),
        m, _p(a_start, _i32p), _p(a_end, _i32p), _p(a_base, _f64p),
        _p(a_hmm, _i32p), _p(t0s, _i32p), _p(t1s, _i32p),
        len(tables.h_S), _p(tables.h_S, _i32p),
        _p(tables.h_sen_off, _i64p), _p(tables.h_sen, _i32p),
        _p(tables.h_tp_off, _i64p), _p(tables.h_tp, _f64p),
        T, C, _p(log_post, _f64p), float(kappa),
        nseg, _p(seg_t0, _f64p), _p(seg_t1, _f64p), _p(seg_code, _i32p),
        beam_v, int(cfg.ml_gamma), float(cfg.occup_scale),
        float(utt_weight),
        _p(fw, _f64p) if fw is not None else None,
        _p(gammas, _f64p), _p(out2, _f64p))
    if rc == 1:
        raise FloatingPointError("lattice forward-backward underflow "
                                 "(overpruning?)")
    if rc == 3:
        raise ValueError("zero-duration arc cycle in lattice")
    if rc != 0:
        raise RuntimeError(f"native mpe_fb failed (rc={rc})")
    return (gammas.reshape(T, C).astype(np.float32),
            float(out2[0]), float(out2[1]))

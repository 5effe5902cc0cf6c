"""Build the hand-written CUDA kernels and bind them with ctypes.

``nnet_asr_torch/csrc/*.cu`` compile with ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, at first use, under
``build/kernels/`` at the repository root: one ``nvcc -c`` per source, all
started together, then one link. The file name carries a hash of the
sources (``*.cuh`` included) and flags, so an edited source builds anew.
The library is written to a per-process temporary file and moved into
place with ``os.replace`` (the pattern of ``io/native.py``),
so concurrent cold builds never load a half-written file. A failed build
raises; nothing is fetched and nothing but the package's own sources is
compiled. ``build_log`` keeps ptxas's per-kernel register and spill report.

Each C entry point returns ``cudaGetLastError()`` after its launches; the
wrappers raise on a non-zero code. ``counters`` keeps the int32 counters
of the kernels whose last block finishes a reduction (softmax-CE's
ticket, the split-K GEMMs' one a tile): one zeroed buffer per (device,
stream), which every such launch leaves at zero again, so launches on one
stream share it and launches on other streams never do.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

from . import tile_plan

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: (argtypes, restype = int cudaError_t)
SIGNATURES = {
    # x, w, b, y, M, N, K, act, tile, x_bytes, w_bytes, splits, k_chunk,
    # part, counters, stream
    "matmul_act_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # the same, bf16
    "matmul_act_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # bf16 on the CP_WGMMA route: x, w, b, y, M, N, K, act, x_bytes, w_bytes,
    # splits, k_chunk, part, counters, stream
    "matmul_act_bf16_cp_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # f32 on the CP_WGMMA route: the same arguments
    "matmul_act_f32_cp_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # bf16 on the WGMMA route: x, w, b, y, M, N, K, act, stream
    "matmul_act_bf16_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # f32 on the WGMMA route: x, w, b, y, xhi, xlo, M, N, K, act, blocks,
    # stream
    "matmul_act_f32_wgmma": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # logits, labels, err, part, ticket, xent, corr, B, C, variant, blocks,
    # threads, vpt, vec, stream
    "softmax_xent_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, e, p, v, part, counters, a, m, B, In, Out, v_is_bf16, tile, splits,
    # k_chunk, x_bytes, e_bytes, stream
    "wgrad_momentum_update_f32": [_P, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _P],
    # the same, bf16 x and e
    "wgrad_momentum_update_bf16": [_P, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _P],
    # bf16 x and e on the CP_WGMMA route: x, e, p, v, a, m, B, In, Out,
    # v_is_bf16, rows, splits, k_chunk, x_bytes, e_bytes, stream
    "wgrad_momentum_update_bf16_cp_wgmma": [_P, _P, _P, _P, _F, _F, _I, _I, _I, _I, _I, _I, _I,
                                            _I, _I, _P],
    # bf16 x and e on the WGMMA route: x, e, p, v, a, m, B, In, Out,
    # v_is_bf16, blocks, stream
    "wgrad_momentum_update_bf16_wgmma": [_P, _P, _P, _P, _F, _F, _I, _I, _I, _I, _I, _P],
    # f32 x and e on the CP_WGMMA route: x, e, p, v, part, counters, a, m,
    # B, In, Out, v_is_bf16, splits, k_chunk, x_bytes, e_bytes, stream
    "wgrad_momentum_update_f32_cp_wgmma": [_P, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _I, _I,
                                           _I, _I, _I, _P],
    # f32 x and e on the WS_WGMMA route: x, e, p, v, a, m, B, In, Out,
    # v_is_bf16, splits, k_chunk, x_bytes, e_bytes, stream
    "wgrad_momentum_update_f32_ws_wgmma": [_P, _P, _P, _P, _F, _F, _I, _I, _I, _I, _I, _I, _I,
                                           _I, _P],
    # f32 x and e on the WGMMA route: x, e, p, v, xhi, xlo, a, m, B, In,
    # Out, v_is_bf16, blocks, stream
    "wgrad_momentum_update_f32_wgmma": [_P, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _I, _I,
                                        _P],
    # the f32 input gradient dx = dz w^T on the WGMMA route: dz, w, dx, dzhi,
    # dzlo, M, In, Out, blocks, stream
    "dgrad_f32_wgmma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the nvcc calls, if they ran
build_log = ""                          # ptxas's report of the last build


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin)")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libnnet_asr_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds):
    """Run the commands concurrently; raise naming every one that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)) for cmd in cmds]
    logs, failed = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        logs.append(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def _build(so: str) -> None:
    global build_seconds, build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in _sources()]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                        for obj, src in zip(objs, _sources())])
        log += _run_all([[nvcc, *ARCH, "-shared", "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    build_log = log


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.nnet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.nnet_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


COUNTERS = 1024          # ints in a counters buffer: one a split tile
_counters: dict = {}
_counters_lock = threading.Lock()


def counters(dev, stream):
    """The zeroed int32 counters (``COUNTERS`` of them) of ``stream`` on
    ``dev``, allocated on that stream at its first use."""
    import torch

    key = (dev.index, stream.cuda_stream)
    with _counters_lock:
        if key not in _counters:
            with torch.cuda.stream(stream):
                _counters[key] = torch.zeros(COUNTERS, dtype=torch.int32, device=dev)
        return _counters[key]


def split_args(p: tile_plan.Plan, dev, stream):
    """(scratch, (splits, k_chunk, part, counters)) of a ``MMA_SYNC`` or
    ``CP_WGMMA`` launch: with split-K an f32 scratch of ``blocks`` partial
    tiles, allocated here (the caller holds it until the launch is queued), and
    the stream's zeroed counters (``counters``); else no scratch
    and null pointers."""
    import torch

    if p.splits == 1:
        return None, (1, p.k_chunk, None, None)
    if p.blocks // p.splits > COUNTERS:
        raise ValueError(f"split-K over {p.blocks // p.splits} tiles: {COUNTERS} counters")
    part = torch.empty(p.blocks * p.bm * p.bn, dtype=torch.float32, device=dev)
    return part, (p.splits, p.k_chunk, part.data_ptr(),
                  counters(dev, stream).data_ptr())


def check(code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if code != 0:
        name = load_library().nnet_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({name}) at launch")

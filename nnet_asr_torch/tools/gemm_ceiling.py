"""What holds the 3xTF32 GEMM main loop back: the kernels beside two variants.

    python -m nnet_asr_torch.tools.gemm_ceiling [--reps N]

Builds ``csrc/`` three times, each into its own directory under
``build/gemm_ceiling/``, and times ``matmul_act`` (no activation) at
1024x4096->4096 and ``wgrad_momentum_update`` at 1024x4096->8192 with each
build, in turns, by CUDA events:

  3xtf32         the kernels as they are;
  3pass_nosplit  the same three mma.sync per tile with the raw f32 bits as
                 both hi and lo (no split work; the results are wrong): the
                 tensor-core issue of the main loop alone;
  1pass          one mma.sync per tile, no split: plain one-pass TF32
                 (three decimal digits; not f32-accurate).

The gap between the first two is the hi/lo split's cost; the second against
the 3xTF32 bound is what mma.sync's issue rate allows. Needs the card and
nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import shutil
import subprocess
import sys

import torch

from ..ops.kernels import _build
from ..ops.kernels import matmul_act as MA
from ..ops.kernels import sgd_fused as SF

SPLIT = "  hi = rna_tf32(x);\n  lo = rna_tf32(x - __uint_as_float(hi));"
RAW = "  hi = __float_as_uint(x);\n  lo = hi;"
MMA3 = ("        mma_tf32(acc[i][j], alo[i], bhi);\n"
        "        mma_tf32(acc[i][j], ahi[i], blo);\n"
        "        mma_tf32(acc[i][j], ahi[i], bhi);")
MMA1 = "        mma_tf32(acc[i][j], ahi[i], bhi);"
VARIANTS = {"3xtf32": [], "3pass_nosplit": [(SPLIT, RAW)],
            "1pass": [(SPLIT, RAW), (MMA3, MMA1)]}


def build_variant(name, subs, root):
    """Compile csrc/ with the text substitutions ``subs`` in tile_gemm.cuh."""
    d = os.path.join(root, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    path = os.path.join(d, "tile_gemm.cuh")
    with open(path) as f:
        src = f.read()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{name}: tile_gemm.cuh no longer holds {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(d, "lib.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
           *sorted(os.path.join(d, s) for s in os.listdir(d) if s.endswith(".cu"))]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(so):
    lib = ctypes.CDLL(so)
    for fn, argtypes in _build.SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.nnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def event_us(fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gemm_ceiling")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_ceiling: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.path.join(os.path.dirname(_build.BUILD_DIR), "gemm_ceiling")
    builds = {name: build_variant(name, subs, root) for name, subs in VARIANTS.items()}
    libs = {}
    for name, (so, proc) in builds.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = load(so)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    M, K, N = 1024, 4096, 4096
    x = torch.randn((M, K), generator=gen, device=dev)
    w = torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)
    b = torch.zeros((N,), device=dev)
    B, In, Out = 1024, 4096, 8192
    xs = torch.randn((B, In), generator=gen, device=dev)
    es = torch.randn((B, Out), generator=gen, device=dev) / math.sqrt(B)
    p, v = torch.zeros((In, Out), device=dev), torch.zeros((In, Out), device=dev)
    cases = [(f"matmul_act {M}x{K}->{N}", 2.0 * M * N * K,
              lambda: MA.matmul_act(x, w, b, "none")),
             (f"wgrad_momentum_update {B}x{In}->{Out}", 2.0 * B * In * Out,
              lambda: SF.wgrad_momentum_update(xs, es, p, v, 0.0, 0.0))]
    saved = _build._lib
    try:
        for turn in range(2):
            for name, lib in (libs.items() if turn == 0 else reversed(libs.items())):
                _build._lib = lib
                row = []
                for what, flops, fn in cases:
                    us = event_us(fn, args.reps)
                    row.append(f"{what} {us:.1f} us ({flops / us / 1e6:.1f} TFLOP/s)")
                print(f"gemm_ceiling turn {turn} {name}: " + "; ".join(row))
    finally:
        _build._lib = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())

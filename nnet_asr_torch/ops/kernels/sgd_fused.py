"""Fused weight gradient + momentum SGD update, in place.

Replaces the TPU kernel ``nnet_asr_tpu/ops/pallas/sgd_fused.py``
(``wgrad_momentum_update``) with the hand-written CUDA kernel
``nnet_asr_torch/csrc/sgd_fused.cu``. One pass computes, for one weight
matrix ``p`` with velocity ``v``::

    g = x^T e;  corr = g + m*v;  v <- corr;  p <- p - a*corr

from the layer's input ``x`` (B, In) and its pre-activation error ``e``
(B, Out), so the gradient never reaches device memory. It is the momentum
branch of ``train.sgd.apply_updates`` for a matrix (``a = lr/N``); the L2
decay stays outside, after it. ``tile_plan.plan`` picks the kernel (its
route) from the shapes, pointers and element size:

- f32 ``x`` and ``e`` at the recipes' widths (MLP3's 960x598->1024, and any
  whose 128x128 tiles would not fill the card; the plan's CP_WGMMA route):
  ``csrc/cp_tf32_wgmma.cuh``'s loop, 3xTF32 ``wgmma`` fed by ``cp.async``,
  ``g^T = e^T x`` with e split in registers and x transposed and split in
  shared memory by the block, the bunch split where the tiles leave SMs
  idle, the partials reduced in the same launch;
- the f32 weight gradient of an odd Out the WS_WGMMA kernel of the same
  file is built for (``tile_plan.ws_f32_takes``: MLP3's 960x1024->135):
  ``g = x^T e`` with Out on ``wgmma``'s N, 136 wide, a producer warpgroup
  copying e's rows and transposing and splitting them, the splits of a
  tile one cluster; any other odd Out (TIMIT's 39) keeps
  ``csrc/tile_gemm.cuh``'s ``mma.sync`` loop;
- f32 ``x`` and ``e`` that TMA can read and whose 128x128 tiles fill the
  card (the production stack's weights; the plan's WGMMA route):
  ``csrc/tf32_wgmma.cuh``, 3xTF32 ``wgmma`` + TMA, ``g^T = e^T x`` with e
  split in registers and x transposed and split by a pre-pass kernel into
  scratch allocated here, a persistent grid whose two consumer warpgroups
  take turns, so that one's p and v update overlaps the other's ``wgmma``;
  two launches a call;
- bf16 ``x`` and ``e`` that TMA can read: ``csrc/wgmma_gemm.cuh``, the same
  schedule with one bf16 pass;
- bf16 ``x`` and ``e`` off TMA in whole 4-byte units (MLP3's 960x598->1024,
  and 960x1024->135, whose e rows of 270 bytes are copied a stage of whole
  rows at a time; the plan's CP_WGMMA route, ``tile_plan.cp_wgrad_tile``):
  ``csrc/cp_wgmma.cuh``'s weight-gradient loop, ``g = x^T e`` by bf16
  ``wgmma`` fed by ``cp.async`` with In on its M and Out on its N (64x64
  column tiles, or one 64x136 tile across an Out of at most 136), each
  tile's splits one cluster that sums their partials through distributed
  shared memory, with no scratch;
- the rest (bf16 rows of odd pitch in 2-byte units, f32 off TMA at the BIG
  tile's size): ``csrc/tile_gemm.cuh``'s ``mma.sync`` loop (3xTF32 for f32,
  one bf16 pass for bf16), split-K on its 64x64 tile with the partials in
  scratch allocated here, the last block of a tile summing them in a fixed
  order.

bf16 ``x`` and ``e`` (the bf16 compute mode's) accumulate g in f32 and
round it to bf16 once after the whole sum, as JAX's bf16 ``dW``, before the
f32 update. With f32 ``x`` and ``e`` the update is bound by operations at
the production stack's widths; with bf16 ones by the bytes of p and v; at
example-01's widths by latency.

Unlike the JAX function, which returns ``(p_new, v_new)``, this one
updates ``p`` and ``v`` IN PLACE, as the port's ``apply_updates`` does.
``wgrad_momentum_update`` checks its operands, then dispatches on their
device: CPU tensors take the plain PyTorch version
(``wgrad_momentum_update_plain``), CUDA tensors launch the kernel or raise —
there is no fallback. Each launch counts in ``_build.LAUNCHES`` under its
entry point's name, which names the dtype and the route
(``wgrad_momentum_update_{f32,bf16}[_wgmma|_cp_wgmma]``,
``wgrad_momentum_update_f32_ws_wgmma``).
"""

from __future__ import annotations

import torch

from ...utils.profiler import profiler
from . import _build, tile_plan

_DTYPES = (torch.float32, torch.bfloat16)


@torch.no_grad()
def wgrad_momentum_update_plain(x: torch.Tensor, e: torch.Tensor, p: torch.Tensor,
                                v: torch.Tensor, a: float, m: float) -> None:
    """The plain PyTorch version: the same update, in place, in f32
    (``v`` is stored back at its own dtype); bf16 ``x`` and ``e`` are
    multiplied in f32 and ``g`` rounded to bf16 before the update."""
    g = x.T.float() @ e.float()
    if x.dtype == torch.bfloat16:
        g = g.to(torch.bfloat16).float()
    corr = g + v.float() * m
    v.copy_(corr)
    p.sub_(corr * a)


def _check(x, e, p, v):
    if p.dtype != torch.float32:
        raise TypeError(f"wgrad_momentum_update: p must be float32, got {p.dtype}")
    if x.dtype not in _DTYPES or e.dtype != x.dtype:
        raise TypeError(f"wgrad_momentum_update: x and e must both be float32 or both "
                        f"bfloat16, got {x.dtype} and {e.dtype}")
    if v.dtype not in _DTYPES:
        raise TypeError(f"wgrad_momentum_update: v must be float32 or bfloat16, got {v.dtype}")
    for name, t in (("x", x), ("e", e), ("p", p), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"wgrad_momentum_update: {name} must be contiguous")
        if t.device != p.device:
            raise ValueError(f"wgrad_momentum_update: {name} on {t.device}, p on {p.device}")
    if (x.dim() != 2 or e.dim() != 2 or x.shape[0] != e.shape[0]
            or tuple(p.shape) != (x.shape[1], e.shape[1]) or v.shape != p.shape):
        raise ValueError(f"wgrad_momentum_update: want x (B,In), e (B,Out), p and v "
                         f"(In,Out); got {tuple(x.shape)}, {tuple(e.shape)}, "
                         f"{tuple(p.shape)}, {tuple(v.shape)}")
    if min(x.shape[0], x.shape[1], e.shape[1]) < 1:
        raise ValueError("wgrad_momentum_update: empty operand")


def wgrad_momentum_update(x: torch.Tensor, e: torch.Tensor, p: torch.Tensor,
                          v: torch.Tensor, a: float, m: float) -> None:
    """In place: v <- x^T e + m*v, then p <- p - a*v (before v's rounding
    to its dtype). x (B,In) and e (B,Out) both float32 or both bfloat16
    (then x^T e is rounded to bfloat16 first); p (In,Out) float32; v
    (In,Out) float32 or bfloat16."""
    _check(x, e, p, v)
    flops = 2.0 * x.shape[0] * x.shape[1] * e.shape[1]
    if p.device.type == "cpu":
        profiler.count(tile_plan.LIBRARY_FLOPS, flops)
        return wgrad_momentum_update_plain(x, e, p, v, a, m)
    if p.device.type != "cuda":
        raise ValueError(f"wgrad_momentum_update: unsupported device {p.device}")
    lib = _build.load_library()
    B, In = x.shape
    Out = e.shape[1]
    pl = tile_plan.plan(In, Out, B, a_pitch=In, b_pitch=Out, a_ptr=x.data_ptr(),
                        b_ptr=e.data_ptr(), wgrad=True, elem=x.element_size(),
                        out_ptrs=(p.data_ptr(), v.data_ptr()))
    profiler.count(tile_plan.ROUTE_FLOPS[pl.route], flops)
    stream = torch.cuda.current_stream(p.device)
    v_is_bf16 = int(v.dtype == torch.bfloat16)
    bf16 = x.dtype == torch.bfloat16
    if pl.route == tile_plan.WGMMA and not bf16:
        # x's transposed hi and lo copies (In, B), written by the pre-pass
        # (B is a multiple of 4 on this route: both halves 16-byte aligned)
        split = torch.empty((2, In, B), dtype=torch.float32, device=p.device)
        _build.check(lib.wgrad_momentum_update_f32_wgmma(
            x.data_ptr(), e.data_ptr(), p.data_ptr(), v.data_ptr(), split[0].data_ptr(),
            split[1].data_ptr(), float(a), float(m), B, In, Out, v_is_bf16, pl.blocks,
            stream.cuda_stream), "wgrad_momentum_update_f32_wgmma")
    elif pl.route == tile_plan.CP_WGMMA and bf16:
        _launch_bf16_cp_wgmma(lib, x, e, p, v, a, m, pl, stream)
    elif pl.route == tile_plan.CP_WGMMA:
        _launch_f32_cp_wgmma(lib, x, e, p, v, a, m, pl, stream)
    elif pl.route == tile_plan.WS_WGMMA:
        _launch_f32_ws_wgmma(lib, x, e, p, v, a, m, pl, stream)
    elif pl.route == tile_plan.WGMMA:
        _build.check(lib.wgrad_momentum_update_bf16_wgmma(
            x.data_ptr(), e.data_ptr(), p.data_ptr(), v.data_ptr(), float(a), float(m), B, In,
            Out, v_is_bf16, pl.blocks, stream.cuda_stream), "wgrad_momentum_update_bf16_wgmma")
    else:
        _scratch, (splits, k_chunk, part, counters) = _build.split_args(pl, p.device, stream)
        fn, name = ((lib.wgrad_momentum_update_bf16, "wgrad_momentum_update_bf16") if bf16
                    else (lib.wgrad_momentum_update_f32, "wgrad_momentum_update_f32"))
        _build.check(fn(x.data_ptr(), e.data_ptr(), p.data_ptr(), v.data_ptr(), part, counters,
                        float(a), float(m), B, In, Out, v_is_bf16, pl.tile, splits, k_chunk,
                        pl.a_bytes, pl.b_bytes, stream.cuda_stream), name)
    # written through a raw pointer: bump the versions as an in-place op
    # would, so autograd refuses a saved copy of p or v from before
    for t in (p, v):
        torch.autograd.graph.increment_version(t)


def _launch_f32_cp_wgmma(lib, x, e, p, v, a, m, pl, stream):
    """Launch the f32 CP_WGMMA kernel by plan ``pl`` (a CP_WGMMA plan of
    ``tile_plan.plan``, or one a measurement forces: its bm and bn those of
    the tile the library was built with)."""
    B, In = x.shape
    _scratch, (splits, k_chunk, part, counters) = _build.split_args(pl, p.device, stream)
    _build.check(lib.wgrad_momentum_update_f32_cp_wgmma(
        x.data_ptr(), e.data_ptr(), p.data_ptr(), v.data_ptr(), part, counters, float(a),
        float(m), B, In, e.shape[1], int(v.dtype == torch.bfloat16), splits, k_chunk,
        pl.a_bytes, pl.b_bytes, stream.cuda_stream), "wgrad_momentum_update_f32_cp_wgmma")


def _launch_f32_ws_wgmma(lib, x, e, p, v, a, m, pl, stream):
    """Launch the f32 WS_WGMMA kernel (g = x^T e with Out on wgmma's N) by
    plan ``pl``, as ``_launch_f32_cp_wgmma``."""
    B, In = x.shape
    _build.check(lib.wgrad_momentum_update_f32_ws_wgmma(
        x.data_ptr(), e.data_ptr(), p.data_ptr(), v.data_ptr(), float(a), float(m), B, In,
        e.shape[1], int(v.dtype == torch.bfloat16), pl.splits, pl.k_chunk, pl.a_bytes,
        pl.b_bytes, stream.cuda_stream), "wgrad_momentum_update_f32_ws_wgmma")


def _launch_bf16_cp_wgmma(lib, x, e, p, v, a, m, pl, stream):
    """Launch the bf16 CP_WGMMA kernel (g = x^T e with In on wgmma's M) by
    plan ``pl`` (``tile_plan.plan``'s, or one a measurement forces: its
    tile ROWS or the column tile the library was built with); a tile's
    splits are one cluster, so no scratch."""
    B, In = x.shape
    _build.check(lib.wgrad_momentum_update_bf16_cp_wgmma(
        x.data_ptr(), e.data_ptr(), p.data_ptr(), v.data_ptr(), float(a), float(m), B, In,
        e.shape[1], int(v.dtype == torch.bfloat16), int(pl.tile == tile_plan.ROWS), pl.splits,
        pl.k_chunk, pl.a_bytes, pl.b_bytes, stream.cuda_stream),
        "wgrad_momentum_update_bf16_cp_wgmma")

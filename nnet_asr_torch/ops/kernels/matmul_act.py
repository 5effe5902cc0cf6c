"""Fused affine + sigmoid: y = sigmoid(x @ W + b), f32 or bf16 operands.

Replaces the TPU kernel ``nnet_asr_tpu/ops/pallas/matmul_act.py``
(``matmul_act`` / custom-VJP ``affine_sigmoid``) with the hand-written
CUDA kernel ``nnet_asr_torch/csrc/matmul_act.cu``: the tensor-core GEMM of
``csrc/tile_gemm.cuh`` (3xTF32 ``mma.sync`` for f32 operands, f32-accurate;
one bf16 ``mma.sync`` pass for bf16 ones, accumulated in f32) fed by a
``cp.async`` ring, with the bias + sigmoid epilogue in registers, in f32.
bf16 operands that TMA can read (``tile_plan``'s WGMMA route: every
production shape) go to ``csrc/wgmma_gemm.cuh`` instead: ``wgmma`` on
128x256 tiles fed by TMA through a warp-specialised ring, y written by TMA
stores. f32 operands on that route (TMA-readable, and the 128x128 tiles
filling the card: the production stack's 1024x{1024,4096}->4096) go to
``csrc/tf32_wgmma.cuh``: 3xTF32 on ``wgmma``, W split in registers, x
split into hi and lo copies by a pre-pass kernel into scratch allocated
here, two launches a call. bf16 operands whose rows TMA cannot read but
whose pitches and bases are whole 4-byte units (``tile_plan``'s CP_WGMMA
route: MLP3's 598-wide x, TIMIT's 500-wide W and y) go to
``csrc/cp_wgmma.cuh``: ``wgmma`` fed by ``cp.async`` copies into the
swizzled layout its descriptors read, split-K in the same launch where
the tiles leave SMs idle; a bf16 row of odd pitch stays on ``mma.sync``.
f32 operands at every shape the f32 WGMMA route leaves whose 128x128
tiles would not fill the card (``tile_plan``'s CP_WGMMA route at 4 bytes:
every f32 forward of the recipes) go to ``csrc/cp_tf32_wgmma.cuh``:
3xTF32 on ``wgmma`` fed by ``cp.async``, W split in registers, x split
into hi and lo in shared memory by the block itself, tiles of 64 rows by
128 columns, one launch a call, split-K reduced in it.
As in the TPU kernel, ``y`` has x's dtype: bf16 y is the f32 result rounded
once. It is bound by operations, not bytes, at the main path's shapes
(960x598->1024 on example-01's MLP3, 1024x{1024,4096}->4096 on the
production stack); at the recipes' widths (960x598->1024, TIMIT's
1024x368->500, one tmpe utterance's rows) by latency, where ``tile_plan``
splits K and the last split to reach a tile sums the partials in the same
launch. ``tile_plan.plan`` picks the tile, the split and each operand's
copy width from the shapes, pointers and element size.

``matmul_act`` checks its operands, then dispatches on the tensor's
device: a CPU tensor runs the plain PyTorch version
(``matmul_act_plain``), a CUDA tensor launches the kernel or raises —
there is no fallback. Both devices refuse the same inputs: an unknown
``act`` (``ValueError``, as JAX's kernel raises), x, w and b of mixed or
other dtypes than float32 and bfloat16 (``TypeError``), shapes that do
not match or a non-contiguous operand (``ValueError``).
``matmul_act.launches`` counts f32 calls (every route),
``matmul_act.launches_f32_wgmma`` those of them on the WGMMA route,
``matmul_act.launches_bf16`` bf16 ones (every route),
``matmul_act.launches_bf16_wgmma`` those of them on the WGMMA route and
``matmul_act.launches_bf16_cp_wgmma`` those on the CP_WGMMA route,
``matmul_act.launches_f32_cp_wgmma`` the f32 calls on that route (also
counted in ``launches``). ``affine_sigmoid`` is the
``autograd.Function``; its backward is the JAX ``_bwd``, roundings
included: the elementwise ``dz`` in f32, rounded to x's dtype, then ``dx``
by ``dgrad`` and ``dW`` by ``torch.matmul`` (which JAX also left outside
Pallas; at bf16 both through ``bf16_matmul``, f32 accumulation), ``db``
summed from the f32 ``dz``. ``dgrad`` sends an f32 ``dx = dz W^T`` on the
card to the hand-written kernel of ``csrc/dgrad.cu`` (3xTF32 ``wgmma``, W
read K-major and split in registers, dz split by a pre-pass kernel into
scratch allocated here; two launches a call) where
``tile_plan.dgrad_plan`` takes the shape (the production stack's layers,
the SWB CD-DNN's one-wave grids),
and leaves every other ``dx`` to ``torch.matmul`` as before;
``dgrad.launches`` counts its kernel's calls. On the momentum path the
backward instead hands ``(x, dz)`` to a weight-update hook, which
launches the fused wgrad+momentum kernel
(``ops/kernels/sgd_fused.py``), and forms no ``dW``; ``affine`` is the
same for a BiasedLinearity without a sigmoid (at bf16 ``x @ w`` and ``+ b``
each rounded, as XLA computes the JAX bf16 mode's output layer). The
profiler's spans name the backward's products by purpose, whatever kernel
forms them: ``backward.dgrad`` around ``dx`` and ``backward.wgrad`` around
``dW`` or the weight-update hook (the Trainer's ``forward_body`` opens
``forward.output`` around the output layer's ``affine``). Where a
product's route is chosen (here, and in ``sgd_fused``), its operations
2·M·N·K go to the profiler's counter of that route,
``tile_plan.ROUTE_FLOPS``, or ``gemm.flops.library`` where the library
forms it.
"""

from __future__ import annotations

import torch

from ...utils.profiler import profiler
from . import _build, tile_plan

ACTS = {"none": 0, "sigmoid": 1}
DTYPES = (torch.float32, torch.bfloat16)


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for bf16 operands, accumulated in f32 and rounded to bf16
    once, as JAX's ``preferred_element_type=float32`` dots and XLA's bf16
    dots give it. On the CPU: an f32 product of the exact upcast values. On
    CUDA: cuBLAS's bf16 GEMM with its reduced-precision reductions switched
    off (``allow_bf16_reduced_precision_reduction``, a process-wide switch
    that is on by default), so every partial sum stays f32."""
    if a.device.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        return a @ b
    return (a.float() @ b.float()).to(torch.bfloat16)


def matmul_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     act: str = "sigmoid") -> torch.Tensor:
    """The plain PyTorch version of the kernel. bf16 operands: the f32
    product plus the f32 bias, the sigmoid in f32, then one rounding to
    bf16 (a bf16 ``x @ w + b`` would round twice)."""
    if x.dtype == torch.bfloat16:
        z = x.float() @ w.float() + b.float()
        return (torch.sigmoid(z) if act == "sigmoid" else z).to(torch.bfloat16)
    z = x @ w + b
    return torch.sigmoid(z) if act == "sigmoid" else z


def _check(x, w, b, act):
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    if x.dtype not in DTYPES:
        raise TypeError(f"matmul_act: x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != x.dtype:
            raise TypeError(f"matmul_act: {name} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"matmul_act: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"matmul_act: {name} on {t.device}, x on {x.device}")
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"matmul_act: want x (M,K), w (K,N), b (N,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    if x.shape[1] != w.shape[0] or b.shape[0] != w.shape[1]:
        raise ValueError(f"matmul_act: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} + {tuple(b.shape)} do not match")
    if min(x.shape[0], w.shape[0], w.shape[1]) < 1:
        raise ValueError("matmul_act: empty operand")


def matmul_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               act: str = "sigmoid") -> torch.Tensor:
    """act(x @ w + b): x (M,K), w (K,N), b (N,), all float32 or all
    bfloat16; y at their dtype."""
    _check(x, w, b, act)
    M, K = x.shape
    N = w.shape[1]
    if x.device.type == "cpu":
        profiler.count(tile_plan.LIBRARY_FLOPS, 2.0 * M * N * K)
        return matmul_act_plain(x, w, b, act)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_act: unsupported device {x.device}")
    lib = _build.load_library()
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    p = tile_plan.plan(M, N, K, a_pitch=K, b_pitch=N, a_ptr=x.data_ptr(),
                       b_ptr=w.data_ptr(), elem=x.element_size(), out_ptrs=(y.data_ptr(),))
    profiler.count(tile_plan.ROUTE_FLOPS[p.route], 2.0 * M * N * K)
    stream = torch.cuda.current_stream(x.device)
    args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), M, N, K, ACTS[act])
    bf16 = x.dtype == torch.bfloat16
    if p.route == tile_plan.CP_WGMMA:
        _launch_cp_wgmma(lib, x, w, b, y, act, p, stream)
        return y
    if p.route == tile_plan.WGMMA and bf16:
        _build.check(lib.matmul_act_bf16_wgmma(*args, stream.cuda_stream),
                     "matmul_act_bf16_wgmma")
        matmul_act.launches_bf16 += 1
        matmul_act.launches_bf16_wgmma += 1
        return y
    if p.route == tile_plan.WGMMA:
        # x's hi and lo copies, written by the pre-pass (M * K is a
        # multiple of 4 on this route: both halves 16-byte aligned)
        split = torch.empty((2, M, K), dtype=torch.float32, device=x.device)
        _build.check(lib.matmul_act_f32_wgmma(
            *args[:4], split[0].data_ptr(), split[1].data_ptr(), *args[4:], p.blocks,
            stream.cuda_stream), "matmul_act_f32_wgmma")
        matmul_act.launches += 1
        matmul_act.launches_f32_wgmma += 1
        return y
    fn, name = ((lib.matmul_act_bf16, "matmul_act_bf16") if bf16
                else (lib.matmul_act_f32, "matmul_act_f32"))
    _scratch, split = _build.split_args(p, x.device, stream)
    _build.check(fn(*args, p.tile, p.a_bytes, p.b_bytes, *split, stream.cuda_stream), name)
    if bf16:
        matmul_act.launches_bf16 += 1
    else:
        matmul_act.launches += 1
    return y


matmul_act.launches = 0
matmul_act.launches_f32_wgmma = 0
matmul_act.launches_bf16 = 0
matmul_act.launches_bf16_wgmma = 0
matmul_act.launches_bf16_cp_wgmma = 0
matmul_act.launches_f32_cp_wgmma = 0


def _launch_cp_wgmma(lib, x, w, b, y, act, p, stream):
    """Launch the CP_WGMMA kernel of x's dtype into ``y`` by plan ``p`` (a
    CP_WGMMA plan of ``tile_plan.plan``, or one a measurement forces: its
    bm and bn those of the tile the library was built with)."""
    M, K = x.shape
    N = w.shape[1]
    bf16 = x.dtype == torch.bfloat16
    name = "matmul_act_bf16_cp_wgmma" if bf16 else "matmul_act_f32_cp_wgmma"
    _scratch, split = _build.split_args(p, x.device, stream)
    _build.check(getattr(lib, name)(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), M, N, K, ACTS[act],
        p.a_bytes, p.b_bytes, *split, stream.cuda_stream), name)
    if bf16:
        matmul_act.launches_bf16 += 1
        matmul_act.launches_bf16_cp_wgmma += 1
    else:
        matmul_act.launches += 1
        matmul_act.launches_f32_cp_wgmma += 1


def dgrad(dz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input gradient ``dz @ w.T`` of a layer with weight ``w`` (In,
    Out) from its pre-activation error ``dz`` (M, Out), at their dtype:
    bf16 through ``bf16_matmul``; f32 on the card through
    ``dgrad_f32_wgmma`` where ``tile_plan.dgrad_plan`` takes the shape (the
    production stack's layers, the SWB CD-DNN's one-wave ones) and both
    operands are contiguous (dx is allocated here, 512-byte aligned by the
    caching allocator), else ``torch.matmul``."""
    flops = 2.0 * dz.shape[0] * dz.shape[-1] * w.shape[0]
    if dz.dtype == torch.bfloat16:
        profiler.count(tile_plan.LIBRARY_FLOPS, flops)
        return bf16_matmul(dz, w.T)
    p = None
    if (dz.device.type == "cuda" and dz.dtype == w.dtype == torch.float32
            and dz.dim() == w.dim() == 2 and dz.shape[1] == w.shape[1]
            and dz.is_contiguous() and w.is_contiguous() and w.device == dz.device):
        p = tile_plan.dgrad_plan(dz.shape[0], w.shape[0], w.shape[1], dz.data_ptr(),
                                 w.data_ptr())
    if p is None:
        profiler.count(tile_plan.LIBRARY_FLOPS, flops)
        return torch.matmul(dz, w.T)
    profiler.count(tile_plan.ROUTE_FLOPS[p.route], flops)
    (M, Out), In = dz.shape, w.shape[0]
    dx = torch.empty((M, In), dtype=torch.float32, device=dz.device)
    # dz's hi and lo copies, written by the pre-pass (M * Out is a multiple
    # of 4 on this route: both halves 16-byte aligned), by address: no
    # tensor op more on the host's path
    split = torch.empty(2 * M * Out, dtype=torch.float32, device=dz.device)
    hi = split.data_ptr()
    _build.check(_build.load_library().dgrad_f32_wgmma(
        dz.data_ptr(), w.data_ptr(), dx.data_ptr(), hi, hi + 4 * M * Out, M, In, Out,
        p.blocks, torch.cuda.current_stream(dz.device).cuda_stream), "dgrad_f32_wgmma")
    dgrad.launches += 1
    return dx


dgrad.launches = 0


def _affine_backward(ctx, x, w, dz):
    """(dx, dw, db, None) of ``z = x @ w + b`` from the pre-activation
    error ``dz``, rounded as JAX ``_bwd`` rounds: ``dz`` to x's dtype for
    the two GEMMs, each product to x's dtype once, ``db`` summed from
    ``dz`` before that rounding. With a weight-update hook, the hook gets
    ``(x, dz)`` after ``dx`` has used the old ``w``, and ``w`` gets no
    gradient."""
    dzc = dz.to(x.dtype)
    mm = bf16_matmul if x.dtype == torch.bfloat16 else torch.matmul
    run = _in_span if profiler.recording() else _bare
    dx = run("backward.dgrad", dgrad, dzc, w) if ctx.needs_input_grad[0] else None
    db = dz.sum(0).to(x.dtype) if ctx.needs_input_grad[2] else None
    if ctx.update is not None:
        run("backward.wgrad", ctx.update, x, dzc)
        return dx, None, db, None
    dw = None
    if ctx.needs_input_grad[1]:
        profiler.count(tile_plan.LIBRARY_FLOPS, 2.0 * x.shape[0] * x.shape[1] * dzc.shape[1])
        dw = run("backward.wgrad", mm, x.T, dzc)
    return dx, dw, db, None


def _in_span(name, fn, a, b):
    """``fn(a, b)`` inside the profiler's span ``name``, timed on the card."""
    with profiler.phase(name, a.device, timed_in_trace=True):
        return fn(a, b)


def _bare(name, fn, a, b):
    return fn(a, b)


class AffineSigmoid(torch.autograd.Function):
    """y = sigmoid(x @ w + b) through the fused kernel, JAX ``_bwd`` backward.

    ``update`` is None or a callable ``update(x, dz)`` that updates the
    layer's f32 master weight in place from the layer's input and
    pre-activation error (the Trainer's momentum step through the fused
    wgrad+momentum kernel)."""

    @staticmethod
    def forward(ctx, x, w, b, update):
        y = matmul_act(x, w, b, "sigmoid")
        ctx.save_for_backward(x, w, y)
        ctx.update = update
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        yf = y.float()
        return _affine_backward(ctx, x, w, g.float() * yf * (1.0 - yf))


class Affine(torch.autograd.Function):
    """z = x @ w + b in plain torch (a BiasedLinearity without a sigmoid,
    e.g. the output layer, which the JAX trainer leaves outside Pallas)
    with the weight-update hook of ``AffineSigmoid``. At bf16 the product
    and the sum are each rounded to bf16, as XLA computes them."""

    @staticmethod
    def forward(ctx, x, w, b, update):
        ctx.save_for_backward(x, w)
        ctx.update = update
        profiler.count(tile_plan.LIBRARY_FLOPS, 2.0 * x.shape[0] * w.shape[0] * w.shape[1])
        if x.dtype == torch.bfloat16:
            return bf16_matmul(x, w) + b
        return x @ w + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _affine_backward(ctx, x, w, g)


def affine_sigmoid(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   update=None) -> torch.Tensor:
    return AffineSigmoid.apply(x, w, b, update)


def affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, update=None) -> torch.Tensor:
    return Affine.apply(x, w, b, update)

"""Fused affine + sigmoid: y = sigmoid(x @ W + b), f32.

Replaces the TPU kernel ``nnet_asr_tpu/ops/pallas/matmul_act.py``
(``matmul_act`` / custom-VJP ``affine_sigmoid``) with the hand-written
CUDA kernel ``nnet_asr_torch/csrc/matmul_act.cu``: the f32-accurate
tensor-core GEMM of ``csrc/tile_gemm.cuh`` (3xTF32 ``mma.sync`` fed by a
``cp.async`` ring) with the bias + sigmoid epilogue in registers. It is
bound by operations, not bytes, at the main path's shapes (960x598->1024
on example-01's MLP3, 1024x{1024,4096}->4096 on the production stack).
``tile_plan.plan`` picks the tile and each operand's copy width from the
shapes and pointers.

``matmul_act`` dispatches on the tensor's device: a CPU tensor runs the
plain PyTorch version (``matmul_act_plain``), a CUDA tensor launches the
kernel or raises — there is no fallback. ``matmul_act.launches`` counts
kernel launches. ``affine_sigmoid`` is the ``autograd.Function``; its
backward is the JAX ``_bwd``: the elementwise ``dz`` in plain torch, and
``dx``, ``dW`` by ``torch.matmul``, which JAX also left outside Pallas.
On the momentum path the backward instead hands ``(x, dz)`` to a
weight-update hook, which launches the fused wgrad+momentum kernel
(``ops/kernels/sgd_fused.py``), and forms no ``dW``; ``affine`` is the
same for a BiasedLinearity without a sigmoid.
"""

from __future__ import annotations

import torch

from . import _build, tile_plan

ACTS = {"none": 0, "sigmoid": 1}


def matmul_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     act: str = "sigmoid") -> torch.Tensor:
    """The plain PyTorch version of the kernel."""
    z = x @ w + b
    return torch.sigmoid(z) if act == "sigmoid" else z


def _check(x, w, b, act):
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"matmul_act: {name} must be float32, got {t.dtype}")
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
    """act(x @ w + b): x (M,K), w (K,N), b (N,) float32."""
    if x.device.type == "cpu":
        return matmul_act_plain(x, w, b, act)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_act: unsupported device {x.device}")
    _check(x, w, b, act)
    lib = _build.load_library()
    M, K = x.shape
    N = w.shape[1]
    p = tile_plan.plan(M, N, K, a_pitch=K, b_pitch=N, a_ptr=x.data_ptr(),
                       b_ptr=w.data_ptr())
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.matmul_act_f32(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                              y.data_ptr(), M, N, K, ACTS[act], p.tile, int(p.a_vec),
                              int(p.b_vec), stream)
    _build.check(code, "matmul_act_f32")
    matmul_act.launches += 1
    return y


matmul_act.launches = 0


def _affine_backward(ctx, x, w, dz):
    """(dx, dw, db, None) of ``z = x @ w + b`` from the pre-activation
    error ``dz``. With a weight-update hook, the hook gets ``(x, dz)``
    after ``dx`` has used the old ``w``, and ``w`` gets no gradient."""
    dx = dz @ w.T if ctx.needs_input_grad[0] else None
    db = dz.sum(0) if ctx.needs_input_grad[2] else None
    if ctx.update is not None:
        ctx.update(x, dz)
        return dx, None, db, None
    dw = x.T @ dz if ctx.needs_input_grad[1] else None
    return dx, dw, db, None


class AffineSigmoid(torch.autograd.Function):
    """y = sigmoid(x @ w + b) through the fused kernel, JAX ``_bwd`` backward.

    ``update`` is None or a callable ``update(x, dz)`` that updates ``w``
    in place from the layer's input and pre-activation error (the
    Trainer's momentum step through the fused wgrad+momentum kernel)."""

    @staticmethod
    def forward(ctx, x, w, b, update):
        y = matmul_act(x, w, b, "sigmoid")
        ctx.save_for_backward(x, w, y)
        ctx.update = update
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        return _affine_backward(ctx, x, w, g * y * (1.0 - y))


class Affine(torch.autograd.Function):
    """z = x @ w + b in plain torch (a BiasedLinearity without a sigmoid,
    e.g. the output layer, which the JAX trainer leaves outside Pallas)
    with the weight-update hook of ``AffineSigmoid``."""

    @staticmethod
    def forward(ctx, x, w, b, update):
        ctx.save_for_backward(x, w)
        ctx.update = update
        return x @ w + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _affine_backward(ctx, x, w, g)


def affine_sigmoid(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   update=None) -> torch.Tensor:
    return AffineSigmoid.apply(x, w, b, update)


def affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, update) -> torch.Tensor:
    return Affine.apply(x, w, b, update)

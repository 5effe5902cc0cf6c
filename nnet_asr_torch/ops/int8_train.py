"""int8 fake-quantization for training (port of nnet_asr_tpu/ops/int8_train.py
and the fake-quant of nnet_asr_tpu/train/trainer.py:129-144).

Symmetric int8 quantize-dequantize computed in f32: a scale ``s = max|t| /
127 + 1e-12`` over the whole tensor or along one axis, ``t / s`` rounded
half to even (``torch.round``, as ``jnp.round``) or, for stochastic
rounding, ``floor(t / s + u)``, clipped to [-127, 127], times ``s``. No
int8 GEMM runs: these are the numerics of the JAX package's int8 training
modes, which it too leaves to plain f32 arithmetic (XLA), so there is no
kernel here.

- ``fake_quant_ste``: the trainer's ``_fq``, ``t + (q - t).detach()`` (a
  straight-through gradient); ``noise`` is the uniform ``u`` of stochastic
  rounding (``int8pfsr``), given by the caller so that tests can inject it.
- ``qmatmul``: ``int8full``'s matmul, an ``autograd.Function`` in which
  all three GEMMs see fake-quantized operands, each with the finest scales
  that factor out of its contraction::

      fwd    y  = x  @ W     x per row (frame),  W per output channel
      dgrad  dx = g  @ W^T   g per row,          W per input channel
      wgrad  dW = x^T @ g    x per input column, g per output column

Every scale is divided on the device by a tensor, never by a Python
number: CUDA divides by a host scalar as a multiplication by its
reciprocal, which can round differently from JAX's division.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

_DIVISORS: Dict[torch.device, torch.Tensor] = {}


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true f32 division on t's device."""
    d = _DIVISORS.get(t.device)
    if d is None:
        d = _DIVISORS[t.device] = torch.tensor(127.0, dtype=torch.float32, device=t.device)
    return t / d


def scale(t: torch.Tensor, dim: Optional[int] = None,
          amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """max|t| / 127 + 1e-12 over the whole tensor (``dim`` None, a 0-d
    tensor) or along ``dim`` (kept as a size-1 axis); ``amax`` gives the
    max instead (a mesh's max over the global bunch)."""
    m = amax
    if m is None:
        m = t.abs().amax() if dim is None else t.abs().amax(dim=dim, keepdim=True)
    return _div127(m) + 1e-12


def fake_quant(t: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """int8 quantize-dequantize with scales along ``dim`` (None: one
    scale): exact values of the dequantized int8 grid (int8_train._fq)."""
    s = scale(t, dim)
    return torch.clamp(torch.round(t / s), -127, 127) * s


def fake_quant_ste(t: torch.Tensor, dim: Optional[int] = None,
                   noise: Optional[torch.Tensor] = None,
                   amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The trainer's fake-quant with a straight-through gradient: the
    forward value is the quantized ``q``, the gradient that of ``t``.
    ``noise`` (uniform in [0, 1), t's shape): round stochastically,
    ``floor(t / s + noise)``, which is unbiased. ``amax``: see ``scale``."""
    s = scale(t, dim, amax)
    r = torch.round(t / s) if noise is None else torch.floor(t / s + noise)
    q = torch.clamp(r, -127, 127) * s
    return t + (q - t).detach()


class QMatmul(torch.autograd.Function):
    """x (B, In) @ w (In, Out), every GEMM int8-fake-quantized."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return fake_quant(x, -1) @ fake_quant(w, 0)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = fake_quant(g, -1) @ fake_quant(w, 1).T if ctx.needs_input_grad[0] else None
        dw = fake_quant(x, 0).T @ fake_quant(g, 0) if ctx.needs_input_grad[1] else None
        return dx, dw


def qmatmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return QMatmul.apply(x, w)

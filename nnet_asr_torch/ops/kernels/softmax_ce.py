"""Fused softmax + cross-entropy + gradient, f32.

Replaces the TPU kernel ``nnet_asr_tpu/ops/pallas/softmax_ce.py``
(``_fwd_impl`` / custom-VJP ``fused_softmax_xent``) with the hand-written
CUDA kernel ``nnet_asr_torch/csrc/softmax_ce.cu``: one launch reads each
row once, writes ``err = softmax - onehot`` (the stored gradient) and sums
the clamped Xent and the first-max hits through per-block partials that the
last block reduces in a fixed order, so runs repeat bit for bit. It is
bound by memory bytes: one read of the logits and one write of ``err``.
``softmax_plan.plan`` picks the kernel's shape (one warp per row, a row in
a block's registers, or two walks of a wide row). The row max propagates
NaN, as ``jnp.max`` does: a row with a NaN counts no hit.

``softmax_xent`` checks its operands, then dispatches on the tensor's
device: a CPU tensor runs the plain PyTorch version
(``softmax_xent_plain``), a CUDA tensor launches the kernel or raises —
there is no fallback. Both devices refuse the same inputs: logits other
than float32 or labels other than int32 (``TypeError``), labels that are
not one a row, or an operand that is not contiguous (``ValueError``).
``softmax_xent.launches`` counts kernel launches. ``fused_softmax_xent`` is
the ``autograd.Function``: the loss is the summed Xent, its backward ``err
* g_loss``, and ``correct`` is not differentiable.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build, softmax_plan


def softmax_xent_plain(logits: torch.Tensor, labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: (err, xent, correct) as the kernel computes them."""
    B, C = logits.shape
    x = logits
    m = x.max(dim=1, keepdim=True).values
    e = torch.exp(x - m)
    s = e.sum(dim=1, keepdim=True)
    lab = labels.long()[:, None]                       # torch indexes with int64
    col = torch.arange(C, device=x.device)[None, :]
    hit = col == lab
    err = e / s - hit.to(x.dtype)
    valid = lab >= 0
    logp = x - m - torch.log(s)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    picked = torch.where(hit, torch.clamp(logp, min=-1e10), zero).sum(1, keepdim=True)
    xent = -torch.where(valid, picked, zero).sum()
    first_max = torch.where(x >= m, col, C).min(dim=1, keepdim=True).values
    correct = (valid & (first_max == lab)).sum().to(torch.int32)
    return err, xent, correct


def _check(logits, labels):
    if logits.dtype != torch.float32 or labels.dtype != torch.int32:
        raise TypeError(f"softmax_xent: want float32 logits and int32 labels, "
                        f"got {logits.dtype}, {labels.dtype}")
    if logits.dim() != 2 or labels.shape != (logits.shape[0],):
        raise ValueError(f"softmax_xent: want logits (B,C), labels (B,); got "
                         f"{tuple(logits.shape)}, {tuple(labels.shape)}")
    if not (logits.is_contiguous() and labels.is_contiguous()):
        raise ValueError("softmax_xent: logits and labels must be contiguous")
    if labels.device != logits.device:
        raise ValueError(f"softmax_xent: labels on {labels.device}, "
                         f"logits on {logits.device}")
    if logits.shape[0] < 1 or logits.shape[1] < 1:
        raise ValueError("softmax_xent: empty logits")


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(err (B,C) f32, xent () f32, correct () int32) for int32 labels;
    rows with label < 0 add nothing to the stats."""
    _check(logits, labels)
    if logits.device.type == "cpu":
        return softmax_xent_plain(logits, labels)
    if logits.device.type != "cuda":
        raise ValueError(f"softmax_xent: unsupported device {logits.device}")
    lib = _build.load_library()
    B, C = logits.shape
    dev = logits.device
    p = softmax_plan.plan(B, C, logits.data_ptr())
    err = torch.empty_like(logits)                       # 16-byte aligned
    part = torch.empty(2 * p.blocks, dtype=torch.float32, device=dev)
    xent = torch.empty((), dtype=torch.float32, device=dev)
    correct = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev)
    code = lib.softmax_xent_f32(
        logits.data_ptr(), labels.data_ptr(), err.data_ptr(), part.data_ptr(),
        _build.counters(dev, stream).data_ptr(), xent.data_ptr(), correct.data_ptr(), B, C,
        p.variant, p.blocks, p.threads, p.vpt, int(p.vec), stream.cuda_stream)
    _build.check(code, "softmax_xent_f32")
    softmax_xent.launches += 1
    return err, xent, correct


softmax_xent.launches = 0


class FusedSoftmaxXent(torch.autograd.Function):
    """(loss, correct): loss = summed clamped Xent; d loss / d logits = err."""

    @staticmethod
    def forward(ctx, logits, labels):
        err, xent, correct = softmax_xent(logits, labels)
        ctx.save_for_backward(err)
        ctx.mark_non_differentiable(correct)
        return xent, correct

    @staticmethod
    def backward(ctx, g_loss, _g_correct):
        (err,) = ctx.saved_tensors
        return err * g_loss, None


def fused_softmax_xent(logits: torch.Tensor, labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    return FusedSoftmaxXent.apply(logits, labels)

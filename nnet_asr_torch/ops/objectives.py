"""Objectives and their host statistics (port of nnet_asr_tpu/ops/objectives.py).

``xent_loss_and_stats`` is the plain PyTorch CE over a softmax or a
BlockSoftmax output: the gradient of ``loss`` wrt the logits is the
reference's fused ``err = softmax - onehot`` within the label's span
(ObjFun.cc:93-96); ``xent`` accumulates the clamped ``max(log y, -1e10)``
(ObjFun.cc:110-127) and ``correct`` the first-max argmax matches
(ObjFun.cc:100-108), of the logits, or with spans of the per-span
log-softmax. A label outside [0, C) picks nothing, as the JAX one-hot does.
``mse_loss_and_stats`` is ``sum((y-t)^2)/2`` (ObjFun.cc:24-56), and
``softmax_identity_backward`` the softmax whose backward passes the error
through unchanged, as the reference does for MSE through a softmax output.
Host totals are float64 like the reference's ``double``, with the
confusion modes of CONFUSIONMODE (ObjFun.cc:132-155).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class _SoftmaxIdentityBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.softmax(x, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g


def softmax_identity_backward(x: torch.Tensor) -> torch.Tensor:
    """Row softmax whose backward is the identity."""
    return _SoftmaxIdentityBackward.apply(x)


def one_hot(labels: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """(B, n) one-hot rows; a label outside [0, n) gives a zero row, as
    ``jax.nn.one_hot`` does."""
    cols = torch.arange(n, device=labels.device)
    return (labels.long()[:, None] == cols[None, :]).to(dtype)


def block_log_softmax(logits: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """log-softmax over disjoint column spans (the BlockSoftmax pairing)."""
    return torch.cat([torch.log_softmax(s, dim=-1) for s in logits.split(tuple(dims), dim=1)],
                     dim=1)


def xent_loss_and_stats(logits: torch.Tensor, labels: torch.Tensor,
                        block_dims: Optional[Sequence[int]] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CE loss (sum over frames) + reference-compatible stats."""
    C = logits.shape[1]
    logp = (torch.log_softmax(logits, dim=-1) if block_dims is None
            else block_log_softmax(logits, block_dims))
    lab = labels.long()
    in_range = (lab >= 0) & (lab < C)
    picked = torch.where(
        in_range, logp.gather(1, lab.clamp(0, C - 1)[:, None])[:, 0],
        torch.zeros((), dtype=logp.dtype, device=logp.device))
    loss = -picked.sum()
    post_logp = picked.detach()
    xent = -torch.clamp(post_logp, min=-1e10).sum()
    # first index on ties; with spans, argmax of the per-span log-softmax
    pred = torch.argmax((logits if block_dims is None else logp).detach(), dim=-1)
    correct = (pred == lab).sum().to(torch.int32)
    return loss, {"xent": xent, "correct": correct,
                  "frames": torch.tensor(logits.shape[0], dtype=torch.int32)}


def mse_loss_and_stats(net_out: torch.Tensor, targets: torch.Tensor
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MSE: loss = sum((y-t)^2)/2, so the gradient is y - t."""
    diff = net_out - targets
    loss = 0.5 * torch.sum(diff * diff)
    return loss, {"mse": loss.detach(),
                  "frames": torch.tensor(net_out.shape[0], dtype=torch.int32)}


@dataclass
class XentStats:
    """Accumulates like CrossEntropy (ObjFun.cc:158-228), incl. the report
    line the newbob scheduler greps (``Xent:... correct[x%]``) and, with a
    confusion mode, the confusion matrix (``max``/``soft``) or its diagonal
    (``dmax``/``dsoft``) and one line per class."""

    error: float = 0.0
    frames: int = 0
    corr: int = 0
    confusion_mode: str = "no"
    n_classes: int = 0
    confusion: Optional[np.ndarray] = None
    confusion_count: Optional[np.ndarray] = None
    diag_confusion: Optional[np.ndarray] = None
    label_map_file: Optional[str] = None

    def _ensure_confusion(self, n: int) -> None:
        if self.confusion is None:
            self.n_classes = n
            self.confusion = np.zeros((n, n), dtype=np.float64)
            self.confusion_count = np.zeros(n, dtype=np.float64)
            self.diag_confusion = np.zeros(n, dtype=np.float64)

    def add(self, xent: float, frames: int, correct: int) -> None:
        self.error += float(xent)
        self.frames += int(frames)
        self.corr += int(correct)

    def add_confusion(self, posteriors: np.ndarray, labels: np.ndarray) -> None:
        """Host-side confusion of one bunch of posteriors (the Trainer
        accumulates on the device instead)."""
        if self.confusion_mode == "no":
            return
        self._ensure_confusion(posteriors.shape[1])
        pred = posteriors.argmax(axis=1)
        for r in range(len(labels)):
            t, h = int(labels[r]), int(pred[r])
            if self.confusion_mode == "max":
                self.confusion[t, h] += 1
            elif self.confusion_mode == "soft":
                self.confusion[t] += posteriors[r]
            elif self.confusion_mode == "dmax":
                self.diag_confusion[t] += 1 if t == h else 0
            elif self.confusion_mode == "dsoft":
                self.diag_confusion[t] += posteriors[r, t]
            self.confusion_count[t] += 1

    def merge(self, other: "XentStats") -> None:
        self.error += other.error
        self.frames += other.frames
        self.corr += other.corr

    @property
    def accuracy(self) -> float:
        return 100.0 * self.corr / max(self.frames, 1)

    def report(self) -> str:
        s = (f"Xent:{self.error:.10g} frames:{self.frames}"
             f" err/frm:{self.error / max(self.frames, 1):.10g}"
             f" correct[{self.accuracy:.10g}%]\n")
        if self.confusion_mode == "no" or self.confusion is None:
            return s
        tags = None
        if self.label_map_file:
            with open(self.label_map_file) as f:
                tags = f.read().split()
        full = self.confusion_mode in ("max", "soft")
        if full:
            s += "Row:label Col:hyp\n"
            s += f"m {self.n_classes} {self.n_classes}\n"
            for row in self.confusion:
                s += " ".join(f"{v:g}" for v in row) + " \n"
        for i in range(self.n_classes):
            num = self.confusion[i, i] if full else self.diag_confusion[i]
            cnt = self.confusion_count[i]
            tag = tags[i] if tags and i < len(tags) else str(i)
            pct = 100.0 * num / cnt if cnt else 0.0
            s += f"{tag:>30} {pct:>10g}% [{num:g}/{cnt:g}]\n"
        return s


@dataclass
class MseStats:
    error: float = 0.0
    frames: int = 0

    def add(self, mse: float, frames: int) -> None:
        self.error += float(mse)
        self.frames += int(frames)

    def merge(self, other: "MseStats") -> None:
        self.error += other.error
        self.frames += other.frames

    def report(self) -> str:
        return (f"Mse:{self.error:.10g} frames:{self.frames}"
                f" err/frm:{self.error / max(self.frames, 1):.10g}\n")

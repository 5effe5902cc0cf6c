"""Plain PyTorch reference of TNet/TNetCu frame cross-entropy training of a
sigmoid MLP with a softmax output: forward, the summed Xent of a bunch,
backpropagation by hand, and the reference's SGD (TNetCu with momentum:
``v = m·v + g``, ``W -= lr·(1-m)/frames · v``; TNet without: ``W -=
lr/frames · g``, g the gradient summed over the bunch). It imports nothing
of the program under test.

``precision``: ``"f32"`` (float32 products with TF32 off), or ``"tf32"``,
the nearest lower precision and the control: every product's operands
rounded to TF32's 10-bit mantissa (round to nearest even, as the tensor
cores' TF32 inputs), the sums in float32.

``precision="tf32_hw"`` takes the card's own TF32 products (cuBLAS with
TF32 allowed; on a CPU it is float32); ``"f64"`` holds the state and
computes in float64, for the calibration's record of rounding.

``fault`` plants a fault in the step, for the calibration of the checks:
``"half"`` takes the gradient and the loss of the bunch's first half only,
the step scaled as a mean over those rows; ``"frozen"`` returns the state
unchanged.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

Leaf = Tuple[str, torch.Tensor, Optional[torch.Tensor]]
PRECISIONS = ("f32", "tf32", "tf32_hw", "f64")
FAULTS = (None, "half", "frozen")


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its mantissa rounded to TF32's 10 bits (nearest even)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & -0x2000).view(torch.float32)


def step_coeff(cfg: dict, frames: int) -> float:
    """The step's scale on the (momentum) gradient sum, formed in float32:
    lr / N, N = frames (when the gradient is divided by the frames) times
    1/(1-m) with momentum."""
    f32 = np.float32
    n = f32(frames) if cfg["grad_div_frm"] else f32(1.0)
    if cfg["momentum"]:
        n = f32(n * f32(1.0 / (1.0 - cfg["momentum"])))
    return float(f32(f32(cfg["learning_rate"]) / n))


class MlpFrameCe:
    """The network's f32 state (W, b and their velocities) and its steps."""

    def __init__(self, cfg: dict, weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 precision: str = "f32", fault: Optional[str] = None):
        if precision not in PRECISIONS or fault not in FAULTS:
            raise ValueError(f"precision {precision!r}, fault {fault!r}")
        self.cfg, self.precision, self.fault = cfg, precision, fault
        self.dtype = torch.float64 if precision == "f64" else torch.float32
        self.params = [[w.detach().to(self.dtype, copy=True), b.detach().to(self.dtype, copy=True)]
                       for w, b in weights]
        m = cfg["momentum"]
        self.velocity = ([[torch.zeros_like(w), torch.zeros_like(b)] for w, b in self.params]
                         if m else None)

    def leaves(self) -> List[Leaf]:
        out = []
        for i, (w, b) in enumerate(self.params):
            vw, vb = self.velocity[i] if self.velocity is not None else (None, None)
            out += [(f"W{i + 1}", w, vw), (f"b{i + 1}", b, vb)]
        return out

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32":
            a, b = tf32_round(a), tf32_round(b)
        if self.precision == "tf32_hw":
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return a @ b
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        return a @ b

    def step(self, x: torch.Tensor, labels: torch.Tensor) -> float:
        """One training step on a bunch; the bunch's summed Xent before the
        update (float64)."""
        if self.fault == "half":
            x, labels = x[:x.shape[0] // 2], labels[:x.shape[0] // 2]
        y = labels.long()
        hs = [x.to(self.dtype)]
        n = len(self.params)
        for i, (w, b) in enumerate(self.params):
            z = self._mm(hs[-1], w) + b
            if i < n - 1:
                hs.append(torch.sigmoid(z))
        rows = torch.arange(z.shape[0], device=z.device)
        loss = float(-torch.log_softmax(z, dim=1)[rows, y].double().sum())
        e = torch.softmax(z, dim=1)
        e[rows, y] -= 1.0
        grads: List[Tuple[torch.Tensor, torch.Tensor]] = [None] * n
        for i in reversed(range(n)):
            grads[i] = (self._mm(hs[i].T, e), e.sum(0))
            if i > 0:
                h = hs[i]
                e = self._mm(e, self.params[i][0].T) * h * (1.0 - h)
        if self.fault == "frozen":
            return loss
        a = step_coeff(self.cfg, x.shape[0])
        m = self.cfg["momentum"]
        with torch.no_grad():
            for i, g in enumerate(grads):
                for j in range(2):
                    corr = g[j]
                    if m:
                        corr = g[j] + self.velocity[i][j] * m
                        self.velocity[i][j].copy_(corr)
                    self.params[i][j].sub_(corr * a)
        return loss


def run(cfg: dict, weights, bunches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        after_step: Callable[[int, float, List[Leaf]], None],
        precision: str = "f32", fault: Optional[str] = None) -> None:
    """Train on ``bunches`` in order from ``weights``; ``after_step(k,
    loss, leaves)`` reads the state after step k (k = 0: the initial
    state, loss None)."""
    net = MlpFrameCe(cfg, weights, precision, fault)
    after_step(0, None, net.leaves())
    for k, (x, y) in enumerate(bunches, 1):
        after_step(k, net.step(x, y), net.leaves())

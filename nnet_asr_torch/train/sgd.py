"""SGD with the reference's exact update semantics (port of nnet_asr_tpu/train/sgd.py).

Unifies the CPU trainer (TNetLib/BiasedLinearity.cc:131-178: plain
``W -= lr * grad_sum`` + L2 decay scaled by bunch frames) and the GPU
trainer (CuTNetLib/cuBiasedLinearity.cc:44-63: momentum with
``mmt_gain = 1/(1-momentum)``, optional grad/frames, L2 from live weights,
L1 and the 0/1 mask for SparseLinearity). The CPU semantics are momentum=0,
grad_div_frm=False.

Per-layer learning-rate factors follow CuNetwork::SetLearnRate
(cuNetwork.cc:80-134): a ``0.1:0.5:1.0`` list maps to *updatable* layers in
order; factor 0 freezes a layer.

Unlike the JAX package's pure function, ``apply_updates`` updates the
parameter and velocity tensors IN PLACE under ``torch.no_grad()``: it saves
a parameter-sized allocation per step, and the tensors are the network's
own ``nn.Parameter``s. The scalar coefficients are formed on the host in
float32, in the JAX package's order, by ``layer_coeffs``, which both
``apply_updates`` and ``fused_weight_step`` (the momentum step of a weight
matrix through the fused wgrad+momentum kernel) take them from.

The JAX package cannot update a DiscreteLinearity (its ``weights`` is a
list: ``init_momentum`` fails on it with any momentum, ``apply_updates``
with a non-zero learning-rate factor); ``check_updatable`` raises where it
fails, and the port invents no update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.components import DiscreteLinearity, SparseLinearity
from ..models.network import Network
from ..ops.kernels.sgd_fused import wgrad_momentum_update

_f32 = np.float32


@dataclass(frozen=True)
class SgdConfig:
    learning_rate: float = 0.008
    momentum: float = 0.0
    weightcost: float = 0.0    # L2
    l1: float = 0.0            # L1 soft threshold, SparseLinearity weights only
    grad_div_frm: bool = True
    # per-updatable-layer lr factors, e.g. (0.1, 0.5, 1.0); None = all 1.0
    lr_factors: Optional[Tuple[float, ...]] = None
    # velocity STORAGE dtype: None = f32 (the reference's exact GPU
    # semantics) | 'bf16' (the momentum math still runs in f32 on the
    # upcast velocity; only the carried state is rounded)
    velocity_dtype: Optional[str] = None

    def __post_init__(self):
        if self.velocity_dtype not in (None, "bf16"):
            raise ValueError(
                f"velocity_dtype must be None or 'bf16', got {self.velocity_dtype!r}")

    @staticmethod
    def parse_factors(s: Optional[str]) -> Optional[Tuple[float, ...]]:
        if not s:
            return None
        return tuple(float(v) for v in s.replace(",", ":").split(":"))


def layer_lr_factors(net: Network, cfg: SgdConfig) -> List[float]:
    """Factor per component (non-updatable layers get 0)."""
    factors = []
    k = 0
    for spec in net.layers:
        if spec.updatable:
            if cfg.lr_factors is not None:
                if k >= len(cfg.lr_factors):
                    raise ValueError("Too few learning-rate factors for network")
                factors.append(cfg.lr_factors[k])
            else:
                factors.append(1.0)
            k += 1
        else:
            factors.append(0.0)
    if cfg.lr_factors is not None and k != len(cfg.lr_factors):
        raise ValueError(
            f"Learning-rate factor count {len(cfg.lr_factors)} != updatable layers {k}")
    return factors


def init_momentum(net: Network, momentum: float = 1.0,
                  dtype: Optional[str] = None) -> List[dict]:
    """Zero velocity buffers for every trainable parameter; none at all
    with momentum 0 (the reference CPU trainer has none either)."""
    if momentum == 0.0:
        return [{} for _ in net.layers]
    check_updatable(net, momentum)
    vdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return [{k: torch.zeros_like(v, dtype=vdt) for k, v in layer.param_dict().items()
             if k in layer.trainable_keys} for layer in net.layers]


def check_updatable(net: Network, momentum: float,
                    factors: Optional[Sequence[float]] = None) -> None:
    """Raise where the JAX package cannot update the network: a
    DiscreteLinearity with any momentum (``init_momentum``, sgd.py:90) or
    with a non-zero learning-rate factor (``apply_updates``, sgd.py:127)."""
    for i, spec in enumerate(net.layers):
        f = 0.0 if factors is None else factors[i]
        if isinstance(spec, DiscreteLinearity) and (momentum != 0.0 or f != 0.0):
            raise ValueError(
                f"layer {i} ({spec.tag}) cannot be trained: its weights are a list of "
                f"blocks, which the JAX package cannot update either (momentum "
                f"{momentum:g}, learning-rate factor {f:g}); freeze it with factor 0 "
                f"and momentum 0")


def layer_coeffs(cfg: SgdConfig, n_frames: int, factor: float,
                 learning_rate: Optional[float] = None) -> Tuple[float, float, float]:
    """(a, decay, l1) of one layer's step, formed on the host in float32 in
    the JAX package's order: ``p -= a * corr`` (``a = lr/N``, N scaled by
    ``1/(1-m)`` with momentum), then ``w -= w * decay`` for matrices (L2;
    0 without weightcost), then for SparseLinearity weights the soft
    threshold ``w = sign(w) * max(|w| - l1, 0)`` (0 without L1)."""
    base_lr = _f32(cfg.learning_rate if learning_rate is None else learning_rate)
    nf = _f32(n_frames)
    lr = _f32(base_lr * _f32(factor))
    N = nf if cfg.grad_div_frm else _f32(1.0)
    if cfg.momentum != 0.0:
        N = _f32(N * _f32(1.0 / (1.0 - cfg.momentum)))
    per = _f32(1.0) if cfg.grad_div_frm else nf
    decay = _f32(_f32(lr * _f32(cfg.weightcost)) * per)
    l1 = _f32(_f32(_f32(cfg.l1) * per) * lr)
    return float(_f32(lr / N)), float(decay), float(l1)


@torch.no_grad()
def apply_updates(net: Network, params: List[dict], velocity: List[dict],
                  grads: List[dict], cfg: SgdConfig, n_frames: int,
                  factors: Sequence[float],
                  learning_rate: Optional[float] = None):
    """One SGD step, in place; returns (params, velocity).

    grads are *sums* over the bunch (the reference's X^T E convention).
    ``learning_rate`` overrides cfg.learning_rate at run time (newbob).
    Tensors without a gradient in ``grads`` are left alone (the Trainer's
    momentum path updates weight matrices with ``fused_weight_step``).
    """
    check_updatable(net, cfg.momentum, factors)
    m = cfg.momentum
    for spec, p, v, g, f in zip(net.layers, params, velocity, grads, factors):
        if not spec.updatable or f == 0.0:
            continue
        a, decay, l1 = layer_coeffs(cfg, n_frames, f, learning_rate)
        sparse = isinstance(spec, SparseLinearity)
        for k in spec.trainable_keys:
            if g.get(k) is None:
                continue
            if m != 0.0:
                # momentum math in f32; only the carried velocity state is
                # stored at velocity_dtype
                corr = g[k] + v[k].float() * m
                v[k].copy_(corr)
            else:
                corr = g[k]
            w = p[k]
            w.sub_(corr * a)
            # L2 weight decay from live weights, matrices ONLY: both
            # reference backends decay the weights and leave the bias alone
            # (cuBiasedLinearity.cc:62-64, BiasedLinearity.cc:155-170)
            if decay != 0.0 and w.dim() >= 2:
                w.sub_(w * decay)
            # L1 for sparse layers (cuSparseLinearity ApplyL1)
            if l1 != 0.0 and sparse and w.dim() >= 2:
                w.copy_(torch.sign(w) * torch.clamp(w.abs() - l1, min=0.0))
        if sparse:          # every update keeps pruned weights at 0
            p["weight"].mul_(p["mask"])
    return params, velocity


@torch.no_grad()
def fused_weight_step(x: torch.Tensor, e: torch.Tensor, w: torch.Tensor,
                      v: torch.Tensor, a: float, m: float, decay: float) -> None:
    """The momentum branch of ``apply_updates`` for one weight matrix, in
    place, with its gradient ``x^T e`` formed inside the fused kernel:
    the momentum step, then the L2 decay (which the kernel leaves out, as
    the TPU kernel does). ``(a, decay)`` come from ``layer_coeffs``; only
    BiasedLinearity weights take this step, so there is no L1 or mask.
    Under the bf16 compute mode ``x`` and ``e`` are bf16 and the kernel's
    bf16 entry point rounds ``x^T e`` to bf16 before the f32 update; ``w``
    is the f32 master and the decay stays f32."""
    wgrad_momentum_update(x, e, w, v, a, m)
    if decay != 0.0:
        w.sub_(w * decay)

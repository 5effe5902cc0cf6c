"""Operations and bytes of the frame-CE training step, worked out from a
configuration's shapes, and the card's peaks they are held against.

A roofline share divides the least time the card could take for the work
(the larger of the operations at the peak and the bytes at the HBM rate,
each input read once and each output written once) by the device time the
trace measured, so it reads the same work whatever kernel implements it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense: 495 TFLOP/s TF32, of which 3xTF32
# gives a third as f32-accurate products; 989 TFLOP/s bf16; 3.35 TB/s HBM3
PEAKS = {"f32": 495e12 / 3, "bf16": 989e12}
HBM_BYTES_S = 3.35e12
F32 = 4


def layers(cfg: dict) -> List[Tuple[int, int]]:
    """(in, out) of every affine layer, first to last."""
    d = cfg["dims"]
    return list(zip(d[:-1], d[1:]))


def peak(cfg: dict) -> float:
    return PEAKS[cfg["compute"]]


def step_flops_per_frame(cfg: dict) -> float:
    """Model operations a training frame needs: the forward (2·In·Out a
    layer), the weight gradient (the same) and the input gradient of every
    layer after the first (the first layer's is never formed)."""
    ls = layers(cfg)
    fwd = sum(2 * i * o for i, o in ls)
    dgrad = sum(2 * i * o for i, o in ls[1:])
    return float(2 * fwd + dgrad)


def bound_s(flops: float, nbytes: float, cfg: dict) -> float:
    """The least time: operations at the peak or bytes at the HBM rate."""
    return max(flops / peak(cfg), nbytes / HBM_BYTES_S)


def affine_sigmoid_bound_s(cfg: dict) -> float:
    """Least time of one step's hidden-layer forwards (every layer but the
    output one): x, W and b read, y written."""
    B = cfg["bunch"]
    return sum(bound_s(2.0 * B * i * o, F32 * (B * i + i * o + o + B * o), cfg)
               for i, o in layers(cfg)[:-1])


def wgrad_momentum_bound_s(cfg: dict) -> float:
    """Least time of one step's fused weight gradients and momentum
    updates (every layer): x and e read, W and its velocity read and
    written."""
    B = cfg["bunch"]
    return sum(bound_s(2.0 * B * i * o, F32 * (B * i + B * o + 4 * i * o), cfg)
               for i, o in layers(cfg))


def counts(cfg: dict) -> Dict[str, float]:
    """The figures a CPU test can hold the yardstick to."""
    return {"params": float(sum(i * o + o for i, o in layers(cfg))),
            "flops_per_frame": step_flops_per_frame(cfg),
            "affine_sigmoid_bound_us": affine_sigmoid_bound_s(cfg) * 1e6,
            "wgrad_momentum_bound_us": wgrad_momentum_bound_s(cfg) * 1e6}

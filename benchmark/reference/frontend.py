"""TNet's Hamming + DCT front end, written out plainly: splice ±ext frames
of every band (edges replicated), window each band's 2·ext+1 values with
a Hamming window, take ``dct`` DCT-II bases of them, then add the global
normalization's bias and multiply by its window (TNet's ``<bias>`` and
``<window>``). The same numbers are written into the transform file the
program reads (``traffic.py``), as float32 values.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def hamming(ctx: int) -> np.ndarray:
    return np.asarray([0.54 - 0.46 * math.cos(2 * math.pi * n / (ctx - 1))
                       for n in range(ctx)], np.float32)


def dct(k: int, ctx: int) -> np.ndarray:
    """(k, ctx): base kk at position n."""
    return np.asarray([[math.sqrt(2.0 / ctx) * math.cos(math.pi / ctx * kk * (n + 0.5))
                        for n in range(ctx)] for kk in range(k)], np.float32)


def transform_matrix(bands: int, ext: int, k: int) -> np.ndarray:
    """(ctx·bands, bands·k) float64: spliced row [offset n][band b] to
    output [band b][base kk], the Hamming weight and the DCT base."""
    ctx = 2 * ext + 1
    ham, d = hamming(ctx).astype(np.float64), dct(k, ctx).astype(np.float64)
    m = np.zeros((ctx * bands, bands * k))
    for b in range(bands):
        m[np.arange(ctx) * bands + b, b * k:(b + 1) * k] = (ham[:, None] * d.T)
    return m


def splice(feats: torch.Tensor, ext: int) -> torch.Tensor:
    """(T, bands) -> (T, (2·ext+1)·bands): row t holds frames t-ext .. t+ext,
    clamped to the utterance, offset-major."""
    T = feats.shape[0]
    rows = (torch.arange(T, device=feats.device)[:, None]
            + torch.arange(-ext, ext + 1, device=feats.device)[None, :]).clamp_(0, T - 1)
    return feats[rows].reshape(T, -1)

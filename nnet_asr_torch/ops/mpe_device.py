"""Device-side MPE within-arc recursions in torch (port of
nnet_asr_tpu/ops/mpe_device.py).

The alpha/beta recursions of a phone arc's emitting states, batched over
the arcs of one call: a Python loop over the frame axis, each step one
``torch.logsumexp`` over (arcs, from-state, to-state), where the JAX
package runs a jitted ``lax.scan``. Same log-likelihoods and occupancies
as the host engine (``train/mpe.py`` ``arc_forward_backward_batch``);
``MpeComputer(engine="jax", device=...)`` selects this path. No
hand-written kernel: JAX left these scans to XLA.

Arcs of unequal length ride in one padded batch with a per-arc length
mask: past an arc's end the forward holds its carry and the backward
holds the exit vector, exactly as JAX's masked scans do, so the padding is
exact. JAX pads the arc count and the length to powers of two to bound
its XLA compiles; here the batch is padded to its longest arc only, which
gives the same results. The host-array wrappers compute in float64, the
host engines' precision (JAX casts to float32 for the TPU); the recursions
themselves run in their inputs' dtype.

The lattice-level node recursions stay on the host (``train/mpe.py``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

LOG_ZERO = -1e30


def _lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    """log-sum-exp over ``dim``, LOG_ZERO where every term is at or below
    LOG_ZERO/2 (JAX ``_lse``: there the result is the max itself, since
    log(n) vanishes against 5e29 in floating point)."""
    out = torch.logsumexp(x, dim)
    return torch.where(out > LOG_ZERO / 2, out, LOG_ZERO)


def _forward(log_obs: torch.Tensor, lt: torch.Tensor, lens: torch.Tensor) -> List[torch.Tensor]:
    """alpha at every frame, each (A, S), held past each arc's length."""
    S = log_obs.shape[2]
    inner = lt[:, 1:S + 1, 1:S + 1]
    alpha = [lt[:, 0, 1:S + 1] + log_obs[:, 0]]
    for t in range(1, log_obs.shape[1]):
        a_new = _lse(alpha[-1][:, :, None] + inner, 1) + log_obs[:, t]
        alpha.append(torch.where((t < lens)[:, None], a_new, alpha[-1]))
    return alpha


def arc_fb_masked(log_obs: torch.Tensor, lt: torch.Tensor, lens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked within-arc FB: log_obs (A, Lp, S) (values past lens[a] are
    ignored), lt (A, S+2, S+2) log transitions, lens (A,) true lengths
    (>= 1). Returns (log_like (A,), occupancy (A, Lp, S) zeroed past
    lens[a])."""
    A, Lp, S = log_obs.shape
    inner = lt[:, 1:S + 1, 1:S + 1]
    exit_w = lt[:, 1:S + 1, S + 1]
    alpha = _forward(log_obs, lt, lens)
    # the held carry after the last step is alpha[lens - 1]
    log_like = _lse(alpha[-1] + exit_w, 1)
    # the step at frame t emits beta[t - 1]; past an arc's end it emits the
    # exit vector, so the first real step sees beta[len - 1] == exit_w
    beta = [exit_w]
    for t in range(Lp - 1, 0, -1):
        b_new = _lse(inner + (log_obs[:, t] + beta[0])[:, None, :], 2)
        beta.insert(0, torch.where((t < lens)[:, None], b_new, exit_w))
    ok = log_like > LOG_ZERO / 2
    occ = torch.exp(torch.clamp(torch.stack(alpha, 1) + torch.stack(beta, 1)
                                - log_like[:, None, None], -700, 0))
    live = (torch.arange(Lp, device=lens.device)[None, :] < lens[:, None])[:, :, None]
    occ = torch.where(ok[:, None, None] & live, occ, 0.0)
    sums = occ.sum(2, keepdim=True)
    occ = torch.where(sums > 0, occ / torch.where(sums > 0, sums, 1.0), 0.0)
    return torch.where(ok, log_like, LOG_ZERO), occ


def arc_fwd_masked(log_obs: torch.Tensor, lt: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Masked forward-only arc scoring (see arc_fb_masked): log_like (A,)."""
    S = log_obs.shape[2]
    log_like = _lse(_forward(log_obs, lt, lens)[-1] + lt[:, 1:S + 1, S + 1], 1)
    return torch.where(log_like > LOG_ZERO / 2, log_like, LOG_ZERO)


def _to_device(device: DeviceLike, *arrays: np.ndarray) -> List[torch.Tensor]:
    dev = resolve_device(device)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def arc_forward_backward_batch(log_obs: np.ndarray, lt: np.ndarray, device: DeviceLike = None):
    """Host-array wrapper matching train.mpe.arc_forward_backward_batch:
    (A, L, S) emissions of equal-length arcs, (A, S+2, S+2) log
    transitions -> (log_like (A,), occupancy (A, L, S)), float64."""
    lens = np.full(log_obs.shape[0], log_obs.shape[1], np.int64)
    ll, occ = arc_fb_masked(*_to_device(device, np.asarray(log_obs, np.float64),
                                        np.asarray(lt, np.float64), lens))
    return ll.cpu().numpy(), occ.cpu().numpy()


def arc_forward_batch(log_obs: np.ndarray, lt: np.ndarray, device: DeviceLike = None):
    """Host-array wrapper matching train.mpe.arc_forward_batch."""
    lens = np.full(log_obs.shape[0], log_obs.shape[1], np.int64)
    return arc_fwd_masked(*_to_device(device, np.asarray(log_obs, np.float64),
                                      np.asarray(lt, np.float64), lens)).cpu().numpy()


def _padded(obs_list: Sequence[np.ndarray], lt_list: Sequence[np.ndarray], device: DeviceLike):
    """Per-arc (L_a, S) emissions and (S+2, S+2) log transitions as one
    batch padded to the longest arc: (obs, lt, lens) on ``device``, and the
    host lengths."""
    lens = np.asarray([o.shape[0] for o in obs_list], np.int64)
    obs = np.zeros((len(obs_list), int(lens.max()), obs_list[0].shape[1]), np.float64)
    for j, o in enumerate(obs_list):
        obs[j, :o.shape[0]] = o
    lt = np.stack([np.asarray(m, np.float64) for m in lt_list])
    return _to_device(device, obs, lt, lens), lens


def arc_fb_padded(obs_list, lt_list, device: DeviceLike = None):
    """Batch FB over per-arc (L_a, S) obs + (S+2, S+2) lt in one padded
    call. Returns (log_likes list, occupancy list sliced to each true L_a)."""
    args, lens = _padded(obs_list, lt_list, device)
    ll, occ = arc_fb_masked(*args)
    ll, occ = ll.cpu().numpy(), occ.cpu().numpy()
    return [float(v) for v in ll], [occ[j, :int(n)] for j, n in enumerate(lens)]


def arc_fwd_padded(obs_list, lt_list, device: DeviceLike = None):
    """Forward-only scoring in one padded call (see arc_fb_padded)."""
    args, _ = _padded(obs_list, lt_list, device)
    return [float(v) for v in arc_fwd_masked(*args).cpu().numpy()]

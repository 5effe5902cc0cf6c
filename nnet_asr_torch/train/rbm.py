"""RBM CD-1 pretraining (port of nnet_asr_tpu/train/rbm.py, the TRbmCu path).

CuRbm/CuRbmSparse + the TRbmCu main loop (cuRbm.cc:101-174,
cuRbmSparse.cc:131-195, TRbmCu.cc:291-357): propagate, sample the hidden
units (Bernoulli thresholds or Gaussian noise), reconstruct, re-propagate,
then the Hinton-recipe update with momentum and weight decay (and
RbmSparse's smoothed expected-activity penalty, for Bernoulli hidden units
only), plus the reconstruction-MSE statistic.

As the port's ``train/sgd.py``, the update runs IN PLACE on the parameter
and state tensors under ``torch.no_grad()`` and returns them. ``lr / N`` is
formed in float32 as JAX forms it (``N`` an f32 array); ``lr * wc`` stays a
Python float.

The noise comes from one ``torch.Generator`` on the training device, seeded
``seed or 12345`` (Philox on CUDA), drawn once per bunch in bunch order.
JAX splits a threefry or rbg key per bunch instead, so the streams differ;
``rng_impl`` accepts both of JAX's names and both use that generator.
Tests hold the arithmetic to JAX by injecting the same noise
(``sample_hidden(..., noise=)``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.components import BERNOULLI, Rbm, RbmSparse
from .cache import DeviceFrameCache

Tensors = Dict[str, torch.Tensor]
RNG_IMPLS = ("threefry", "rbg")


@dataclass(frozen=True)
class RbmTrainConfig:
    learning_rate: float = 0.10     # TRbmCu.cc:169 defaults
    momentum: float = 0.50
    weightcost: float = 0.0002
    # sparsity variant (cuRbmSparse.h:92-94 defaults)
    sparsity_prior: float = 0.0001
    sparsity_lambda: float = 0.95
    sparsity_cost: float = 1e-7
    # JAX's choice of key type; the port draws both from one torch.Generator
    rng_impl: str = "threefry"


def init_rbm_state(spec: Rbm, params: Tensors, cfg: RbmTrainConfig) -> Tensors:
    """Zero corrections (and RbmSparse's Q at the prior) beside ``params``."""
    st = {"vh_corr": torch.zeros_like(params["weight"]),
          "vb_corr": torch.zeros_like(params["vis_bias"]),
          "hb_corr": torch.zeros_like(params["hid_bias"])}
    if isinstance(spec, RbmSparse):
        st["sparsity_q"] = torch.full_like(params["hid_bias"], cfg.sparsity_prior)
    return st


def cd1_stats(pos_vis, pos_hid, neg_vis, neg_hid) -> Tensors:
    """The CD-1 sums over the bunch that the Hinton update needs."""
    return {"vh": pos_vis.T @ pos_hid - neg_vis.T @ neg_hid,
            "vb": pos_vis.sum(0) - neg_vis.sum(0),
            "hb": pos_hid.sum(0) - neg_hid.sum(0),
            "q_sum": pos_hid.sum(0),
            "vis_sum": pos_vis.sum(0)}


@torch.no_grad()
def apply_rbm_update_from_stats(spec: Rbm, cfg: RbmTrainConfig, params: Tensors,
                                state: Tensors, stats: Tensors, n_frames: int):
    """The Hinton-recipe CD-1 update from summed statistics
    (cuRbm.cc:131-174, cuRbmSparse.cc:131-195), in place; returns
    (params, state)."""
    w = params["weight"]
    nf = np.float32(n_frames)
    a = float(np.float32(cfg.learning_rate) / nf)            # lr / N in f32
    mmt, decay = cfg.momentum, cfg.learning_rate * cfg.weightcost
    vh, vb, hb = state["vh_corr"], state["vb_corr"], state["hb_corr"]
    vh.mul_(mmt).add_(stats["vh"], alpha=a).sub_(w, alpha=decay)
    vb.mul_(mmt).add_(stats["vb"], alpha=a)
    hb.mul_(mmt).add_(stats["hb"], alpha=a)
    if isinstance(spec, RbmSparse) and spec.hid_type == BERNOULLI:
        lam = cfg.sparsity_lambda
        q = state["sparsity_q"]
        q.mul_(lam).add_(stats["q_sum"] / nf, alpha=1.0 - lam)
        q_diff = q - cfg.sparsity_prior
        vh.sub_(torch.outer(stats["vis_sum"] / nf, q_diff), alpha=cfg.sparsity_cost)
        hb.sub_(q_diff, alpha=cfg.sparsity_cost)
    w.add_(vh)
    params["vis_bias"].add_(vb)
    params["hid_bias"].add_(hb)
    return params, state


def apply_rbm_update(spec: Rbm, cfg: RbmTrainConfig, params: Tensors, state: Tensors,
                     pos_vis, pos_hid, neg_vis, neg_hid):
    """``apply_rbm_update_from_stats`` over one bunch's phases."""
    return apply_rbm_update_from_stats(spec, cfg, params, state,
                                       cd1_stats(pos_vis, pos_hid, neg_vis, neg_hid),
                                       pos_vis.shape[0])


def hidden_noise(spec: Rbm, generator: torch.Generator, shape, dtype=torch.float32,
                 device: DeviceLike = None) -> torch.Tensor:
    """The negative phase's random draw: uniform thresholds for Bernoulli
    hidden units, standard normal noise for Gaussian ones."""
    dev = generator.device if device is None else device
    draw = torch.rand if spec.hid_type == BERNOULLI else torch.randn
    return draw(tuple(shape), generator=generator, dtype=dtype, device=dev)


def sample_hidden(spec: Rbm, generator: Optional[torch.Generator], pos_hid: torch.Tensor,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hidden sampling for the negative phase (TRbmCu.cc:332-339): noise
    drawn from ``generator`` unless given."""
    if noise is None:
        noise = hidden_noise(spec, generator, pos_hid.shape, pos_hid.dtype, pos_hid.device)
    if spec.hid_type == BERNOULLI:
        return (pos_hid > noise).to(pos_hid.dtype)
    return pos_hid + noise


@torch.no_grad()
def cd1_step(spec: Rbm, cfg: RbmTrainConfig, params: Tensors, state: Tensors,
             pos_vis: torch.Tensor, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One CD-1 step on a bunch, updating ``params`` and ``state`` in place;
    returns the bunch's reconstruction error ``sum((neg - pos)^2) / 2`` as
    a device scalar."""
    pos_hid = spec.apply(params, pos_vis)
    neg_vis = spec.reconstruct(params, sample_hidden(spec, generator, pos_hid, noise))
    neg_hid = spec.apply(params, neg_vis)
    mse = 0.5 * torch.sum((neg_vis - pos_vis) ** 2)
    apply_rbm_update(spec, cfg, params, state, pos_vis, pos_hid, neg_vis, neg_hid)
    return mse


class RbmTrainer:
    """The epoch loop: transformed frames into the shuffling device cache,
    each full cache drained as CD-1 bunches in order.

    ``params`` (numpy arrays or tensors, JAX's names) are copied to the
    device; ``generator`` is the noise stream (a fresh one on the device,
    seeded ``seed or 12345``, when not given)."""

    def __init__(self, spec: Rbm, params, cfg: RbmTrainConfig, bunchsize: int = 256,
                 cachesize: int = 12800, seed: int = 0, randomize: bool = True,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        if cfg.rng_impl not in RNG_IMPLS:
            raise ValueError(f"unknown rng_impl {cfg.rng_impl!r} (threefry|rbg)")
        self.device = resolve_device(device)
        self.spec = spec
        self.cfg = cfg
        self.params = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device).clone()
                       for k, v in params.items()}
        self.state = init_rbm_state(spec, self.params, cfg)
        self.cache = DeviceFrameCache(cachesize, bunchsize, seed, randomize)
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device).manual_seed(seed or 12345))
        self.mse_sum = 0.0
        self.frames = 0
        self._mses = []          # per-cache device sums, read at finish_epoch

    def _drain(self) -> None:
        stacked = self.cache.take_stacked()
        if stacked is None:
            return
        feats_all, _labels = stacked
        acc = torch.zeros((), dtype=torch.float32, device=self.device)
        for feats in feats_all:
            acc += cd1_step(self.spec, self.cfg, self.params, self.state, feats,
                            self.generator)
        self._mses.append(acc)
        self.frames += feats_all.shape[0] * feats_all.shape[1]

    def ingest_block(self, rows: torch.Tensor, valid: int) -> None:
        """Feed the first ``valid`` device rows of a block, e.g. from
        ``TransformPipeline.transform_block``."""
        self.cache.add_block(rows, valid, np.zeros(valid, np.int32))
        while self.cache.full:
            self._drain()

    def finish_epoch(self) -> None:
        """Drain the last (partial) cache, read the MSE sums, and fail on a
        NaN/Inf parameter as the reference's pos_hid.CheckData() does
        (TRbmCu.cc:356, cumatrix.h:158)."""
        if self.cache.rows > 0:
            self._drain()
        for m in self._mses:
            self.mse_sum += float(m)
        self._mses = []
        for k, v in self.params.items():
            if not bool(torch.isfinite(v).all()):
                raise FloatingPointError(
                    f"Invalid value (NaN/Inf) in RBM parameter '{k}' "
                    "after epoch — training diverged")

    def run_epoch(self, utterances: Iterable[np.ndarray], batch_utts: int = 32) -> None:
        """One epoch over host feature arrays, ``batch_utts`` at a time."""
        pend = []

        def flush():
            if pend:
                block = torch.from_numpy(np.concatenate(pend)).to(self.device)
                self.ingest_block(block, block.shape[0])
                pend.clear()

        for feats in utterances:
            pend.append(np.asarray(feats, np.float32))
            if len(pend) >= batch_utts:
                flush()
        flush()
        self.finish_epoch()

    def numpy_params(self) -> Dict[str, np.ndarray]:
        """The trained parameters as host float32 arrays (JAX's layout)."""
        return {k: v.detach().cpu().numpy() for k, v in self.params.items()}

    def report(self) -> str:
        return (f"Mse:{self.mse_sum:.10g} frames:{self.frames}"
                f" err/frm:{self.mse_sum / max(self.frames, 1):.10g}\n")

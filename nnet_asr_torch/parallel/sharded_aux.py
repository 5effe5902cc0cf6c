"""Data-parallel mesh steps for the auxiliary trainers: RBM CD-1 and the
MPE error-backprop update (port of nnet_asr_tpu/parallel/sharded_aux.py).

Bunch (or frame) rows shard over ``data``; the per-rank sums are summed
over the axis and every rank applies the same replicated update. The
``model`` axis replicates. Semantics match the single-device steps:

* CD-1: the update consumes bunch-summed statistics (``train/rbm.py``
  ``cd1_stats`` -> ``apply_rbm_update_from_stats``), so summing the
  per-rank sums reproduces the single-device sums. The sampling noise is
  drawn at the GLOBAL bunch shape from a generator seeded alike on every
  rank and row-sliced, so the sampled negative phase is the single-device
  one.
* MPE: the gradient of the surrogate ``sum(logits * err)`` is a sum over
  frames, so frame-sharding and a sum over ``data`` reproduce it; the
  update is ``train/sgd.py`` ``apply_updates``. The forward runs the
  Trainer's ``forward_body`` (``affine_sigmoid`` on each BiasedLinearity ->
  Sigmoid pair) and gathers the log posteriors for the host
  forward-backward.

The recurrent trainer's mesh mode lives in ``train/recurrent.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.components import Rbm, Softmax
from ..models.network import Network
from ..train.rbm import (RbmTrainConfig, apply_rbm_update_from_stats, cd1_stats,
                         hidden_noise, sample_hidden)
from ..train.sgd import SgdConfig, apply_updates, layer_lr_factors
from ..train.trainer import forward_body
from .mesh import Mesh


def make_sharded_cd1_step(spec: Rbm, cfg: RbmTrainConfig, mesh: Mesh):
    """Data-parallel CD-1: ``step(params, state, pos_vis, generator=None,
    noise=None) -> mse``, updating ``params`` and ``state`` (replicated,
    ``place_cd1_inputs``) in place; ``pos_vis`` is this rank's rows of the
    bunch. The noise is ``noise`` (the global bunch's) or drawn at the
    global shape from ``generator``; either way this rank takes its rows.
    ``mse`` is the global bunch's ``sum((neg - pos)^2) / 2``."""
    d_size = mesh.shape["data"]

    @torch.no_grad()
    def step(params, state, pos_vis, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        n_global = pos_vis.shape[0] * d_size
        if noise is None:
            noise = hidden_noise(spec, generator, (n_global, spec.n_outputs),
                                 pos_vis.dtype, pos_vis.device)
        noise = noise[mesh.rows(n_global)]
        pos_hid = spec.apply(params, pos_vis)
        neg_vis = spec.reconstruct(params, sample_hidden(spec, None, pos_hid, noise))
        neg_hid = spec.apply(params, neg_vis)
        stats = cd1_stats(pos_vis, pos_hid, neg_vis, neg_hid)
        keys = sorted(stats)
        summed = mesh.all_reduce_flat(
            [stats[k] for k in keys] + [0.5 * torch.sum((neg_vis - pos_vis) ** 2)], "data")
        apply_rbm_update_from_stats(spec, cfg, params, state, dict(zip(keys, summed)),
                                    n_global)
        return summed[-1]

    return step


def place_cd1_inputs(mesh: Mesh, params, state, pos_vis):
    """Copies of the CD-1 operands (host arrays) on the mesh's device:
    params and state whole, the bunch's ``data`` block of rows."""
    def put(t):
        return torch.tensor(np.asarray(t, dtype=np.float32), device=mesh.device)
    params = {k: put(v) for k, v in params.items()}
    state = {k: put(v) for k, v in state.items()}
    pos_vis = put(pos_vis)
    return params, state, pos_vis[mesh.rows(pos_vis.shape[0])].contiguous()


def make_sharded_mpe_step(net: Network, sgd_cfg: SgdConfig, mesh: Mesh):
    """Frame-sharded MPE forward + error-backprop update on ``net`` (on
    ``mesh.device``; its tensors are updated in place). Returns
    (forward, update):

    - ``forward(feats) -> (T, C)`` log posteriors of every rank's rows,
      gathered over ``data`` in row order, from this rank's (T/D, D_in)
      block of frames;
    - ``update(velocity, feats, err, n_frames)``: this rank's blocks of
      frames and of the external error; the gradient of ``sum(logits *
      err)`` summed over ``data``, then ``apply_updates`` with ``n_frames``
      (the utterance's; zero ``err`` rows of padding add nothing).
    """
    if not isinstance(net.layers[-1], Softmax):
        raise ValueError("MPE training expects a terminal <softmax>")
    body = list(net.layers)[:-1]
    factors = tuple(layer_lr_factors(net, sgd_cfg))
    params = net.params
    trainable = [(i, k) for i, (spec, f) in enumerate(zip(net.layers, factors))
                 if spec.updatable and f != 0.0 for k in spec.trainable_keys]

    @torch.no_grad()
    def forward(feats: torch.Tensor) -> torch.Tensor:
        return mesh.all_gather(torch.log_softmax(forward_body(body, feats), dim=-1), "data")

    def update(velocity: List[Dict[str, torch.Tensor]], feats: torch.Tensor,
               err: torch.Tensor, n_frames: int) -> None:
        logits = forward_body(body, feats)
        ts = [params[i][k] for i, k in trainable]
        gs = torch.autograd.grad((logits * err).sum(), ts) if ts else []
        grads = [{} for _ in params]
        for (i, k), g in zip(trainable, mesh.all_reduce_flat(list(gs), "data")):
            grads[i][k] = g
        apply_updates(net, params, velocity, grads, sgd_cfg, n_frames, factors)

    return forward, update

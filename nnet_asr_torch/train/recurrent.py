"""Recurrent-network trainer with truncated BPTT (port of
nnet_asr_tpu/train/recurrent.py, the TRecurrentCu path).

Two modes, both updating the network's own tensors in place through the
port's ``train/sgd.py`` ``apply_updates``:

- **Segments of K frames** (the default, JAX ``recurrent.py:110-208``): a
  batch of utterances is cut into segments of K frames; each segment runs
  forward through the stack (a <recurrent> layer steps through its K frames
  from the carried state, detached, so the gradient stops at segment
  boundaries), CE on the pre-softmax logits of the terminal <softmax>, the
  gradient, then one update with the summed gradient of the batch.
  Non-recurrent layers see the segment's frames as rows (B·K, D).
- **Frame-serial** (``frame_serial=True``, JAX ``:216-336``): the reference
  trajectory, one forward and one update per frame, with the quirks of
  cuRecurrent::Update (cuRecurrent.cc:86-153): the history ring of
  ``[x_t; y_{t-1}]`` is cleared per utterance, while the output buffer
  ``y_prev`` and the bias-correction accumulator persist across utterances;
  the weight correction carries no momentum, the bias correction does; the
  generic SGD step masks the recurrent layer out with factor 0.

JAX pads the segment count to multiples of 16 and frame-serial utterances
to 64 frames to bound XLA compiles; the padded segments and frames are
exact no-ops there, and the port has none. The frame count of each update
comes from the host mask, so no step waits for the device.

On a mesh (``mesh=``, ``parallel/mesh.py``) the utterances of a batch shard
over ``data`` (JAX ``:140-207``): the batch is padded to a multiple of D
with empty utterances, rank ``d`` takes the ``d``-th block, every rank
walks the segments of the batch's global ``T_max`` (the same collectives
everywhere; a segment with no live frame anywhere is skipped on every
rank), sums the segment gradient over ``data`` and applies the update with
the global frame count. The frame-serial mode has no data axis and raises.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.components import Recurrent, Softmax
from ..models.network import Network
from ..ops.objectives import XentStats
from .sgd import SgdConfig, apply_updates, check_updatable, init_momentum, layer_lr_factors


@dataclass
class RecurrentTrainerConfig:
    bptt_order: int = 4              # TRecurrentCu.cc:194 default
    crossvalidate: bool = False
    sgd: SgdConfig = field(default_factory=SgdConfig)
    # the reference's frame-serial trajectory (one update per frame); for
    # validation runs, orders of magnitude slower than segments
    frame_serial: bool = False


class RecurrentTrainer:
    def __init__(self, net: Network, cfg: RecurrentTrainerConfig, mesh=None,
                 device: DeviceLike = None):
        """``mesh``: this rank's ``parallel.mesh.Mesh`` (its device is then
        the Trainer's)."""
        if mesh is not None and cfg.frame_serial:
            raise ValueError("frame_serial parity mode is single-device "
                             "(one frame at a time has no data axis)")
        if mesh is not None:
            device = mesh.device
        self.mesh = mesh
        net.check_dims()
        if not (len(net.layers) and isinstance(net.layers[-1], Softmax)):
            raise ValueError("recurrent trainer expects terminal <softmax>")
        self.net = net
        self.cfg = cfg
        self.device = resolve_device(device)
        net.to(self.device)
        self.params = net.params              # the modules' own tensors
        self.factors = tuple(layer_lr_factors(net, cfg.sgd))
        check_updatable(net, cfg.sgd.momentum, self.factors)
        self.velocity = init_momentum(net, cfg.sgd.momentum, cfg.sgd.velocity_dtype)
        self.rec_idx = [i for i, layer in enumerate(net.layers) if isinstance(layer, Recurrent)]
        self._stats = XentStats()
        self._accs: List[Tuple[Dict[str, torch.Tensor], int]] = []
        if cfg.frame_serial:
            self._init_serial()

    def _flush_acc(self) -> None:
        for acc, frames in self._accs:
            self._stats.add(float(acc["xent"]), frames, int(acc["correct"]))
        self._accs = []

    @property
    def stats(self) -> XentStats:
        """The epoch's statistics, with the device sums read on access."""
        self._flush_acc()
        return self._stats

    @stats.setter
    def stats(self, value: XentStats) -> None:
        self._stats = value

    def _zero_acc(self) -> Dict[str, torch.Tensor]:
        return {"xent": torch.zeros((), dtype=torch.float32, device=self.device),
                "correct": torch.zeros((), dtype=torch.int64, device=self.device)}

    def _trainables(self, factors: Sequence[float], layers: Sequence[int]):
        """(layer, key) of every tensor that gets a gradient."""
        return [(i, k) for i in layers if self.net.layers[i].updatable and factors[i] != 0.0
                for k in self.net.layers[i].trainable_keys]

    def _grads(self, loss, keys, extra=()):
        """Gradients of ``loss`` as ``apply_updates`` takes them, and those
        of the ``extra`` tensors."""
        gs = torch.autograd.grad(loss, [self.params[i][k] for i, k in keys] + list(extra))
        grads = [{} for _ in self.params]
        for (i, k), g in zip(keys, gs):
            grads[i][k] = g
        return grads, gs[len(keys):]

    # ------------------------------------------------------------------
    # segments of K frames
    def _forward_seg(self, x: torch.Tensor, h_list: List[torch.Tensor]):
        """(B·K, C) logits of a (B, K, D) segment and the recurrent layers'
        last states."""
        B, K = x.shape[:2]
        layers = self.net.layers
        h_out, h, ri = list(h_list), x, 0
        for i, layer in enumerate(layers):
            if isinstance(layer, Recurrent):
                h = h.reshape(B, K, -1)
                h, h_out[ri] = layer.apply_with_state(self.params[i], h, h_list[ri])
                ri += 1
            elif i == len(layers) - 1:
                break                    # the terminal softmax: logits are its input
            else:
                h = layer.apply(self.params[i], h.reshape(B * K, -1))
        return h.reshape(B * K, -1), h_out

    def _seg_loss(self, x, labels, mask, h_list):
        logits, h_new = self._forward_seg(x, h_list)
        picked = torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
        zero = torch.zeros((), dtype=picked.dtype, device=picked.device)
        loss = -torch.where(mask, picked, zero).sum()
        stats = {"xent": -torch.where(mask, torch.clamp(picked.detach(), min=-1e10), zero).sum(),
                 "correct": (mask & (torch.argmax(logits.detach(), dim=-1) == labels)).sum()}
        return loss, stats, h_new

    def train_batch(self, feats_list, labels_list) -> None:
        """Train (or, crossvalidating, evaluate) a batch of utterances
        together: one update per segment with the gradient summed over the
        batch. One utterance is TRecurrentCu's utterance-serial schedule."""
        K, dev = self.cfg.bptt_order, self.device
        D = feats_list[0].shape[1]
        feats_list, labels_list = list(feats_list), list(labels_list)
        if self.mesh is not None:
            # empty utterances to a multiple of the data axis: exact no-ops
            while len(feats_list) % self.mesh.shape["data"]:
                feats_list.append(np.zeros((0, D), np.float32))
                labels_list.append(np.zeros((0,), np.int64))
        T_max = max(f.shape[0] for f in feats_list)
        n_seg = -(-T_max // K)
        M = np.zeros((len(feats_list), n_seg * K), bool)      # the whole batch's
        for b, f in enumerate(feats_list):
            M[b, :f.shape[0]] = True
        mine = slice(None) if self.mesh is None else self.mesh.rows(len(feats_list))
        feats_list, labels_list = feats_list[mine], labels_list[mine]
        B = len(feats_list)
        F = torch.zeros((B, n_seg * K, D), dtype=torch.float32, device=dev)
        L = np.zeros((B, n_seg * K), np.int64)
        for b, (f, lab) in enumerate(zip(feats_list, labels_list)):
            T = f.shape[0]
            F[b, :T] = torch.as_tensor(f, dtype=torch.float32, device=dev)
            L[b, :T] = lab
        L_dev = torch.from_numpy(L).to(dev)
        M_dev = torch.from_numpy(M[mine]).to(dev)
        keys = self._trainables(self.factors, range(len(self.params)))
        h_list = [torch.zeros((B, self.net.layers[i].n_outputs), device=dev)
                  for i in self.rec_idx]
        acc = self._zero_acc()
        for s in range(n_seg):
            cols = slice(s * K, (s + 1) * K)
            n_frames = int(M[:, cols].sum())
            if n_frames == 0:
                continue
            x = F[:, cols]
            labels, mask = L_dev[:, cols].reshape(-1), M_dev[:, cols].reshape(-1)
            h_list = [h.detach() for h in h_list]
            if self.cfg.crossvalidate:
                with torch.no_grad():
                    _, stats, h_list = self._seg_loss(x, labels, mask, h_list)
            else:
                loss, stats, h_list = self._seg_loss(x, labels, mask, h_list)
                grads, _ = self._grads(loss, keys)
                if self.mesh is not None:
                    gs = self.mesh.all_reduce_flat([grads[i][k] for i, k in keys], "data")
                    for (i, k), g in zip(keys, gs):
                        grads[i][k] = g
                apply_updates(self.net, self.params, self.velocity, grads, self.cfg.sgd,
                              n_frames, self.factors)
            for k in acc:
                acc[k] += stats[k]
        if self.mesh is not None and self.mesh.shape["data"] > 1:
            flat = self.mesh.all_reduce(torch.stack([acc[k].double() for k in acc]), "data")
            acc = {k: flat[n].to(acc[k].dtype) for n, k in enumerate(acc)}
        self._accs.append((acc, int(M.sum())))

    def train_utterance(self, feats, labels) -> None:
        self.train_batch([feats], [labels])

    def run_epoch(self, utterances, batch_utts: int = 1) -> None:
        """One epoch over (feats, labels) pairs, ``batch_utts`` at a time."""
        pend_f, pend_l = [], []
        for feats, labels in utterances:
            pend_f.append(feats)
            pend_l.append(np.asarray(labels, np.int64))
            if len(pend_f) >= batch_utts:
                self.train_batch(pend_f, pend_l)
                pend_f, pend_l = [], []
        if pend_f:
            self.train_batch(pend_f, pend_l)
        self._flush_acc()

    # ------------------------------------------------------------------
    # frame-serial (TRecurrentCu.cc:357-371 + cuRecurrent.cc:86-153)
    def _init_serial(self) -> None:
        if len(self.rec_idx) != 1:
            raise ValueError("frame-serial mode supports exactly one <recurrent> layer")
        ridx = self.rec_idx[0]
        n_out_r = self.net.layers[ridx].n_outputs
        # the recurrent layer updates by hand below; the generic step skips it
        self._factors_no_r = tuple(0.0 if i == ridx else f for i, f in enumerate(self.factors))
        self._below_keys = self._trainables(self._factors_no_r, range(ridx))
        self._above_keys = self._trainables(self._factors_no_r,
                                            range(ridx + 1, len(self.params)))
        self._serial_y = torch.zeros((n_out_r,), device=self.device)
        self._serial_bias_corr = torch.zeros((n_out_r,), device=self.device)

    def train_utterance_serial(self, feats, labels) -> None:
        """The reference's frame-serial training of one utterance."""
        cfg, sgd, layers = self.cfg, self.cfg.sgd, self.net.layers
        ridx = self.rec_idx[0]
        rl = layers[ridx]
        n_in, K = rl.n_inputs, cfg.bptt_order
        lr_r = sgd.learning_rate * self.factors[ridx]
        W, b = self.params[ridx]["weight"], self.params[ridx]["bias"]
        x_all = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        labels = np.asarray(labels, np.int64)
        # ClearHistory zeroes only the ring (cuRecurrent.h:36-38)
        hist = torch.zeros((K + 1, W.shape[0]), device=self.device)
        y_prev, bias_corr = self._serial_y, self._serial_bias_corr
        acc = self._zero_acc()
        for t in range(x_all.shape[0]):
            label = int(labels[t])
            u = x_all[t:t + 1]
            for i in range(ridx):
                u = layers[i].apply(self.params[i], u)
            with torch.no_grad():
                # history row 0 is [x_t; y_{t-1}], y from the layer's
                # persistent output buffer (cuRecurrent.cc:28-32)
                h_in = torch.cat([u[0].detach(), y_prev])
                hist = torch.cat([h_in[None], hist[:-1]])
                y = torch.sigmoid(h_in @ W + b)
            y_leaf = y[None].clone().requires_grad_(True)
            h = y_leaf
            for i in range(ridx + 1, len(layers) - 1):
                h = layers[i].apply(self.params[i], h)
            picked = torch.log_softmax(h, dim=-1)[0, label]
            grads, (g_y,) = self._grads(-picked, self._above_keys, (y_leaf,))
            with torch.no_grad():
                acc["xent"] -= torch.clamp(picked.detach(), min=-1e10)
                acc["correct"] += torch.argmax(h.detach()[0]) == label
                e_rec = g_y[0]
                # cuRecurrent::Update: present frame, then the BPTT-K walk
                d0 = e_rec * y * (1.0 - y)
                d, corr_W = d0, torch.outer(hist[0], d0)
                new_bias_corr = sgd.momentum * bias_corr - lr_r * d
                W_h = W[n_in:]
                for i in range(1, K + 1):
                    y_hist = hist[i - 1, n_in:]              # y_{t-i}
                    d = (d @ W_h.T) * y_hist * (1.0 - y_hist)
                    corr_W = corr_W + torch.outer(hist[i], d)
                    new_bias_corr = new_bias_corr - lr_r * d
                new_W = W - lr_r * corr_W - lr_r * sgd.weightcost * W
                # the error into the layers below (BackpropagateFnc: W[:in] @ d0)
                e_below = (d0 @ W[:n_in].T)[None]
            if self._below_keys:
                gs = torch.autograd.grad(u, [self.params[i][k] for i, k in self._below_keys],
                                         grad_outputs=e_below)
                for (i, k), g in zip(self._below_keys, gs):
                    grads[i][k] = g
            apply_updates(self.net, self.params, self.velocity, grads, sgd, 1,
                          self._factors_no_r)
            with torch.no_grad():
                W.copy_(new_W)
                b.add_(new_bias_corr)
            y_prev, bias_corr = y, new_bias_corr
        self._serial_y, self._serial_bias_corr = y_prev, bias_corr
        self._accs.append((acc, int(x_all.shape[0])))

    # ------------------------------------------------------------------
    def updated_network(self) -> Network:
        """A host (CPU) copy of the trained network."""
        return copy.deepcopy(self.net).to("cpu")

    def report(self) -> str:
        return self.stats.report()

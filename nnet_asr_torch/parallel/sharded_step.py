"""Sharded training step: data parallelism x senone-sharded output layer
(port of nnet_asr_tpu/parallel/sharded_step.py).

One rank of a (data, model) mesh (``parallel/mesh.py``) runs
``ShardedStep``, the single-device ``Trainer`` on its share of the work:

* ``data``: each rank takes its block of rows of every global bunch
  (JAX ``P("data")``); the gradients are summed over the axis and every
  rank applies the same update with ``apply_updates`` at
  ``global_frames = local_rows * D``. The statistics are summed over it.
* ``model``: the senone-producing BiasedLinearity (``find_output_layer``)
  is column-sharded; every other parameter is replicated. Senones that do
  not divide ``M`` are padded to ``n_out_pad``; the padded columns are
  masked out of the softmax (logits -1e30), so their gradients, momentum
  and L2 terms are zero, and they are sliced off on the way out.

Gradients: the replicated parameters' are summed over ``data x model``
(on a model rank they are partial: its stripe's share of ``dh`` at the
output layer's input), the output stripe's over ``data`` only, as JAX
``:306-310``. The head gives each rank its own stripe's gradient, counted
once:

* plain Softmax + CE, ``M > 1``: a distributed log-softmax
  (``_ShardedSoftmaxXent``): the row max an ``all_reduce(MAX)``, the
  exp-sum and the picked logit one ``all_reduce(SUM)`` over ``model``; its
  backward is the local ``softmax - onehot`` (JAX scales each model rank's
  loss copy by 1/M to the same end). The argmax is first-max-wins: MAX,
  then MIN over the candidate columns.
* BlockSoftmax heads and MSE, ``M > 1``: ``_GatherColumns`` all-gathers
  the logit stripes and the Trainer's exact single-device loss runs on the
  full logits; its backward slices the rank's stripe.
* ``M == 1``: no padding and no collective; the Trainer's own loss, so a
  plain Softmax + CE runs the ``fused_softmax_xent`` kernel.

The forward is the Trainer's: ``forward_body`` with ``affine_sigmoid`` on
each BiasedLinearity -> Sigmoid pair and ``affine`` on the output stripe,
under the same compute dtypes (bf16 casts; int8 fake-quant, whose
per-tensor activation scale of plain ``int8`` is an ``all_reduce(MAX)``
over ``data`` so it is the global bunch's, and ``int8pfsr``'s noise is
drawn at the global bunch shape from the Trainer's generator, seeded alike
on every rank, and row-sliced, so the stream is the single-device one).
``int8full`` is refused, as in JAX. ``wgrad_momentum_update`` is not
launched on a mesh: its update needs the gradient summed across ranks
first. JAX's mesh runs XLA and refuses Pallas; the kernels here compute
the same functions, so that is a choice of mechanism, not of semantics.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.components import BiasedLinearity, BlockSoftmax, Softmax
from ..models.network import Network
from ..ops.int8_train import fake_quant_ste
from ..train.sgd import SgdConfig, apply_updates
from ..train.trainer import Trainer, TrainerConfig
from .mesh import Mesh

MESH_DTYPES = (None, "bf16", "int8", "int8pf", "int8pfsr")


def find_output_layer(net: Network, objective: str) -> Tuple[int, Optional[tuple], bool]:
    """(index of the senone-producing BiasedLinearity, BlockSoftmax dims or
    None, has a softmax head) (JAX ``_find_output_layer``): a terminal
    (Block)Softmax fed by a BiasedLinearity; MSE also takes a terminal
    BiasedLinearity."""
    layers = list(net.layers)
    if (len(layers) >= 2 and isinstance(layers[-1], (Softmax, BlockSoftmax))
            and isinstance(layers[-2], BiasedLinearity)):
        dims = layers[-1].dims if isinstance(layers[-1], BlockSoftmax) else None
        return len(layers) - 2, dims, True
    if objective == "mse" and layers and isinstance(layers[-1], BiasedLinearity):
        return len(layers) - 1, None, False
    raise ValueError(
        "sharded step expects ... -> <biasedlinearity> -> <(block)softmax>"
        + (" (or a terminal <biasedlinearity> for MSE)" if objective == "mse" else ""))


class _ShardedSoftmaxXent(torch.autograd.Function):
    """Softmax + CE over logits column-sharded on ``model``: (clamped Xent
    sum, first-max correct count), each the same on every model rank; the
    backward is the rank's stripe of ``softmax - onehot``. Forward
    collectives: all_reduce MAX, SUM and MIN over ``model``."""

    @staticmethod
    def forward(ctx, logits, labels, mesh: Mesh, n_out: int):
        B, L = logits.shape
        n_pad = L * mesh.shape["model"]
        off = mesh.model_index * L
        cols = off + torch.arange(L, device=logits.device)
        z = logits.masked_fill((cols >= n_out)[None, :], -1e30)
        lmax = z.max(dim=1).values
        first = torch.where(z >= lmax[:, None], cols[None, :], n_pad).min(dim=1).values
        gmax = mesh.all_reduce(lmax.clone(), "model", "max")
        e = torch.exp(z - gmax[:, None])
        loc = labels.long() - off
        own = (loc >= 0) & (loc < L)
        picked = torch.where(own, z.gather(1, loc.clamp(0, L - 1)[:, None])[:, 0],
                             torch.zeros((), dtype=z.dtype, device=z.device))
        sums = mesh.all_reduce(torch.stack([e.sum(dim=1), picked]), "model")
        logp = sums[1] - gmax - torch.log(sums[0])
        pred = mesh.all_reduce(torch.where(lmax >= gmax, first, n_pad), "model", "min")
        correct = (pred == labels.long()).sum().to(torch.int32)
        ctx.save_for_backward(e / sums[0][:, None], loc, own)
        ctx.mark_non_differentiable(correct)
        return -torch.clamp(logp, min=-1e10).sum(), correct

    @staticmethod
    def backward(ctx, g_loss, _g_correct):
        p, loc, own = ctx.saved_tensors
        err = p.clone()
        rows = own.nonzero()[:, 0]
        err[rows, loc[rows]] -= 1.0
        return err * g_loss, None, None, None


class _GatherColumns(torch.autograd.Function):
    """The full (B, n_out) logits from their ``model`` stripes (all_gather);
    the backward is the rank's stripe of the gradient (padding zero)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, n_out: int):
        ctx.mesh, ctx.width = mesh, x.shape[1]
        return mesh.all_gather(x, "model", dim=1)[:, :n_out]

    @staticmethod
    def backward(ctx, g):
        mesh, L = ctx.mesh, ctx.width
        full = torch.nn.functional.pad(g, (0, L * mesh.shape["model"] - g.shape[1]))
        lo = mesh.model_index * L
        return full[:, lo:lo + L].contiguous(), None, None


class ShardedStep(Trainer):
    """One rank's Trainer on a mesh (see the module doc). ``params`` and
    ``velocity`` are this rank's: the output layer ``out_idx`` holds its
    padded column stripe. The caller's network is copied, not trained."""

    def __init__(self, net: Network, cfg: TrainerConfig, mesh: Mesh,
                 transform: Optional[Network] = None,
                 start_frm_ext: int = 0, end_frm_ext: int = 0):
        if cfg.compute_dtype not in MESH_DTYPES:
            raise ValueError(
                f"compute_dtype {cfg.compute_dtype!r} is not supported on a mesh "
                "(supported: bf16, int8, int8pf, int8pfsr; int8full is "
                "single-chip-only)")
        if cfg.confusion_mode != "no":
            raise ValueError("--CONFUSIONMODE has no mesh implementation; run on one device")
        net.check_dims()
        out_idx, block_dims, has_softmax = find_output_layer(net, cfg.objective)
        self.mesh = mesh
        self.out_idx = out_idx
        full = copy.deepcopy(net).to("cpu")
        out = full.layers[out_idx]
        self.n_out = out.n_outputs
        m_size = mesh.shape["model"]
        self.n_out_pad = -(-self.n_out // m_size) * m_size
        width = self.n_out_pad // m_size
        stripe = BiasedLinearity(out.n_inputs, width).load_params(
            {k: self._stripe(v) for k, v in full.to_numpy_params()[out_idx].items()})
        local = Network(list(full.layers[:out_idx]) + [stripe]
                        + ([Softmax(width, width)] if has_softmax else []))
        super().__init__(local, cfg, transform, start_frm_ext, end_frm_ext, device=mesh.device)
        self._full = full                # the body's modules are the local net's
        self._block_dims = block_dims
        self._sharded_ce = cfg.objective == "xent" and block_dims is None and m_size > 1
        # no fused wgrad+momentum update: every tensor takes autograd, the
        # cross-rank sum, then apply_updates
        self._fused = []
        self._trainable = [(i, k) for i, (spec, f) in enumerate(zip(local.layers, self.factors))
                           if spec.updatable and f != 0.0 for k in spec.trainable_keys]

    # -- senone padding -------------------------------------------------
    def _stripe(self, a: np.ndarray) -> np.ndarray:
        """This model rank's columns of an output-layer array (last axis
        n_out), zero-padded to n_out_pad first."""
        pad = [(0, 0)] * (a.ndim - 1) + [(0, self.n_out_pad - self.n_out)]
        width = self.n_out_pad // self.mesh.shape["model"]
        lo = self.mesh.model_index * width
        return np.ascontiguousarray(np.pad(a, pad)[..., lo:lo + width])

    def _gather_out(self, t: torch.Tensor) -> np.ndarray:
        """The unpadded host array of an output-layer tensor (collective:
        all_gather over ``model``)."""
        full = self.mesh.all_gather(t.detach(), "model", dim=-1)[..., :self.n_out]
        return full.to("cpu", torch.float32).numpy().copy()

    def host_params(self) -> List[dict]:
        """Every layer's parameters as host arrays, the output layer
        gathered and unpadded (collective: every rank calls it)."""
        params = self.net.to_numpy_params()[:self.out_idx + 1]
        params[self.out_idx] = {k: self._gather_out(t) for k, t in self.params[self.out_idx].items()}
        return params + self._full.to_numpy_params()[self.out_idx + 1:]

    # -- the step --------------------------------------------------------
    def _int8_affine(self, spec: BiasedLinearity, x: torch.Tensor,
                     train: bool) -> torch.Tensor:
        """JAX ``_bl_matmul`` under int8 on the mesh: plain int8's scale is
        the global bunch's, int8pfsr's noise the global bunch's rows."""
        mode = self.cfg.compute_dtype
        if mode == "int8":
            amax = self.mesh.all_reduce(x.detach().abs().amax(), "data", "max")
            xq = fake_quant_ste(x, None, amax=amax)
        else:
            noise = None
            if mode == "int8pfsr" and train:
                d = self.mesh.shape["data"]
                full = torch.rand((x.shape[0] * d,) + tuple(x.shape[1:]),
                                  generator=self._sr_gen, device=x.device)
                noise = full[self.mesh.rows(full.shape[0])]
            xq = fake_quant_ste(x, -1, noise)
        return xq @ fake_quant_ste(spec.weight, 0) + spec.bias

    def _loss(self, logits: torch.Tensor, labels: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if self._sharded_ce:
            xent, correct = _ShardedSoftmaxXent.apply(logits, labels, self.mesh, self.n_out)
            return xent, {"xent": xent.detach(), "correct": correct}
        if self.mesh.shape["model"] > 1:
            logits = _GatherColumns.apply(logits, self.mesh, self.n_out)
        return super()._loss(logits, labels)

    def _train_step(self, feats: torch.Tensor, labels: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        loss, stats = self._loss(self._forward_logits(feats, train=True), labels)
        keys = self._trainable
        gs = list(torch.autograd.grad(loss, [self.params[i][k] for i, k in keys])) if keys else []
        for axis, sel in (("world", [n for n, (i, _) in enumerate(keys) if i != self.out_idx]),
                          ("data", [n for n, (i, _) in enumerate(keys) if i == self.out_idx])):
            for n, g in zip(sel, self.mesh.all_reduce_flat([gs[n] for n in sel], axis)):
                gs[n] = g
        grads = [{} for _ in self.params]
        for (i, k), g in zip(keys, gs):
            grads[i][k] = g
        apply_updates(self.net, self.params, self.velocity, grads, self.cfg.sgd,
                      feats.shape[0] * self.mesh.shape["data"], self.factors,
                      learning_rate=self._lr)
        return stats

    def reduce_stats(self, acc: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Device stats summed over ``data`` (one all_reduce, in float64)."""
        if self.mesh.size("data") == 1:
            return acc
        keys = sorted(acc)
        flat = self.mesh.all_reduce(torch.stack([acc[k].double() for k in keys]), "data")
        return {k: flat[n].to(acc[k].dtype) for n, k in enumerate(keys)}

    def _drain(self, step, feats_all, labels_all):
        return self.reduce_stats(super()._drain(step, feats_all, labels_all))


class ShardedTrainState:
    """The per-rank state of a mesh step (JAX ``ShardedTrainState``):
    ``params``/``velocity`` (the output layer's padded stripe), ``out_idx``,
    ``n_out``, ``n_out_pad``, and ``host_params()`` (collective)."""

    def __init__(self, step: ShardedStep):
        self._step = step
        self.out_idx, self.n_out, self.n_out_pad = step.out_idx, step.n_out, step.n_out_pad

    @property
    def params(self) -> List[dict]:
        return self._step.params

    @property
    def velocity(self) -> List[dict]:
        return self._step.velocity

    def host_params(self) -> List[dict]:
        return self._step.host_params()


def zero_acc(objective: str = "xent", device=None) -> Dict[str, torch.Tensor]:
    z = {"frames": torch.zeros((), dtype=torch.int64, device=device)}
    if objective == "mse":
        return {"mse": torch.zeros((), dtype=torch.float32, device=device), **z}
    return {"xent": torch.zeros((), dtype=torch.float32, device=device),
            "correct": torch.zeros((), dtype=torch.int32, device=device), **z}


def make_sharded_train_step(net: Network, sgd_cfg: SgdConfig, mesh: Mesh,
                            objective: str = "xent", compute_dtype: Optional[str] = None,
                            seed: int = 0):
    """(state, step, eval, fns) of a mesh step (JAX
    ``make_sharded_train_step``), on this rank's rows:

    - ``step(acc, feats, labels, lr=None) -> acc``: one training step on
      (B/D, D_in) feats and (B/D,) int32 labels on ``mesh.device``,
      updating ``state`` in place; ``acc`` (``zero_acc``) gains the
      bunch's global stats;
    - ``eval(acc, feats, labels) -> acc``;
    - ``fns["drain_train"](acc, feats_all, labels_all, lr=None)`` and
      ``fns["drain_eval"](acc, feats_all, labels_all)`` over (nb, B/D, ...)
      stacks. ``lr`` is the runtime learning rate (newbob).

    ``seed`` seeds int8pfsr's noise (``seed or 1``, as the Trainer)."""
    s = ShardedStep(net, TrainerConfig(objective=objective, sgd=sgd_cfg, seed=seed,
                                       compute_dtype=compute_dtype), mesh)
    d = mesh.shape["data"]

    def add(acc, stats, rows):
        out = {k: acc[k] + stats[k] for k in stats}
        out["frames"] = acc["frames"] + rows * d
        return out

    def drain_train(acc, feats_all, labels_all, lr=None):
        if lr is not None:
            s.set_learning_rate(lr)
        return add(acc, s.drain_train(feats_all, labels_all), labels_all.numel())

    def drain_eval(acc, feats_all, labels_all):
        return add(acc, s.drain_eval(feats_all, labels_all), labels_all.numel())

    def step(acc, feats, labels, lr=None):
        return drain_train(acc, feats[None], labels[None], lr)

    def evalf(acc, feats, labels):
        return drain_eval(acc, feats[None], labels[None])

    fns = {"step": step, "eval": evalf, "drain_train": drain_train, "drain_eval": drain_eval}
    return ShardedTrainState(s), step, evalf, fns

"""Single-device frame-level CE/MSE trainer (port of nnet_asr_tpu/train/trainer.py).

The epoch loop mirrors TNetCu.cc:376-442: fill the device cache through
the transform pipeline, shuffle, and run each cache of stacked bunches
through forward + objective + backward + SGD, or forward only in
crossvalidate mode (TNet.cc:96-231). The JAX package's ``lax.scan`` drain
is a Python loop over the stacked bunches here.

The forward pass goes through the hand-written kernels where the JAX
package's Pallas path (``use_pallas=True``) does: every BiasedLinearity →
Sigmoid pair through ``affine_sigmoid`` (trainer.py:158-165), under every
objective. The loss is routed as trainer.py:200-216 routes it: a terminal
Softmax with CE and no confusion mode through ``fused_softmax_xent``; a
BlockSoftmax head, or any confusion mode, through the plain
``xent_loss_and_stats`` (the confusion matrix is then
``onehot(labels)ᵀ @ {onehot(argmax logits) | softmax(logits)}`` over the
whole row, as in JAX); MSE against one-hot targets, through
``softmax_identity_backward`` when the net ends in a (Block)Softmax and on
the raw outputs when it does not.
With momentum, the weight matrix of every updatable BiasedLinearity is
updated inside the backward pass by the fused wgrad+momentum kernel
(``wgrad_momentum_update``, the TPU kernel the JAX package runs only in its
``mom9_fused`` probe, scripts/mfu_drain_ab.py:96-113): the layer's
``autograd.Function`` hands its input and pre-activation error to
``sgd.fused_weight_step`` after ``dx`` has used the old weights, so no
weight gradient is formed; biases and the other layers' tensors
(SparseLinearity, ClusterLinearity and Rbm weights among them, which JAX
also updates outside Pallas) take ``apply_updates``. The result is the JAX
step's: each weight is read only by its own layer's backward. On a CUDA
device the kernels launch; on the CPU they run their plain PyTorch
versions. Other layers are plain torch ops.

The compute dtypes of JAX ``TrainerConfig.compute_dtype``
(trainer.py:111-184) route the forward pass:

- ``'bf16'``: the input is cast to bf16 once, and each BiasedLinearity's
  weight and bias are cast per step from their f32 masters, which the SGD
  step (and the fused hook) updates. The BiasedLinearity → Sigmoid pairs
  run ``affine_sigmoid``'s bf16 kernel, its backward rounding as JAX
  ``_bwd`` does; other BiasedLinearities compute ``x @ W`` and ``+ b`` each
  rounded to bf16, as XLA does. A layer with f32 parameters
  (SparseLinearity, Bias, Window, Rbm, ...) promotes a bf16 input to f32,
  as jnp's rules do, and a BiasedLinearity after it then computes in f32
  with its parameters rounded through bf16 (``_bf16_inputs``); such a
  layer's weight takes autograd and ``apply_updates`` with momentum, its
  gradient rounded to bf16 by the cast. The logits go back to f32 for the
  loss. With momentum, the fused hook gets bf16 ``x`` and ``dz`` and
  launches ``wgrad_momentum_update``'s bf16 entry point.
- ``'int8'``, ``'int8pf'``, ``'int8pfsr'``: each BiasedLinearity computes
  ``fq(x) @ fq(W) + b`` with the straight-through fake-quant of
  ``ops/int8_train.py`` (W per output channel; x per tensor, or per row
  for ``pf``). ``'int8pfsr'`` rounds x stochastically in training, with
  uniform noise from one ``torch.Generator`` seeded by ``seed or 1`` that
  advances every step and lives as long as the Trainer (eval rounds to
  nearest); its stream is not JAX's. ``'int8full'``: ``qmatmul(x, W) + b``,
  all three GEMMs fake-quantized. Any int8 mode takes precedence over the
  ``affine_sigmoid`` fusion, and the momentum hooks are off (JAX's momentum
  path has none): every weight takes autograd and ``apply_updates``.
  ``fused_softmax_xent`` still takes the f32 logits.

On a CUDA card an f32 CE step through ``fused_softmax_xent`` is replayed
from a CUDA graph (``Trainer._graph_step``): the first step of a bunch
shape, learning rate and set of state tensors runs eagerly, the next is
captured, the rest replay it, with the eager step's kernels and results.
Statistics accumulate per cache in f32/int32 device tensors and merge into
float64 host totals at the end of the epoch (ObjFun.h:16-54), so the loop
never waits for the device. The profiler's spans (``utils/profiler.py``)
mark each bunch's step and its forward (the output layer's too), loss (the
fused softmax-CE too), backward and update (under ``-T 4`` every step runs
eagerly; under a ``torch.profiler`` session a graphed step replays graphs
that hold its spans), and the intake: the reader threads' reads and label
lookups, the wait for the next utterance, the transform, the cache fill
and its shuffle and gather.
"""

from __future__ import annotations

import collections
import copy
import functools
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..utils.prefetch import prefetch_map
from ..utils.profiler import GraphSpans, profiler

from ..device import DeviceLike, resolve_device
from ..models.components import BiasedLinearity, BlockSoftmax, Sigmoid, Softmax
from ..models.network import Network
from ..ops.kernels.matmul_act import affine, affine_sigmoid, dgrad, matmul_act
from ..ops.int8_train import fake_quant_ste, qmatmul
from ..ops.kernels.sgd_fused import wgrad_momentum_update
from ..ops.kernels.softmax_ce import fused_softmax_xent, softmax_xent
from ..ops.objectives import (MseStats, XentStats, mse_loss_and_stats, one_hot,
                              softmax_identity_backward, xent_loss_and_stats)
from .cache import DeviceFrameCache
from .pipeline import TransformPipeline
from .sgd import (SgdConfig, apply_updates, check_updatable, fused_weight_step,
                  init_momentum, layer_coeffs, layer_lr_factors)

CONFUSION_MODES = ("no", "max", "soft", "dmax", "dsoft")
INT8_MODES = ("int8", "int8pf", "int8pfsr", "int8full")
COMPUTE_DTYPES = (None, "bf16") + INT8_MODES


def forward_body(body, x: torch.Tensor, updates: Optional[dict] = None,
                 weights: Optional[Callable] = None,
                 layer: Optional[Callable] = None) -> torch.Tensor:
    """The forward of ``body`` (a network's layers without its softmax
    head), as the JAX package's Pallas path computes it: every
    BiasedLinearity → Sigmoid pair through ``affine_sigmoid``, any other
    BiasedLinearity through ``affine`` (the last, the output layer, in the
    profiler's span ``forward.output``), every other layer plain.
    ``updates`` maps a layer index to its weight-update hook (the momentum
    step through the fused wgrad+momentum kernel); ``weights(i, spec)``
    gives a BiasedLinearity's (w, b), by default its own f32 tensors;
    ``layer(spec, x)`` applies any other layer, by default ``spec(x)``."""
    updates = updates or {}
    i = 0
    while i < len(body):
        spec = body[i]
        if isinstance(spec, BiasedLinearity):
            w, b = (spec.weight, spec.bias) if weights is None else weights(i, spec)
            if i + 1 < len(body) and isinstance(body[i + 1], Sigmoid):
                x = affine_sigmoid(x, w, b, updates.get(i))
                i += 2
                continue
            if i + 1 == len(body):
                # the output layer, timed on the card under torch.profiler too
                with profiler.phase("forward.output", x.device, timed_in_trace=True):
                    x = affine(x, w, b, updates.get(i))
            else:
                x = affine(x, w, b, updates.get(i))
            i += 1
            continue
        x = spec(x) if layer is None else layer(spec, x)
        i += 1
    return x


def _promotes(spec) -> bool:
    """Whether the layer has f32 parameters, against which jnp promotes a
    bf16 input to f32."""
    return any(t.is_floating_point() for t in itertools.chain(spec.parameters(),
                                                                spec.buffers()))


def _promoting_call(spec, x: torch.Tensor) -> torch.Tensor:
    """``spec(x)``, with a bf16 ``x`` promoted to f32 first where the layer
    has f32 parameters."""
    if x.dtype == torch.bfloat16 and _promotes(spec):
        x = x.float()
    return spec(x)


def read_utterances(reader, entries, labels_repo, start_frm_ext: int = 0,
                    end_frm_ext: int = 0, workers: int = 4
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(ext_feats, frame labels) of each SCP entry, in order, read by a
    pool of ``workers`` threads (the Platform reader-thread analog); the
    ``FeatureReader`` keeps per-read state (last_header, norm caches), so
    each thread reads through its own copy."""
    tls = threading.local()

    def read_one(e):
        rd = getattr(tls, "reader", None)
        if rd is None:
            rd = tls.reader = copy.copy(reader)
        with profiler.phase("intake.read"):
            feats = rd.read(e.physical, e.logical)
        n_real = feats.shape[0] - start_frm_ext - end_frm_ext
        with profiler.phase("intake.labels"):
            labels = labels_repo.get_frame_labels(n_real, rd.last_header.sample_period,
                                                  e.logical)
        profiler.count("intake.utterances", 1)
        profiler.count("intake.frames", n_real)
        return feats, labels

    return prefetch_map(read_one, entries, workers=workers)


# the kernel wrappers whose ``launches*`` attributes count their launches
_COUNTED = (matmul_act, dgrad, wgrad_momentum_update, softmax_xent)
# the launches of steps replayed from CUDA graphs, by "<wrapper>.<counter>"
# of those wrappers: "captured", the launches the wrappers counted while a
# capture recorded them (they ran nothing), and "replayed", each replay's
# captured launches again (they ran, with no call of the wrapper)
GRAPH_LAUNCHES: Dict[str, collections.Counter] = {"captured": collections.Counter(),
                                                  "replayed": collections.Counter()}


def _launch_counts() -> Dict[str, int]:
    return {f"{f.__name__}.{k}": v for f in _COUNTED for k, v in vars(f).items()
            if k.startswith("launches")}


class _Captured:
    """One capture of a train step ``fn(x, y)`` as a CUDA graph on
    ``stream``, in the profiler's spans where ``spans`` is given: the
    graph, the stats it writes and the wrappers' launches it recorded."""

    def __init__(self, fn: Callable, x: torch.Tensor, y: torch.Tensor, stream,
                 spans: Optional[GraphSpans] = None):
        before = _launch_counts()
        self.graph, self.spans = torch.cuda.CUDAGraph(), spans
        with profiler.capturing(spans):
            with torch.cuda.graph(self.graph, stream=stream):
                self.stats = fn(x, y)
        self.launches = {k: v - before.get(k, 0) for k, v in _launch_counts().items()
                         if v != before.get(k, 0)}
        GRAPH_LAUNCHES["captured"].update(self.launches)

    def replay(self) -> Dict[str, torch.Tensor]:
        if self.spans is None:
            self.graph.replay()
        else:
            profiler.replay(self.spans, self.graph.replay)
        GRAPH_LAUNCHES["replayed"].update(self.launches)
        return {k: v.clone() for k, v in self.stats.items()}


class _StepGraph:
    """A train step captured as CUDA graphs (``Trainer._graph_step``): its
    key, its input buffers ``x`` and ``y``, the step's graph, and two
    graphs of the step in the profiler's spans, replayed in turns while a
    ``torch.profiler`` session records (a graph's span events keep one
    replay's times: the turns let the card run one replay while the host
    reads the other's)."""

    def __init__(self, tr: "Trainer", key, feats: torch.Tensor, labels: torch.Tensor,
                 stream):
        self.key = key
        self.x, self.y = torch.empty_like(feats), torch.empty_like(labels)
        self.plain = _Captured(tr._eager_step, self.x, self.y, stream)
        self.traced = [_Captured(tr._train_step_in_spans, self.x, self.y, stream, GraphSpans())
                       for _ in range(2)]
        self.turn = 0

    def replay(self, traced: bool) -> Dict[str, torch.Tensor]:
        if not traced:
            return self.plain.replay()
        self.turn ^= 1
        return self.traced[self.turn].replay()


@dataclass
class TrainerConfig:
    bunchsize: int = 256
    cachesize: int = 12800
    seed: int = 0
    randomize: bool = True
    crossvalidate: bool = False
    objective: str = "xent"          # 'xent' | 'mse'
    sgd: SgdConfig = field(default_factory=SgdConfig)
    # CONFUSIONMODE (ObjFun.cc:132-155), xent only: accumulated on the
    # device as onehot(labels)ᵀ @ {onehot(argmax) | softmax} of the logits
    confusion_mode: str = "no"
    # None (f32) | 'bf16' | 'int8' | 'int8pf' | 'int8pfsr' | 'int8full'
    # (the module doc)
    compute_dtype: Optional[str] = None

    def __post_init__(self):
        if self.objective not in ("xent", "mse"):
            raise ValueError(f"objective must be 'xent' or 'mse', got {self.objective!r}")
        if self.confusion_mode not in CONFUSION_MODES:
            raise ValueError(f"confusion_mode must be one of {CONFUSION_MODES}, "
                             f"got {self.confusion_mode!r}")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                             f"got {self.compute_dtype!r}")


class Trainer:
    def __init__(self, net: Network, cfg: TrainerConfig,
                 transform: Optional[Network] = None,
                 start_frm_ext: int = 0, end_frm_ext: int = 0,
                 device: DeviceLike = None):
        net.check_dims()
        self.net = net
        self.cfg = cfg
        self._body, self._block_dims, self._has_softmax = self._split_head()
        if cfg.objective == "xent" and not self._has_softmax:
            raise ValueError("CE objective expects a softmax output layer")
        self.factors = tuple(layer_lr_factors(net, cfg.sgd))
        check_updatable(net, cfg.sgd.momentum, self.factors)
        self.device = resolve_device(device)
        net.to(self.device)
        self.pipeline = TransformPipeline(transform, start_frm_ext, end_frm_ext,
                                          device=self.device)
        self.params = net.params              # the modules' own tensors
        self.velocity = init_momentum(net, cfg.sgd.momentum, cfg.sgd.velocity_dtype)
        self.stats = XentStats() if cfg.objective == "xent" else MseStats()
        self.total_frames = 0
        self.wall = 0.0
        self._accs: List[Tuple[Dict[str, torch.Tensor], int]] = []
        mode = cfg.compute_dtype
        self._bf16_in = self._bf16_inputs() if mode == "bf16" else None
        # layers whose weight the fused wgrad+momentum kernel updates: none
        # under int8, and under bf16 only those with a bf16 input
        self._fused = [i for i, (spec, f) in enumerate(zip(net.layers, self.factors))
                       if cfg.sgd.momentum != 0.0 and isinstance(spec, BiasedLinearity)
                       and f != 0.0 and mode not in INT8_MODES
                       and (mode != "bf16" or self._bf16_in[i])]
        # (layer index, key) of every other tensor that gets a gradient
        self._trainable = [(i, k) for i, (spec, f) in enumerate(zip(net.layers, self.factors))
                           if spec.updatable and f != 0.0 for k in spec.trainable_keys
                           if not (k == "weight" and i in self._fused)]
        self._lr = cfg.sgd.learning_rate
        # f32 CE steps through the fused softmax-CE on a card replay a CUDA
        # graph of the step (``_graph_step``); the last capture, the key
        # whose eager step ran last on the capture's stream, and that stream
        self._graphable = (self.device.type == "cuda" and mode is None
                           and cfg.objective == "xent" and self._block_dims is None
                           and cfg.confusion_mode == "no")
        self._graph: Optional[_StepGraph] = None
        self._graph_warm = None
        self._graph_stream = None
        # int8pfsr's rounding noise: one stream for the Trainer's lifetime
        self._sr_gen = (torch.Generator(device=self.device).manual_seed(cfg.seed or 1)
                        if mode == "int8pfsr" else None)

    def set_learning_rate(self, lr: float) -> None:
        """Runtime learning rate (newbob halving between epochs)."""
        self._lr = float(lr)

    # ------------------------------------------------------------------
    def _split_head(self):
        """(body layers, BlockSoftmax dims or None, has a softmax head): a
        terminal Softmax or BlockSoftmax is left to the objective."""
        layers = list(self.net.layers)
        if layers and isinstance(layers[-1], Softmax):
            return layers[:-1], None, True
        if layers and isinstance(layers[-1], BlockSoftmax):
            return layers[:-1], layers[-1].dims, True
        return layers, None, False

    def _bf16_inputs(self) -> List[bool]:
        """Under bf16, whether each body layer's input is bf16: the input is
        cast, a BiasedLinearity keeps its input's dtype, and a layer with
        f32 parameters promotes to f32 (jnp's rules)."""
        out, bf16 = [], True
        for spec in self._body:
            out.append(bf16)
            if not isinstance(spec, BiasedLinearity) and _promotes(spec):
                bf16 = False
        return out

    def _forward_logits(self, x: torch.Tensor, updates: Optional[dict] = None,
                        train: bool = False) -> torch.Tensor:
        """f32 logits; ``updates`` maps a layer index to its weight-update
        hook; ``train`` draws int8pfsr's rounding noise."""
        mode = self.cfg.compute_dtype
        if mode is None:
            return forward_body(self._body, x, updates)
        if mode == "bf16":
            return forward_body(self._body, x.to(torch.bfloat16), updates,
                                self._bf16_weights, _promoting_call).float()
        for spec in self._body:
            x = (self._int8_affine(spec, x, train) if isinstance(spec, BiasedLinearity)
                 else spec(x))
        return x

    def _bf16_weights(self, i: int, spec: BiasedLinearity):
        """A BiasedLinearity's (w, b) under bf16: bf16 where its input is
        bf16, else promoted back to f32 (f32 x @ bf16 W, as jnp does)."""
        w, b = spec.weight.to(torch.bfloat16), spec.bias.to(torch.bfloat16)
        return (w, b) if self._bf16_in[i] else (w.float(), b.float())

    def _int8_affine(self, spec: BiasedLinearity, x: torch.Tensor,
                     train: bool) -> torch.Tensor:
        """A BiasedLinearity under an int8 mode (JAX trainer.py:166-176)."""
        mode = self.cfg.compute_dtype
        if mode == "int8full":
            return qmatmul(x, spec.weight) + spec.bias
        noise = (torch.rand(x.shape, generator=self._sr_gen, device=x.device)
                 if mode == "int8pfsr" and train else None)
        dim = -1 if mode in ("int8pf", "int8pfsr") else None
        return fake_quant_ste(x, dim, noise) @ fake_quant_ste(spec.weight, 0) + spec.bias

    def _weight_updates(self, n_frames: int) -> dict:
        """The momentum step's hook for each fused layer (see the module doc)."""
        updates = {}
        for i in self._fused:
            a, decay, _ = layer_coeffs(self.cfg.sgd, n_frames, self.factors[i], self._lr)
            updates[i] = functools.partial(
                fused_weight_step, w=self.params[i]["weight"],
                v=self.velocity[i]["weight"], a=a, m=self.cfg.sgd.momentum, decay=decay)
        return updates

    def _loss(self, logits: torch.Tensor, labels: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, per-bunch device stats), routed as trainer.py:200-216."""
        cfg = self.cfg
        if cfg.objective == "mse":
            y = softmax_identity_backward(logits) if self._has_softmax else logits
            loss, stats = mse_loss_and_stats(y, one_hot(labels, logits.shape[1], y.dtype))
            return loss, {"mse": stats["mse"]}
        if self._block_dims is None and cfg.confusion_mode == "no":
            with profiler.phase("loss.softmax_ce", logits.device, timed_in_trace=True):
                loss, correct = fused_softmax_xent(logits, labels)
            return loss, {"xent": loss.detach(), "correct": correct}
        loss, stats = xent_loss_and_stats(logits, labels, self._block_dims)
        stats = {"xent": stats["xent"], "correct": stats["correct"]}
        if cfg.confusion_mode != "no":
            oh_lab = one_hot(labels, logits.shape[1])
            z = logits.detach()
            hyp = (one_hot(torch.argmax(z, dim=-1), z.shape[1])
                   if cfg.confusion_mode in ("max", "dmax") else torch.softmax(z, dim=-1))
            stats["confusion"] = oh_lab.T @ hyp
            stats["confusion_count"] = oh_lab.sum(0)
        return loss, stats

    def _train_step(self, feats: torch.Tensor, labels: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        if self._graphable and not profiler.enabled:
            return self._graph_step(feats, labels)
        if profiler.recording():
            return self._train_step_in_spans(feats, labels)
        return self._eager_step(feats, labels)

    def _eager_step(self, feats: torch.Tensor, labels: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        n = feats.shape[0]
        loss, stats = self._loss(
            self._forward_logits(feats, self._weight_updates(n), train=True), labels)
        self._update(self._grads(loss), n)
        return stats

    def _graph_step(self, feats: torch.Tensor, labels: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        """``_eager_step`` replayed from a CUDA graph, so that the host's
        enqueue (a few ms a step of Python and launches at eight layers)
        does not pace the card; while a ``torch.profiler`` session records,
        ``_train_step_in_spans`` replayed from its own graphs, whose spans
        the graphs time. The first step of a bunch shape, learning rate and
        set of state tensors (a graph reads and writes the parameters and
        velocities it was captured with: resident newbob gives every epoch
        new velocities) runs eagerly on the capture's side stream (whatever
        capture needs is then set up there), the next one is captured and
        every later one replays it, its bunch copied into the graphs'
        inputs first. The graphs launch the eager step's kernels with the
        same arguments, so the results are the eager step's bit for bit."""
        key = (tuple(feats.shape), tuple(labels.shape), feats.dtype, self._lr,
               self._state_ptrs())
        traced = profiler.recording()
        g = self._graph
        if g is None or g.key != key:
            cur = torch.cuda.current_stream(self.device)
            if g is not None:
                cur.synchronize()            # no replay in flight on the old pools
                self._graph = g = None
            if self._graph_stream is None:
                self._graph_stream = torch.cuda.Stream(self.device)
            s = self._graph_stream
            s.wait_stream(cur)
            if self._graph_warm != key:
                self._graph_warm = key
                with torch.cuda.stream(s):
                    stats = (self._train_step_in_spans if traced else self._eager_step)(
                        feats, labels)
                cur.wait_stream(s)
                return stats
            self._graph = g = _StepGraph(self, key, feats, labels, s)
        g.x.copy_(feats)
        g.y.copy_(labels)
        return g.replay(traced)

    def _state_ptrs(self) -> Tuple[int, ...]:
        """The addresses of every parameter and velocity tensor."""
        return tuple(u.data_ptr() for group in (self.params, self.velocity) for p in group
                     for t in p.values() for u in (t if isinstance(t, list) else (t,)))

    def _train_step_in_spans(self, feats: torch.Tensor, labels: torch.Tensor
                             ) -> Dict[str, torch.Tensor]:
        """``_train_step`` inside the profiler's spans: the step, then its
        forward, loss, backward and update (the update timed on the card
        under a ``torch.profiler`` session too)."""
        dev, n = self.device, feats.shape[0]
        with profiler.phase("step", dev):
            profiler.count("step.frames", n)
            updates = self._weight_updates(n)
            with profiler.phase("step.forward", dev):
                logits = self._forward_logits(feats, updates, train=True)
            with profiler.phase("step.loss", dev):
                loss, stats = self._loss(logits, labels)
            with profiler.phase("step.backward", dev):
                gs = self._grads(loss)
            with profiler.phase("step.update", dev, timed_in_trace=True):
                self._update(gs, n)
        return stats

    def _grads(self, loss: torch.Tensor) -> List[torch.Tensor]:
        """The loss's gradients of the trainable parameters, in order."""
        ts = [self.params[i][k] for i, k in self._trainable]
        return torch.autograd.grad(loss, ts) if ts else []

    def _update(self, gs: List[torch.Tensor], n_frames: int) -> None:
        grads = [{} for _ in self.params]
        for (i, k), g in zip(self._trainable, gs):
            grads[i][k] = g
        apply_updates(self.net, self.params, self.velocity, grads, self.cfg.sgd,
                      n_frames, self.factors, learning_rate=self._lr)

    @torch.no_grad()
    def _eval_step(self, feats: torch.Tensor, labels: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        return self._loss(self._forward_logits(feats), labels)[1]

    def _drain(self, step, feats_all: torch.Tensor, labels_all: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        acc: Dict[str, torch.Tensor] = {}
        for feats, labels in zip(feats_all, labels_all):
            for k, v in step(feats, labels).items():
                # f32/int32 sums in bunch order, as the JAX drain's
                acc[k] = v.clone() if k not in acc else acc[k].add_(v)
        return acc

    def drain_train(self, feats_all: torch.Tensor, labels_all: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        """Train on every bunch of a stack ((nb, bunch, D) feats, (nb,
        bunch) labels, on the Trainer's device) in order; the per-stack
        device stats (JAX ``Trainer._drain_train``)."""
        with profiler.phase("train-step", self.device):
            return self._drain(self._train_step, feats_all, labels_all)

    def drain_eval(self, feats_all: torch.Tensor, labels_all: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        """Evaluate every bunch of a stack with the current parameters; the
        per-stack device stats (JAX ``Trainer._drain_eval``)."""
        with profiler.phase("eval-step", self.device):
            return self._drain(self._eval_step, feats_all, labels_all)

    def merge_acc(self, stats, acc: Dict[str, torch.Tensor], frames: int) -> None:
        """Add one stack's device stats over ``frames`` frames into the
        float64 host totals ``stats`` (JAX ``Trainer._merge_acc``)."""
        if self.cfg.objective == "mse":
            stats.add(float(acc["mse"]), frames)
            return
        stats.add(float(acc["xent"]), frames, int(acc["correct"]))
        if self.cfg.confusion_mode != "no":
            stats.confusion_mode = self.cfg.confusion_mode
            stats._ensure_confusion(self.net.n_outputs)
            conf = acc["confusion"].cpu().double().numpy()
            stats.confusion += conf
            stats.diag_confusion += np.diag(conf)
            stats.confusion_count += acc["confusion_count"].cpu().double().numpy()

    def _flush_acc(self) -> None:
        for acc, frames in self._accs:
            self.merge_acc(self.stats, acc, frames)
        self._accs = []

    def stacks(self, utterances: Iterable[Tuple[np.ndarray, np.ndarray]],
               randomize: bool, batch_utts: int = 32
               ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """The intake of an epoch (TNetCu.cc:376-442): yields each cache's
        stacked bunches, ((nb, bunch, D) feats, (nb, bunch) int32 labels) on
        the device, as soon as the cache fills (then the last, partial
        cache). ``utterances`` yields (ext_feats (T+ext, D_in) float32,
        labels (T,) int32); ``batch_utts`` utterances go through the
        transform together; ``total_frames`` counts the frames read. The
        streaming epoch drains each stack as it comes; resident newbob
        keeps them (``train/resident.py``)."""
        cache = DeviceFrameCache(self.cfg.cachesize, self.cfg.bunchsize,
                                 self.cfg.seed, randomize)
        pend_feats, pend_labels = [], []

        def flush_pending():
            if not pend_feats:
                return
            with profiler.phase("transform", self.device):
                rows, valid = self.pipeline.transform_block(pend_feats)
            labels_block = np.concatenate(pend_labels)
            if labels_block.shape[0] != valid:
                raise ValueError(f"{labels_block.shape[0]} labels for {valid} frames")
            self.total_frames += valid
            with profiler.phase("intake.fill", self.device):
                cache.add_block(rows, valid, labels_block)
            pend_feats.clear()
            pend_labels.clear()

        def take():
            with profiler.phase("cache-randomize", self.device):
                stacked = cache.take_stacked()
            if stacked is not None:
                yield stacked

        def take_full():
            while cache.full:
                yield from take()

        utterances = iter(utterances)
        while True:
            # the wait for the next utterance (the readers run ahead of it)
            with profiler.phase("intake.wait"):
                item = next(utterances, None)
            if item is None:
                break
            ext_feats, labels = item
            pend_feats.append(np.asarray(ext_feats, dtype=np.float32))
            pend_labels.append(np.asarray(labels, dtype=np.int32))
            if len(pend_feats) >= batch_utts:
                flush_pending()
                yield from take_full()
        flush_pending()
        yield from take_full()
        if cache.rows > 0:          # the last (partial) cache
            yield from take()

    def run_epoch(self, utterances: Iterable[Tuple[np.ndarray, np.ndarray]],
                  batch_utts: int = 32) -> None:
        """Train/evaluate one epoch over ``utterances`` (see ``stacks``)."""
        t0 = time.time()
        drain = self.drain_eval if self.cfg.crossvalidate else self.drain_train
        for feats_all, labels_all in self.stacks(utterances, self.cfg.randomize, batch_utts):
            self._accs.append((drain(feats_all, labels_all),
                               feats_all.shape[0] * feats_all.shape[1]))
        self._flush_acc()
        self.wall += time.time() - t0

    # ------------------------------------------------------------------
    # checkpoint/resume (JAX trainer.py:400-434): the same npz keys, so
    # either package loads the other's file
    def save_state(self, path: str) -> None:
        """Parameters ``p{i}.{k}`` (a list of equal-shape tensors stacked,
        as ``np.asarray`` stacks it in JAX), velocities ``v{i}.{k}`` (as f32:
        npz has no bf16), ``_rng_x`` and the epoch's ``_stats``
        ([error, frames, corr], corr 0 for MSE)."""
        arrs = {}
        for i, p in enumerate(self.params):
            for k, t in p.items():
                if isinstance(t, list):
                    if not (all(isinstance(e, torch.Tensor) for e in t)
                            and len({e.shape for e in t}) == 1):
                        # np.asarray fails on these in JAX, or pickles
                        # sub-networks that its load_state cannot read
                        raise ValueError(f"layer {i} ({self.net.layers[i].tag}): its "
                                         f"{k!r} is not a stack of equal-shape arrays")
                    t = torch.stack(t)
                arrs[f"p{i}.{k}"] = t.detach().to("cpu", torch.float32).numpy()
        for i, v in enumerate(self.velocity):
            for k, t in v.items():
                arrs[f"v{i}.{k}"] = t.detach().to("cpu", torch.float32).numpy()
        # the JAX trainer writes this slot as 0 and neither package reads it:
        # each epoch's cache shuffle restarts from --SEED
        arrs["_rng_x"] = np.zeros(1, np.uint64)
        arrs["_stats"] = np.asarray([self.stats.error, self.stats.frames,
                                     getattr(self.stats, "corr", 0)], dtype=np.float64)
        np.savez(path, **arrs)

    @torch.no_grad()
    def load_state(self, path: str) -> None:
        """Copy a ``save_state`` file into the live tensors (velocities
        recast to their dtype) and restore the stats; absent keys stay."""
        with np.load(path) as data:
            for prefix, groups in (("p", self.params), ("v", self.velocity)):
                for i, group in enumerate(groups):
                    for k, t in group.items():
                        key = f"{prefix}{i}.{k}"
                        if key not in data:
                            continue
                        src = data[key]
                        # a list of tensors was saved stacked
                        dsts, srcs = (t, src) if isinstance(t, list) else ([t], [src])
                        shape = (len(t), *t[0].shape) if isinstance(t, list) else t.shape
                        if tuple(src.shape) != tuple(shape):
                            raise ValueError(f"{path}: {key} has shape {src.shape}, "
                                             f"the network's is {tuple(shape)}")
                        for dst, s in zip(dsts, srcs):
                            dst.copy_(torch.from_numpy(np.asarray(s, np.float32)))
            st = data["_stats"]
        self.stats.error = float(st[0])
        self.stats.frames = int(st[1])
        if isinstance(self.stats, XentStats):
            self.stats.corr = int(st[2])

    def updated_network(self) -> Network:
        """A host (CPU) copy of the trained network."""
        return copy.deepcopy(self.net).to("cpu")

    def report(self) -> str:
        return self.stats.report()

    def throughput_report(self) -> str:
        fps = self.total_frames / max(self.wall, 1e-9)
        rt = fps / 100.0
        return (f"Done {self.total_frames} frames in {self.wall:.2f}s"
                f" [FPS:{fps:.1f},RT:{rt:.4f}]\n")

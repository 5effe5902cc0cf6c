"""The system under test: one ``nnet_asr_torch`` Trainer for the cell,
driven through its own training entry points. The only module of the
benchmark that imports the port.

- ``resident``: ``Trainer.drain_train`` on each device-held stack in
  order, epoch after epoch; each epoch's per-stack stats merged into host
  totals at its end (``ResidentNewbob._drain_all``).
- ``stream``: each epoch reads the corpus (``read_utterances``: the HTK
  reader on a pool of prefetch threads), and ``Trainer.stacks`` transforms
  it and fills the shuffled device cache; each stack it yields is drained
  by ``drain_train`` and the stats merged at the epoch's end
  (``Trainer.run_epoch``'s loop, with a phase around each ``next()`` of
  the stack generator).

The first ``check.STEPS`` steps are driven in set-up through
``drain_train`` on the first bunches of the first stack, one bunch a
call; the same Trainer then serves the window.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, List, Optional

import torch

from . import traffic
from .reference.mlp_frame_ce import Leaf

WARM_BUNCHES = 8          # the first steps plus these: every shape before the window


class Program:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device,
                 corpus: Optional[dict] = None):
        from nnet_asr_torch.models.components import BiasedLinearity, Sigmoid, Softmax
        from nnet_asr_torch.models.network import Network
        from nnet_asr_torch.train.sgd import SgdConfig
        from nnet_asr_torch.train.trainer import Trainer, TrainerConfig

        if cfg["compute"] != "f32" or cfg["objective"] != "xent":
            raise ValueError(f"compute {cfg['compute']!r} / objective {cfg['objective']!r}: "
                             f"the harness drives f32 frame CE")
        self.cfg, self.mix, self.device = cfg, mix, device
        dims = cfg["dims"]
        layers = []
        with torch.device(device):
            for i, (n_in, n_out) in enumerate(zip(dims[:-1], dims[1:])):
                layers.append(BiasedLinearity(n_in, n_out))
                layers.append(Sigmoid(n_out, n_out) if i < len(dims) - 2
                              else Softmax(n_out, n_out))
            net = Network(layers)
        with torch.no_grad():
            for spec, (w, b) in zip(net.layers[::2], traffic.weights(cfg, seed, device)):
                spec.weight.copy_(w)
                spec.bias.copy_(b)
        sgd = SgdConfig(learning_rate=cfg["learning_rate"], momentum=cfg["momentum"],
                        grad_div_frm=cfg["grad_div_frm"],
                        velocity_dtype=None if cfg["velocity_dtype"] == "f32"
                        else cfg["velocity_dtype"])
        cache = mix.get("cache_frames", mix.get("stack_bunches", 1) * cfg["bunch"])
        tcfg = TrainerConfig(bunchsize=cfg["bunch"], cachesize=cache,
                             seed=traffic.cache_seed(seed), randomize=True, sgd=sgd)
        self.kind = mix["kind"]
        if self.kind == "resident":
            self.trainer = Trainer(net, tcfg, device=device)
            self.stacks = traffic.resident_stacks(cfg, mix, seed, device)
        elif self.kind == "stream":
            from nnet_asr_torch.io.htk import FeatureReader
            from nnet_asr_torch.io.labels import LabelRepository
            from nnet_asr_torch.io.scp import read_scp

            ext = cfg["front_end"]["frame_ext"]
            p = corpus["paths"]
            self.trainer = Trainer(net, tcfg, Network.read(p["transform"]), ext, ext,
                                   device=device)
            self.reader = FeatureReader(start_frm_ext=ext, end_frm_ext=ext)
            self.entries = read_scp(p["train.scp"])
            self.labels_repo = LabelRepository(p["labs.mlf"], p["map"], "*/", "lab")
        else:
            raise ValueError(f"traffic kind {self.kind!r}")

    # -- the model's state, as the checks read it --------------------------
    def leaves(self) -> List[Leaf]:
        tr, out = self.trainer, []
        for n, i in enumerate(range(0, len(tr.net.layers), 2), 1):
            v = tr.velocity[i]
            out += [(f"W{n}", tr.params[i]["weight"], v.get("weight")),
                    (f"b{n}", tr.params[i]["bias"], v.get("bias"))]
        return out

    # -- set-up ------------------------------------------------------------
    def _epoch_stacks(self):
        """(stack generator, utterance generator) of one streamed epoch."""
        from nnet_asr_torch.train.trainer import read_utterances

        ext = self.cfg["front_end"]["frame_ext"]
        utts = read_utterances(self.reader, self.entries, self.labels_repo, ext, ext,
                               workers=self.mix["reader_threads"])
        return self.trainer.stacks(utts, True, self.mix["batch_utterances"]), utts

    def first_stack(self):
        if self.kind == "resident":
            return self.stacks[0]
        gen, utts = self._epoch_stacks()
        try:
            return next(gen)
        finally:
            gen.close()
            utts.close()

    def first_steps(self, after_step: Callable[[int, Optional[float], List[Leaf]], None],
                    steps: int) -> None:
        """The first ``steps`` training steps, a bunch a ``drain_train``
        call, then warm steps up to ``WARM_BUNCHES`` bunches."""
        feats, labels = self.first_stack()
        after_step(0, None, self.leaves())
        for k in range(steps):
            acc = self.trainer.drain_train(feats[k:k + 1], labels[k:k + 1])
            after_step(k + 1, float(acc["xent"]), self.leaves())
        self.trainer.drain_train(feats[steps:WARM_BUNCHES], labels[steps:WARM_BUNCHES])
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window --------------------------------------------------------
    def window(self, seconds: float, phase=None) -> dict:
        """Train for ``seconds`` (checked after each stack), then wait for
        the card: {frames, bunches, failed, wall_s, intake_s}."""
        from nnet_asr_torch.ops.objectives import XentStats

        phase = phase or (lambda name: contextlib.nullcontext())
        out = {"frames": 0, "bunches": 0, "failed": 0, "intake_s": 0.0}
        stats = XentStats()

        def merge(accs):
            with phase("merge"):
                for acc, nb, frames in accs:
                    if not math.isfinite(float(acc["xent"])):
                        out["failed"] += nb
                    self.trainer.merge_acc(stats, acc, frames)

        self.sync()
        t0 = time.perf_counter()
        done = False
        while not done:
            accs = []
            if self.kind == "resident":
                for feats, labels in self.stacks:
                    with phase("drain"):
                        accs.append((self.trainer.drain_train(feats, labels),
                                     labels.shape[0], labels.numel()))
                    if time.perf_counter() - t0 >= seconds:
                        done = True
                        break
            else:
                gen, utts = self._epoch_stacks()
                try:
                    while True:
                        ti = time.perf_counter()
                        with phase("intake"):
                            st = next(gen, None)
                        out["intake_s"] += time.perf_counter() - ti
                        if st is None:
                            break
                        with phase("drain"):
                            accs.append((self.trainer.drain_train(*st), st[1].shape[0],
                                         st[1].numel()))
                        if time.perf_counter() - t0 >= seconds:
                            done = True
                            break
                finally:
                    gen.close()
                    utts.close()
            for _, nb, frames in accs:
                out["bunches"] += nb
                out["frames"] += frames
            if not done:
                merge(accs)
        with phase("sync"):
            self.sync()
        out["wall_s"] = time.perf_counter() - t0
        merge(accs)
        if self.kind == "resident":
            out.pop("intake_s")
        return out

    def close(self) -> None:
        """Free the Trainer and its data."""
        self.trainer = self.stacks = None

"""Device-resident newbob training (port of the single-device part of
nnet_asr_tpu/train/resident.py).

The streaming scheduler runs one ``tnet`` per epoch, and each re-reads,
re-transforms and re-shuffles the whole corpus. Because tnet fixes the
shuffle seed per epoch (``--SEED`` is the same on every scheduler
iteration), every epoch trains on the same bunch sequence. Resident mode
therefore does the intake once and keeps each cache's stacked bunches in
device memory; every epoch is then only the drains:

    read + transform + shuffle ONCE  ->  (nb, bunch, D) stacks on the card
    per epoch: copy the newbob-selected MMF into the Trainer's tensors,
    reset the momentum (the reference's optimizer state lives and dies
    with one epoch's process), drain every stack at the epoch's learning
    rate, write the epoch MMF.

The trajectory is byte-identical to the streaming one: the intake is the
Trainer's own (``Trainer.stacks``, the same seed, utterance order and
cache boundaries), the drains are the same code, and the MMF writer
round-trips float32 exactly.

``hbm_budget_bytes`` caps the bytes of the stacks kept in device memory.
A stack that would pass it is moved to the host (pinned memory when the
Trainer is on a CUDA device) and copied back to the device before each of
its drains, once an epoch: no re-read, re-transform or re-shuffle, and
nothing is computed on the host.

The JAX package's device mesh, multi-host intake and partial drains
(``take_stacked(max_bunches)``) come with the multi-device port.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch

from ..device import DeviceLike
from ..models.network import Network
from ..ops.objectives import MseStats, XentStats
from ..tools import not_ported
from .sgd import init_momentum
from .trainer import Trainer, TrainerConfig, read_utterances


class _Stack:
    """One cache's stacked bunches: device-resident or host-parked."""

    __slots__ = ("feats", "labels", "on_device")

    def __init__(self, feats: torch.Tensor, labels: torch.Tensor, on_device: bool):
        self.feats = feats
        self.labels = labels
        self.on_device = on_device

    @property
    def nbytes(self) -> int:
        return (self.feats.numel() * self.feats.element_size()
                + self.labels.numel() * self.labels.element_size())


class ResidentNewbob:
    """Newbob ``train_epoch``/``crossvalidate`` over device-resident bunch
    stacks, for ``run_newbob``.

    ``reader`` is a ``FeatureReader`` with ``frm_ext`` frames of extension
    on each side; ``labels_repo`` a ``LabelRepository``; ``device`` the
    Trainer's (None: ``cuda:0``, raising without CUDA).
    ``hbm_budget_bytes``: optional cap on the device bytes of the stacks;
    the stacks beyond it park on the host (see the module doc).
    """

    def __init__(self, nn_init: str, transform: Optional[Network],
                 reader, labels_repo, cfg: TrainerConfig,
                 frm_ext: int = 0, mesh=None,
                 hbm_budget_bytes: Optional[int] = None,
                 device: DeviceLike = None):
        if mesh is not None:
            raise not_ported("ResidentNewbob(mesh=...)", "queue 1 item 14")
        self.reader = reader
        self.labels_repo = labels_repo
        self.cfg = cfg
        self.frm_ext = frm_ext
        self.hbm_budget = hbm_budget_bytes
        self.resident_bytes = 0
        self.parked_bytes = 0
        self.trainer = Trainer(Network.read(nn_init), cfg, transform, frm_ext, frm_ext,
                               device=device)
        self.device = self.trainer.device
        self._train_stacks: List[_Stack] = []
        self._cv_stacks: List[_Stack] = []
        self.train_frames = 0
        self.cv_frames = 0

    # -- placement --------------------------------------------------------
    def _admit(self, feats: torch.Tensor, labels: torch.Tensor) -> _Stack:
        """Keep a stack on the device if the budget allows, else park it on
        the host."""
        st = _Stack(feats, labels, on_device=True)
        if self.hbm_budget is None or self.resident_bytes + st.nbytes <= self.hbm_budget:
            self.resident_bytes += st.nbytes
            return st
        pin = self.device.type == "cuda"
        st = _Stack(*(t.cpu().pin_memory() if pin else t.cpu() for t in (feats, labels)),
                    on_device=False)
        self.parked_bytes += st.nbytes
        return st

    def _place(self, st: _Stack) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stack on the device: a host-parked one is copied there."""
        if st.on_device:
            return st.feats, st.labels
        return (st.feats.to(self.device, non_blocking=True),
                st.labels.to(self.device, non_blocking=True))

    # -- one-time intake ------------------------------------------------
    def _collect(self, entries, randomize: bool, labels_repo) -> Tuple[List[_Stack], int]:
        """Read, transform and shuffle once: the stacks a streaming epoch
        over ``entries`` would drain, and the frames read."""
        tr = self.trainer
        before = tr.total_frames
        utts = read_utterances(self.reader, entries, labels_repo, self.frm_ext, self.frm_ext)
        stacks = [self._admit(*stacked) for stacked in tr.stacks(utts, randomize)]
        return stacks, tr.total_frames - before

    def prepare(self, train_entries, cv_entries, cv_labels_repo=None) -> None:
        """The one-time intake of the training and cross-validation parts."""
        self._train_stacks, self.train_frames = self._collect(
            train_entries, self.cfg.randomize, self.labels_repo)
        self._cv_stacks, self.cv_frames = self._collect(
            cv_entries, False, cv_labels_repo or self.labels_repo)
        if self.parked_bytes:
            # the JAX tool's line ("HBM": the card's memory)
            print(f"[resident] HBM budget {self.hbm_budget}: "
                  f"{self.resident_bytes} bytes resident, "
                  f"{self.parked_bytes} bytes host-parked "
                  f"(streamed H2D per epoch)", flush=True)

    # -- per-epoch closures ----------------------------------------------
    def _load(self, mmf: str) -> None:
        """Copy the model in ``mmf`` into the Trainer's tensors, in place
        (the fused update hooks hold those tensors)."""
        self.trainer.net.from_numpy_params(Network.read(mmf).to_numpy_params())

    def _done(self, frames: int, t0: float) -> None:
        secs = time.time() - t0
        fps = frames / max(secs, 1e-9)
        print(f"Done {frames} frames in {secs:.2f}s"
              f" [FPS:{fps:.1f},RT:{fps / 100.0:.4f}] (resident)")

    def _drain_all(self, drain, stacks: List[_Stack]):
        """Drain every stack in order, then merge their device stats into
        host totals (no wait for the device between stacks); print and
        return the stats."""
        accs = []
        for st in stacks:
            feats_all, labels_all = self._place(st)
            accs.append((drain(feats_all, labels_all), feats_all.shape[0] * feats_all.shape[1]))
        stats = XentStats() if self.cfg.objective == "xent" else MseStats()
        for acc, frames in accs:
            self.trainer.merge_acc(stats, acc, frames)
        print(stats.report(), end="")
        return stats

    def train_epoch(self, src: str, lrate: float, dst: str) -> float:
        t0 = time.time()
        tr = self.trainer
        self._load(src)
        # fresh momentum per epoch: the reference's optimizer state lives
        # and dies within an epoch's process (SURVEY.md §5)
        tr.velocity = init_momentum(tr.net, self.cfg.sgd.momentum,
                                    self.cfg.sgd.velocity_dtype)
        if tr._sr_gen is not None:
            # int8pfsr: a streaming epoch is a fresh tnet Trainer, so its
            # rounding-noise stream restarts every epoch
            tr._sr_gen.manual_seed(self.cfg.seed or 1)
        tr.set_learning_rate(lrate)
        stats = self._drain_all(tr.drain_train, self._train_stacks)
        tr.updated_network().write(dst)
        self._done(self.train_frames, t0)
        return stats.accuracy

    def crossvalidate(self, mmf: str) -> float:
        t0 = time.time()
        self._load(mmf)
        stats = self._drain_all(self.trainer.drain_eval, self._cv_stacks)
        self._done(self.cv_frames, t0)
        return stats.accuracy

"""Multi-device trainer: the Trainer's epoch over the sharded step (port of
nnet_asr_tpu/parallel/sharded_trainer.py).

``ShardedTrainer`` has the ``Trainer`` interface (``run_epoch``,
``set_learning_rate``, ``save_state``/``load_state``, ``updated_network``,
``report``, ``throughput_report``) on one rank of a mesh, with the two
intake modes of the JAX package:

* ``--MESH`` alone (JAX's single-process mesh): every global bunch is the
  single-device Trainer's. Each rank reads the whole SCP through the same
  ``Trainer.stacks`` intake with the same Rand48 shuffle and keeps its
  ``data`` block of rows of each stack; the host work is repeated on every
  rank.
* ``distributed=True`` (``--DISTRIBUTED``, JAX's multi-host mode): the
  ranks of data index ``d`` read ``entries[d::D]`` (the caller's part)
  into a local cache of ``bunch/D`` rows. Each fill round the ranks agree
  on the least bunch count any can drain (an ``all_reduce(MIN)`` over the
  world, JAX's ``process_allgather`` + min), drain it with
  ``take_stacked(max_bunches=agreed)`` and carry the surplus; when the
  first rank runs dry the epoch ends and each rank prints the frames it
  drops (the multi-host form of the Cache's sub-bunch tail discard,
  Cache.cc:239-244).

States are saved UNPADDED in the Trainer's npz format, so single-device and
mesh states load each other (JAX ``:266-323``). ``updated_network`` and
``save_state`` gather the output layer over ``model``: every rank calls
them; the caller lets rank 0 write.
"""

from __future__ import annotations

import copy
import sys
import time
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models.network import Network
from ..train.cache import DeviceFrameCache
from ..train.sgd import init_momentum
from ..train.trainer import TrainerConfig
from ..utils.profiler import profiler
from .mesh import Mesh
from .sharded_step import ShardedStep


def fill_cache(cache: DeviceFrameCache, it: Iterator[Tuple[np.ndarray, np.ndarray]],
               pipeline, batch_utts: int = 32) -> int:
    """Read (ext_feats, labels) utterances from ``it`` into ``cache`` until
    it is full or ``it`` ends, ``batch_utts`` at a time through the
    transform ``pipeline`` (JAX ``ShardedTrainer.run_epoch``'s ``fill``);
    the frames added."""
    pend_f: List[np.ndarray] = []
    pend_l: List[np.ndarray] = []
    frames = 0

    def flush():
        nonlocal frames
        if pend_f:
            with profiler.phase("transform"):
                rows, valid = pipeline.transform_block(pend_f)
            frames += valid
            cache.add_block(rows, valid, np.concatenate(pend_l))
            pend_f.clear()
            pend_l.clear()

    while not cache.full:
        try:
            feats, labels = next(it)
        except StopIteration:
            break
        pend_f.append(np.asarray(feats, np.float32))
        pend_l.append(np.asarray(labels, np.int32))
        if len(pend_f) >= batch_utts:
            flush()
    flush()
    return frames


class ShardedTrainer(ShardedStep):
    """The epoch loop with ``train.Trainer``'s interface on one rank of a
    mesh; ``distributed``: the per-rank SCP-shard intake (module doc)."""

    def __init__(self, net: Network, cfg: TrainerConfig, mesh: Mesh,
                 transform: Optional[Network] = None,
                 start_frm_ext: int = 0, end_frm_ext: int = 0,
                 distributed: bool = False):
        super().__init__(net, cfg, mesh, transform, start_frm_ext, end_frm_ext)
        d = mesh.shape["data"]
        if cfg.bunchsize % d:
            raise ValueError(f"bunchsize {cfg.bunchsize} not divisible by data axis {d}")
        self.distributed = distributed
        self.local_bunch = cfg.bunchsize // d
        self.local_cache = cfg.cachesize // d if distributed else cfg.cachesize
        if distributed and (cfg.cachesize % d or self.local_cache % self.local_bunch):
            raise ValueError(f"cachesize {cfg.cachesize} not divisible by bunchsize "
                             f"under the per-rank split")

    # -- intake ---------------------------------------------------------
    def local_stacks(self, utterances: Iterable[Tuple[np.ndarray, np.ndarray]],
                     randomize: bool, batch_utts: int = 32
                     ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """This rank's (nb, bunch/D, D) feats and (nb, bunch/D) labels of
        each stack of the epoch, in either intake mode."""
        if self.distributed:
            yield from self._negotiated_stacks(utterances, randomize, batch_utts)
            return
        rows = self.mesh.rows(self.cfg.bunchsize)
        for feats_all, labels_all in self.stacks(utterances, randomize, batch_utts):
            yield feats_all[:, rows].contiguous(), labels_all[:, rows].contiguous()

    def _negotiated_stacks(self, utterances, randomize: bool, batch_utts: int):
        cache = DeviceFrameCache(self.local_cache, self.local_bunch, self.cfg.seed, randomize)
        it = iter(utterances)
        while True:
            self.total_frames += fill_cache(cache, it, self.pipeline, batch_utts)
            offer = torch.tensor(min(cache.rows, cache.cachesize) // self.local_bunch,
                                 dtype=torch.int64, device=self.device)
            agreed = int(self.mesh.all_reduce(offer, "world", "min"))
            if agreed == 0:
                break
            with profiler.phase("cache-randomize"):
                stacked = cache.take_stacked(max_bunches=agreed)
            yield stacked
        if cache.rows > 0:
            print(f"[sharded] rank {self.mesh.rank}: dropping {cache.rows} unmatched "
                  f"frames at epoch end (unbalanced SCP shards)", file=sys.stderr, flush=True)

    def run_epoch(self, utterances: Iterable[Tuple[np.ndarray, np.ndarray]],
                  batch_utts: int = 32) -> None:
        t0 = time.time()
        drain = self.drain_eval if self.cfg.crossvalidate else self.drain_train
        d = self.mesh.shape["data"]
        for feats_all, labels_all in self.local_stacks(utterances, self.cfg.randomize,
                                                       batch_utts):
            self._accs.append((drain(feats_all, labels_all), labels_all.numel() * d))
        self._flush_acc()
        self.wall += time.time() - t0

    # -- parameters -----------------------------------------------------
    @torch.no_grad()
    def reload_params(self, host_params: List[dict]) -> None:
        """Copy a whole network's host params (true senone count) into this
        rank's tensors, the output layer padded and striped; the velocity
        resets to zero (the resident newbob's per-epoch reload)."""
        for i, (layer, p) in enumerate(zip(self.net.layers, host_params)):
            layer.load_params({k: self._stripe(v) for k, v in p.items()}
                              if i == self.out_idx else p)
        self.velocity = init_momentum(self.net, self.cfg.sgd.momentum,
                                      self.cfg.sgd.velocity_dtype)

    def updated_network(self) -> Network:
        """A host (CPU) copy of the whole trained network (collective)."""
        params = self.host_params()
        return copy.deepcopy(self._full).to("cpu").from_numpy_params(params)

    # -- checkpoint/resume ------------------------------------------------
    def save_state(self, path: str) -> None:
        """The Trainer's npz, unpadded (collective; rank 0 writes, every
        rank waits at a barrier)."""
        arrs = {}
        for i, p in enumerate(self.host_params()):
            for k, v in p.items():
                if isinstance(v, np.ndarray):
                    arrs[f"p{i}.{k}"] = v
        for i, v in enumerate(self.velocity):
            for k, t in v.items():
                arrs[f"v{i}.{k}"] = (self._gather_out(t) if i == self.out_idx
                                     else t.detach().to("cpu", torch.float32).numpy())
        arrs["_rng_x"] = np.zeros(1, np.uint64)
        arrs["_stats"] = np.asarray([self.stats.error, self.stats.frames,
                                     getattr(self.stats, "corr", 0)], dtype=np.float64)
        if self.mesh.is_main:
            np.savez(path, **arrs)
        self.mesh.barrier()

    @torch.no_grad()
    def load_state(self, path: str) -> None:
        """Load a ``save_state`` file of either trainer: the output layer's
        arrays are padded and striped; the velocity is recast."""
        with np.load(path) as data:
            for prefix, groups in (("p", self.params), ("v", self.velocity)):
                for i, group in enumerate(groups):
                    for k, t in group.items():
                        key = f"{prefix}{i}.{k}"
                        if key not in data or isinstance(t, list):
                            continue
                        src = np.asarray(data[key], np.float32)
                        if i == self.out_idx:
                            src = self._stripe(src)
                        if tuple(src.shape) != tuple(t.shape):
                            raise ValueError(f"{path}: {key} has shape {src.shape}, "
                                             f"the network's is {tuple(t.shape)}")
                        t.copy_(torch.from_numpy(src))
            st = data["_stats"]
        self.stats.error = float(st[0])
        self.stats.frames = int(st[1])
        if hasattr(self.stats, "corr"):
            self.stats.corr = int(st[2])

    def throughput_report(self) -> str:
        fps = self.total_frames / max(self.wall, 1e-9)
        return (f"Done {self.total_frames} frames in {self.wall:.2f}s"
                f" [FPS:{fps:.1f},RT:{fps / 100.0:.4f}]"
                f" mesh=data:{self.mesh.shape['data']}"
                f"xmodel:{self.mesh.shape['model']}\n")

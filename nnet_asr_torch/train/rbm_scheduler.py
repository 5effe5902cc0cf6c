"""RBM stacked-pretraining scheduler (tools/train/rbm_training_scheduler.sh).

Decision contract (lines 20-65 of the shell script): fixed iteration count;
Gaussian units detected in the model → lower learning rate + more
iterations; momentum switches 0.5 → 0.9 after iteration 5; periodic
savepoints every ITERS/SAVEPOINTS iterations.

The port's copy of ``nnet_asr_tpu/train/rbm_scheduler.py``, behaviour unchanged.
"""

from __future__ import annotations

import shutil
from dataclasses import dataclass
from typing import Callable


@dataclass
class RbmSchedulerConfig:
    learnrate: float = 0.1
    learnrate_low: float = 0.001     # for gaussian units
    momentum: float = 0.5
    momentum_high: float = 0.9
    momentum_switch_iter: int = 5
    weightcost: float = 0.0002
    iters: int = 10
    iters_high: int = 20             # for gaussian units
    savepoints: int = 5


def run_rbm_schedule(cfg: RbmSchedulerConfig, rbm_mmf: str,
                     train_iter: Callable[[str, float, float, float], None],
                     has_gaussian_units: bool,
                     log: Callable[[str], None] = print) -> None:
    """``train_iter(mmf, lrate, momentum, weightcost)`` runs one epoch
    updating ``mmf`` in place (the shell script's --TARGETMMF=$RBM)."""
    lrate = cfg.learnrate_low if has_gaussian_units else cfg.learnrate
    iters = cfg.iters_high if has_gaussian_units else cfg.iters
    momentum = cfg.momentum
    div = max(iters // cfg.savepoints, 1)
    for it in range(1, iters + 1):
        log(f"# ITER {it}/{iters} lrate={lrate:g} momentum={momentum:g}")
        train_iter(rbm_mmf, lrate, momentum, cfg.weightcost)
        if it == cfg.momentum_switch_iter:
            momentum = cfg.momentum_high
        if it % div == 0:
            shutil.copy(rbm_mmf, f"{rbm_mmf}_iter{it}")
            log(f"saving {rbm_mmf}_iter{it}...")

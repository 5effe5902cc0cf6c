"""Newbob learning-rate scheduler (native re-implementation of
tools/train/training_scheduler.sh).

Decision logic is copied exactly from the shell contract
(training_scheduler.sh:91-199): initial CV; per-iteration train+CV;
KEEP_LRATE_ITER forced-accepts; reject (revert weights) when CV accuracy
drops; start halving when improvement < START_HALVING_INC; stop when,
during halving, improvement < END_HALVING_INC and iter > MIN_ITER. Epoch
model files carry ``_lr.._tr.._cv..`` suffixes and rejected epochs get
``_rejected`` — the same on-disk protocol the reference leaves behind.

(The reference's shell driver also works unchanged against our ``tnet``
CLI, which prints the same ``Xent:...correct[x%]`` line it greps.)

The port's copy of ``nnet_asr_tpu/train/newbob.py``, behaviour unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, List, Tuple


@dataclass
class NewbobConfig:
    learning_rate: float = 0.06
    max_iter: int = 20
    min_iter: int = 1
    keep_lrate_iter: int = 0
    start_halving_inc: float = 0.5
    end_halving_inc: float = 0.1
    halving_factor: float = 0.5


@dataclass
class NewbobState:
    lrate: float
    accu_best: float
    nnet_best: str
    do_halving: bool = False
    iter: int = 0
    history: List[dict] = field(default_factory=list)


def run_newbob(
    cfg: NewbobConfig,
    init_mmf: str,
    weights_dir: str,
    train_epoch: Callable[[str, float, str], float],
    crossvalidate: Callable[[str], float],
    log: Callable[[str], None] = print,
    fs_ops: bool = True,
    barrier: Callable[[], None] = None,
) -> Tuple[str, NewbobState]:
    """Drive newbob training.

    ``train_epoch(src_mmf, lrate, dst_mmf) -> train_accuracy`` runs one
    epoch; ``crossvalidate(mmf) -> cv_accuracy`` evaluates. Returns
    (best_model_path, state).

    Multi-host: every process runs the (identical) decision loop, but
    only one mutates the weight files — pass ``fs_ops=False`` on the
    others and a ``barrier`` (e.g. multihost_utils.sync_global_devices)
    so nobody reads a renamed file before process 0 moved it.
    """

    def fs_replace(a, b):
        if fs_ops:
            os.replace(a, b)
        if barrier is not None:
            barrier()

    os.makedirs(weights_dir, exist_ok=True)
    base = os.path.join(
        weights_dir,
        os.path.basename(init_mmf)[:-5] if init_mmf.endswith(".init")
        else os.path.basename(init_mmf))

    accu_best = crossvalidate(init_mmf)
    log(f"Initial CV accuracy: {accu_best:.10g}")
    st = NewbobState(lrate=cfg.learning_rate, accu_best=accu_best,
                     nnet_best=init_mmf)

    accu_prev = accu_best
    accu_train = 0.0
    for it in range(1, cfg.max_iter + 1):
        st.iter = it
        nnet_next = f"{base}_iter{it:02d}"
        accu_train = train_epoch(st.nnet_best, st.lrate, nnet_next)
        log(f"TR accuracy:  {accu_train:.10g} iter: {it} learnrate: {st.lrate:g}")
        accu_cv = crossvalidate(nnet_next)
        log(f"CV accuracy: {accu_cv:.10g} iter: {it} learnrate: {st.lrate:g}")

        named = (f"{nnet_next}_lr{st.lrate:.5g}_tr{accu_train:.5g}"
                 f"_cv{accu_cv:.5g}")
        fs_replace(nnet_next, named)
        st.history.append({"iter": it, "lrate": st.lrate, "tr": accu_train,
                           "cv": accu_cv, "model": named})

        if it < cfg.keep_lrate_iter:
            log("accepting weights (keep_lrate_iter)")
            st.nnet_best = named
            accu_prev = st.accu_best
            st.accu_best = accu_cv
            continue

        if accu_cv < st.accu_best:
            log(f"reverting the weights  {accu_cv:.10g} < {st.accu_best:.10g}")
            accu_prev = st.accu_best
            fs_replace(named, named + "_rejected")
            st.history[-1]["rejected"] = True
        else:
            log("accepting weights")
            st.nnet_best = named
            accu_prev = st.accu_best
            st.accu_best = accu_cv

        if (st.do_halving and st.accu_best < accu_prev + cfg.end_halving_inc
                and it > cfg.min_iter):
            break

        if accu_cv < accu_prev + cfg.start_halving_inc:
            st.do_halving = True

        if st.do_halving:
            st.lrate *= cfg.halving_factor
            log(f"lrate={st.lrate:g}")

    final = (f"{base}_final_iters{st.iter}_tr{accu_train:.5g}"
             f"_cv{st.accu_best:.5g}")
    if st.iter > 0 and fs_ops and os.path.exists(st.nnet_best):
        import shutil
        shutil.copy(st.nnet_best, final)
    if barrier is not None:
        barrier()
    return st.nnet_best, st

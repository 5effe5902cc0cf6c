#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (nnet_asr_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without the
final line):
  1. environment: the card's name and power limit, torch/CUDA versions,
     TF32 off on both paths;
  2. build: nvcc compiles nnet_asr_torch/csrc/*.cu for sm_90a into
     build/kernels/;
  3. each CUDA kernel against its plain PyTorch version on the card at the
     main paths' shapes, the bf16-operand variants of affine_sigmoid and
     wgrad_momentum_update too (bound at 989 TFLOP/s dense bf16; library
     yardsticks bf16 addmm + sigmoid_, and bf16 x.T @ e + the f32 update
     passes) (forward, and gradients for affine_sigmoid, at the recipes'
     small shapes too: TIMIT's 1024x368->500, one tmpe utterance's
     284x598->1024, a 2x2 mesh rank's 480x598->1024; each shape's plan
     (tile, splits, copy widths, blocks) on a line of its own; split-K in
     one launch a call, for the forward as for the weight gradient, and two
     launches equal bit for bit; the kernel's and the library yardstick's
     device time from one profiler window of calls in turns; the
     fused wgrad+momentum update with f32 and bf16 velocity, split-K where
     its plan asks, twice to show equal bits; softmax-CE once per shape of
     its plan, with tied rows, a NaN row and a NaN in a labelled row, twice
     to show equal bits and one launch a call), with CUDA-event and
     profiler timings of kernel, plain version and a library yardstick the
     port never calls (addmm + sigmoid_; addmm_ with beta + add_), beside
     the bound: the larger of the operations at the arithmetic's peak (165
     TFLOP/s for 3xTF32 on the tensor cores) and the bytes at 3.35 TB/s;
     softmax-CE also with L2 flushed between launches, its bound share
     taken against that time, and torch.softmax and a copy at the same
     shape as same-bytes yardsticks; each bf16 shape's route (WGMMA: TMA +
     wgmma, the production shapes; CP_WGMMA: wgmma fed by cp.async, the
     forward at the recipes' rows of 598 and 500, the weight gradient at
     MLP3's two weights) held by the per-route launch counters, the
     CP_WGMMA rows (the forward's also with act "none") beside the mma.sync
     kernel they replaced (forced, gemm_ceiling.mma_sync_bf16: in turns with
     the library, and alone), and the wrappers' host us per call
     on WGMMA and MMA_SYNC at the production shapes; the f32 rows of both kernels at every shape on
     the MMA_SYNC route (gemm_ceiling.mma_sync_f32), then rows of their own
     for the f32 WGMMA route (3xTF32 wgmma: a pre-pass kernel and the GEMM
     a call) at the five production shapes, f32 and bf16 velocity, each
     with its plan, bound, plain, library and alone times, and for the f32
     CP_WGMMA route (3xTF32 wgmma fed by cp.async, x split in the block,
     one launch a call) at the recipes' shapes (F32_CP_AFFINE,
     F32_CP_WGRAD at f32 and bf16 velocity), each also beside the mma.sync
     kernel it replaced (forced, gemm_ceiling.mma_sync_f32: in turns with
     the library, and alone), and for the f32 WS_WGMMA route (the
     warp-specialised 3xTF32 ring, split-K as a cluster: the weight
     gradient of an odd Out) at F32_CP_WGRAD's 960x1024->135, beside the
     mma.sync kernel it replaced (forced) and the library; and rows for the
     f32 input gradient dx = dz W^T on its WGMMA kernel (csrc/dgrad.cu: W
     read K-major, dz split by a pre-pass) at the production stack's two
     dgrad shapes and the SWB CD-DNN's two one-wave ones (DGRAD_SHAPES),
     against an f64 product and beside cuBLAS's FFMA product (the library
     yardstick, the route it replaced);
  4. the frame-CE path: the port's tnet CLI on cuda:0 trains example-01's
     MLP3 (598->1024->135, bunch 960, cache 14400, 51-frame Hamming-DCT
     transform) for two epochs on a synthetic HTK corpus made from a seed,
     cross-validates the initial and the trained model, and checks that
     both of its kernels were launched; then the first epoch again on the
     CPU (plain versions) must agree;
  5. the momentum newbob path on the same corpus: the port's scheduler
     runs newbob with momentum (tnet --MOMENTUM per epoch, every weight
     updated by the fused wgrad+momentum kernel) and must launch that
     kernel twice per training bunch and raise CV accuracy; the first
     momentum epoch again on the CPU must agree; tfeacat --LOGPOSTERIOR on
     the best model and tnorm on the transform must agree between cuda:0
     and the CPU, and tfeacat --GMMBYPASS must be finite;
  6. the production-width stack 1024->4096x4->8192 (bunch 1024) through
     the port's Trainer: frames/s and achieved TFLOP/s of the train step
     with momentum 0, and with momentum 0.9 (f32 and bf16 velocity), and
     under MSE and with a BlockSoftmax(4096, 4096) head at momentum 0 and
     0.9, and under the bf16 compute dtype at momentum 0 and 0.9 (TFLOP/s
     also against the bf16 bound); then a torch.profiler window of steps
     with momentum 0 and 0.9, MSE and BlockSoftmax at momentum 0, and bf16
     at momentum 0 and 0.9, device time summed by kernel name; every
     window holds exact per-route launches (4 WGMMA affine_sigmoid a step,
     5 WGMMA wgrad a momentum step, f32 on the f32 WGMMA route, bf16 on the
     bf16 one, none on MMA_SYNC; 4 f32 dgrads a f32 step, none at bf16 nor
     in any other phase); two f32 steps at momentum 0 and 0.9 from
     the same weights on the f32 WGMMA route and on MMA_SYNC agree within
     1e-5;
  7. objectives and tags, on phase 4's corpus (run before phase 6): tnet
     -O mse (epoch + CV, CV Mse must fall), a BlockSoftmax(90, 45) head
     (epoch + CV, CV accuracy must rise), a --CONFUSIONMODE=max CV whose
     matrix sums to the CV frames, and a SparseLinearity hidden layer with
     --L1=1e-5 whose written mask holds zeros; each cuda:0 run's wrapper
     launches exact (affine_sigmoid once a bunch, none for the
     SparseLinearity pair; fused_softmax_xent only on the L1 run); the MSE
     and BlockSoftmax epochs again on the CPU must agree; tfeacat of the
     BlockSoftmax model on cuda:0 within 1e-4 of the CPU's;
  8. compute dtypes, on phase 4's corpus (run before phase 6): tnet
     --COMPUTEDTYPE=bf16|int8|int8pf|int8pfsr|int8full on cuda:0, an epoch
     and a CV of its model each (bf16 also with --MOMENTUM), each with exact
     launch counts per dtype (bf16: the bf16 affine_sigmoid once a bunch, on
     the CP_WGMMA route, and the bf16 wgrad twice a momentum bunch, on its
     CP_WGMMA route too; int8: no GEMM kernel); the bf16
     and int8 epochs again on the CPU must agree; the scheduler with
     --compute-dtype=bf16 for 2 newbob iterations; tfeacat --BF16 and --INT8
     on cuda:0 against the CPU;
  9. RBM pretraining, on phase 4's corpus (run before phase 6): the recipe
     of examples/run_rbm_pretrain_example01.sh at MLP3's width (rbm_init
     598:1024 Gaussian-Bernoulli, trbm twice, Mse/frame must fall;
     rbm2mlplayer, netjoin into the second transform, rbm_init 1024:1024,
     trbm twice; rbm2mlplayer, a gen_mlp_init 1024:135 top, netjoin), then
     one tnet epoch and a CV of the stacked 598->1024->1024->135 net and of
     a random init (CV must rise over the random init's), each with exact
     launches (affine_sigmoid twice a bunch, fused_softmax_xent once); an
     <rbmsparse> epoch, an --RNGIMPL=rbg epoch; one CD-1 step with injected
     noise on cuda:0 against the CPU; the CD-1 step timed by CUDA events and
     a profiler window (598->1024 and 1024->1024, bunch 256 and 960);
 10. recurrent BPTT, on phase 4's corpus (run before phase 6): a
     598-><recurrent> 500->135 net from the generators, one trecurrent
     epoch (--BPTT=4) and CVs (CV must rise), the epoch on its first
     utterances and --FRAMESERIAL=TRUE on 4 utterances again on the CPU;
     RecurrentTrainer.train_batch timed on the stack of
     scripts/recurrent_roofline.py (368->500->rec 500->39, K 4, T 512, B 32
     and 128) by CUDA events and a profiler window;
 11. MPE/MMI sequence training (run before phase 6): a phone-structured
     corpus (45 phones x 3 states, MLP3's widths) with seeded SLF phone
     lattices and gen_gmmbypass's HMM set, one tnet epoch, then tmpe with
     the native engine: -c, one MPE iteration (kappa 0.3, lr 0.02), -c,
     an --MMI and a --DELAYEDUPDATE iteration, with exact affine_sigmoid
     launches (one an utterance under -c, two in training), and a
     profiler window over one more iteration (device time by group, idle
     share); affine_sigmoid against its plain version at one utterance's
     rows; the device engine against the native one on 8 utterances' card
     log-posteriors (gammas within 1e-5, ms an utterance each);
     --MPEENGINE=auto's probe; an MPE iteration over 8 utterances again on
     the CPU (MMF within 1e-4 relative, accuracy within 1e-4, the card's
     update within MPE_UPDATE_TOL of the CPU's in L2, which a card run at
     half the learning rate must fail).
 12. resident newbob (run before phase 6): phase 5's momentum scheduler
     and phase 8's bf16 one again with --resident, every weight file
     byte-identical to theirs and the launches equal; then
     examples/run_timit_scale.sh stages 2-4 through the port's CLIs on a
     TIMIT-scale corpus (tools/synth_corpus.py TIMIT: 4620 + 200
     utterances, ~1.11M training frames): tjoiner --STARTFRMEXT=15,
     generators hamm_dct (DCT 16) + tnorm on the joined script,
     gen_mlp_init 368:500:39 --seed=4242, and the scheduler (lr 4.0, bunch
     1024, cache 65536, 2 iterations) streaming, --resident, and
     --resident with half the training stacks' MiB as --hbm-budget-mb: the
     same newbob history and byte-identical weight files in all three,
     "host-parked" in the budgeted run, affine_sigmoid and
     fused_softmax_xent exactly once a drained bunch, CV rising; each
     run's wall, intake seconds, resident and parked bytes, peak device
     memory and per-epoch frames/s logged; a profiler window over one more
     resident epoch (device busy and idle share, time by kernel group),
     its weights byte-identical to epoch 1's. Phase 3 also holds
     affine_sigmoid at 1024x368->500 (f32 and bf16) and fused_softmax_xent
     at 1024x39, this path's shapes.
 13. multi-device (run before phase 6): ranks are processes started from
     this script (``--mesh-rank``: fresh interpreters that load the built
     kernels), each with a timeout; a rank that fails or hangs fails the
     phase. tnet --MESH=1x1 (one rank, NCCL) byte-identical to phase 4's
     first epoch, with its CV; then 4 ranks on the card (gloo): which
     collectives gloo carries for CUDA tensors, tnet --MESH=2x2 (135
     senones padded to 136) within 1e-4 of phase 4's epoch, scheduler
     --resident --mesh=2x2 on phase 5's newbob (the decisions of phase 12's
     single-device resident run, best model within 1e-4), the production
     stack at momentum 0.9 on a 2x2 mesh (3 steps after a warm-up, ms a
     step and memory a rank, labelled as no scaling figure; parameters
     within 1e-4 of the single-device Trainer), a RecurrentTrainer batch
     (3e-4) and a CD-1 step (2e-4) over data=2; then 2 ranks: tnet
     --DISTRIBUTED=TRUE --MESH=2x1 (its shard and drop lines; within 1e-4
     of the single-device Trainer fed the replayed global bunches) and
     tmpe --MESH=2x1 (its update within MPE_UPDATE_TOL of phase 11's).
     Launches exact per rank: affine_sigmoid on every mesh step,
     fused_softmax_xent only at model 1, wgrad_momentum_update never, the
     f32 dgrad kernel on the production mesh's 4 layers after the first
     (512 rows: one wave of 128 tiles) and nowhere else.
Phase 2 also fails on a ptxas spill in a wgmma kernel (the WGMMA and
CP_WGMMA routes, bf16 or f32). The line before the last is the kernels'
JSON record (the four WGMMA-route kernels, bf16 and f32, as entries of
their own, launched by phase 6; the bf16 CP_WGMMA forward and weight
gradient as entries of their own, launched by phases 8 and 12, every bunch
of the bf16 MLP3 runs;
the f32 CP_WGMMA forward and wgrad as entries of their own, and the
others, their launches summed over phases 4, 5, 7, 8, 9, 11, 12 and 13,
every rank, where every f32 launch must be on the CP_WGMMA route, checked
phase by phase (none on mma.sync but the shapes the plan keeps there, no
f32 WGMMA one); affine_sigmoid and
affine_sigmoid_bf16 count every route of their dtype, their f32 rows the
mma.sync kernel forced); the last line is {"ok": true, "device": {...}}.
Exits non-zero when CUDA is unavailable.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 123
FEAT_DIM, EXT, DCT, CLASSES = 23, 25, 26, 135    # example-01 (CorpusShape defaults)
BUNCH, CACHE = 960, 14400
PROD_DIMS = [1024, 4096, 4096, 4096, 4096, 8192]
PROD_BUNCH, PROD_CACHE_BUNCHES = 1024, 8
# the momentum newbob path: tnet divides the summed gradient by the bunch
# and scales it by 1/(1-m) (TNetCu semantics), so 7.68 = 0.008 * 960 gives
# the per-step rate of the frame-CE path's -n 0.008 --GRAD-DIV-FRM=F
MOM, MOM_LR, MOM_ITERS = 0.5, 7.68, 3
# (B, In, Out, velocity dtypes) of the fused update: MLP3's two weights,
# then the production stack's 1024->4096, 4096->4096 and 4096->8192
WGRAD_SHAPES = ((BUNCH, 598, 1024, ("f32",)), (BUNCH, 1024, CLASSES, ("f32",)),
                (1024, 1024, 4096, ("f32",)), (1024, 4096, 4096, ("f32", "bf16")),
                (1024, 4096, 8192, ("f32", "bf16")))
# (M, K, N) of affine_sigmoid: MLP3's hidden layer, the production stack's
# first layer and its 4096->4096 layers, phase 12's TIMIT hidden layer, one
# tmpe utterance's rows (phase 11 adds its own) and a 2x2 mesh rank's rows
# of MLP3 (phase 13)
AFFINE_SHAPES = ((BUNCH, 598, 1024), (1024, 1024, 4096), (1024, 4096, 4096),
                 (1024, 368, 500), (284, 598, 1024), (BUNCH // 2, 598, 1024))
# the production shapes of the f32 WGMMA route (phase 3 rows of their own;
# the rows above at these shapes are taken on the MMA_SYNC route):
# affine_sigmoid (M, K, N), wgrad_momentum_update (B, In, Out, velocities)
F32_WGMMA_AFFINE = ((1024, 1024, 4096), (1024, 4096, 4096))
F32_WGMMA_WGRAD = ((1024, 1024, 4096, ("f32",)), (1024, 4096, 4096, ("f32", "bf16")),
                   (1024, 4096, 8192, ("f32", "bf16")))
# (B, In, Out) of the f32 input gradient dx = dz W^T on its WGMMA kernel
# (csrc/dgrad.cu): the production stack's hidden and output layers, whose
# four dgrads a step it forms (phase 6; at a 2x2 mesh rank's 512 rows too,
# phase 13), and the SWB CD-DNN's 2048-wide hidden and 9,304-wide output
# layers (one wave of 128 tiles); every other dx stays on cuBLAS
DGRAD_SHAPES = ((1024, 4096, 4096), (1024, 4096, 8192), (1024, 2048, 2048), (1024, 2048, 9304))
DGRAD_PER_STEP = len(PROD_DIMS) - 2
# the recipes' shapes of the f32 CP_WGMMA route (3xTF32 wgmma fed by
# cp.async; phase 3 rows of their own, each beside the mma.sync kernel
# forced): affine_sigmoid (M, K, N) at MLP3's, TIMIT's, a 2x2 mesh rank's,
# one tmpe utterance's rows and the RBM recipe's second hidden layer;
# wgrad_momentum_update (B, In, Out, velocities) at MLP3's two weights
F32_CP_AFFINE = ((BUNCH, 598, 1024), (1024, 368, 500), (BUNCH // 2, 598, 1024),
                 (284, 598, 1024), (BUNCH, 1024, 1024))
F32_CP_WGRAD = ((BUNCH, 598, 1024, ("f32", "bf16")), (BUNCH, 1024, CLASSES, ("f32", "bf16")))
# the shapes of F32_CP_WGRAD the plan sends off the route (an odd Out: to
# the WS_WGMMA route, the warp-specialised 3xTF32 wgmma ring), their rows
# forced onto it; the WS_WGMMA rows are theirs, on the plan's route, beside
# the route it replaced
F32_CP_ELSEWHERE = {(BUNCH, 1024, CLASSES)}
# the f32 launches of MLP3's output-layer weight gradient (960x1024->135),
# all on the WS_WGMMA route, in phases 5 and 12: 36 bunches an epoch, three
# momentum epochs a run, once streaming and once resident
WS_OUT_LAUNCHES = {"5": 108, "12": 108}
# calls of the kernel and of the library yardstick, in turns, in one
# profiler window (fewer where a call takes over 100 us)
PAIRED_REPS, PAIRED_REPS_LONG = 200, 30
# (B, C) of fused_softmax_xent, one per shape of its plan: MLP3's output
# (one warp per row), the production stack's (a row in a block's
# registers), a row width with 4-byte accesses, and one past the register
# limit (two walks); then phase 12's TIMIT output (156-byte rows)
SOFTMAX_SHAPES = ((BUNCH, CLASSES), (1024, 8192), (1000, 3001), (1024, 16384), (1024, 39))
FLUSH_BYTES = 256 << 20     # written between launches to time with L2 cold
# NVIDIA H100 SXM data sheet: 495 TFLOP/s dense TF32, of which 3xTF32 gives
# a third as f32-accurate work; 67 TFLOP/s f32 outside the tensor cores;
# 3.35 TB/s of HBM3
PEAK_3XTF32, PEAK_F32, HBM_BYTES_S = 495e12 / 3, 67e12, 3.35e12
PEAK_BF16 = 989e12          # dense bf16 tensor cores, the same data sheet
# the compute dtypes of phase 8, and the learning rate of its scheduler run
DTYPES = ("bf16", "int8", "int8pf", "int8pfsr", "int8full")
DTYPE_SCHED_ITERS = 2
# phase 9: examples/run_rbm_pretrain_example01.sh at MLP3's hidden width
RBM_HID, RBM_BUNCH, RBM_CACHE = 1024, 256, 12800
# the timed CD-1 steps: (visible, hidden, unit types), each at both bunches
CD1_SHAPES = ((FEAT_DIM * DCT, RBM_HID, "gauss", "bern"), (RBM_HID, RBM_HID, "bern", "bern"))
CD1_BUNCHES = (256, 960)
# phase 10: the recurrent width of scripts/recurrent_roofline.py:55-65; the
# CPU's agreement run takes the first REC_CPU_UTTS training utterances
REC_HID, REC_BPTT, REC_LR = 500, 4, 0.004
REC_CPU_UTTS, REC_SERIAL_UTTS = 8, 4
ROOFLINE_DIMS, ROOFLINE_T, ROOFLINE_BATCHES = (368, 500, 39), 512, (32, 128)
# phase 11: 45 phones x 3 states (example-01's 135 outputs), the kappa and
# learning rate of scripts/mpe_example01.sh; the engine and CPU checks take
# the first MPE_CHECK_UTTS utterances
MPE_PHONES, MPE_KAPPA, MPE_LR, MPE_CHECK_UTTS = 45, 0.3, 0.02, 8
# card against CPU over those utterances: |update_card - update_cpu| /
# |update_cpu| in L2 norm; 4.25e-4 on an H100 (the f32 rounding of w + d),
# 0.5 for an update at half the learning rate
MPE_UPDATE_TOL = 4e-3
# phase 12: examples/run_timit_scale.sh:28-35 (learning rate 4.0, bunch
# 1024, cache 65536, gen_mlp_init --seed=4242), newbob cut to 2 iterations
TS_LR, TS_BUNCH, TS_CACHE, TS_ITERS, TS_INIT_SEED = 4.0, 1024, 65536, 2, 4242
# (group, pattern in the kernel's name) of an MPE iteration's device time
MPE_GROUPS = (("affine_sigmoid (ours)", "matmul_act"), ("cuBLAS GEMM", "gemm|xmma|cutlass|nvjet"),
              ("copies", "Memcpy|Memset|copy"), ("reductions", "reduce"))
# (group, pattern in the kernel's name) of a CD-1 or BPTT step's device
# time; what matches none is an elementwise pass
STEP_GROUPS = (("cuBLAS GEMM", "gemm|xmma|cutlass|nvjet"),
               ("RNG", "philox|distribution|random|normal_|uniform"),
               ("reductions", "reduce"))


def log(*args) -> None:
    print(*args, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def stdout_of(fn, *args, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


def device_rows(torch, run, tries: int = 3) -> list:
    """The key_averages() rows with device time of a torch.profiler window
    over ``run()``. A window in which the profiler recorded no device time
    at all (it happens now and then on the card, more after a scheduled
    window) is taken again, up to ``tries`` times; then the rows are []."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
        if rows:
            return rows
    return []


def device_us(torch, fn, reps: int = 20, only: str = ""):
    """Device time per call in microseconds, summed over the CUDA kernels
    the profiler saw whose name holds ``only``; None when the profiler
    records no such device time."""
    fn()
    torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in device_rows(torch, lambda: [
        fn() for _ in range(reps)]) if only in e.key)
    return total / reps if total > 0 else None


def _us(v) -> str:
    return "not measured" if v is None else f"{v:.2f} us"


def bound_us(flops: float, nbytes: float, peak: float):
    """(least time in us, "operations" or "bytes"): the larger of the
    operations at ``peak`` and the bytes (each input read once, each output
    written once) at the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e6, ("operations" if t_ops >= t_bytes else "bytes")


def record(shape, err, ms, plain_ms, library_ms, dev, flops, nbytes, peak, alone=None):
    """One shape's numbers; ``dev`` = (kernel, plain, library) device us,
    the kernel's and the library's from calls in turns; ``alone``: the
    kernel's device us in a window of its own calls."""
    b_us, b_by = bound_us(flops, nbytes, peak)
    return {"shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "device_us": dev[0], "plain_device_us": dev[1],
            "library_device_us": dev[2], "device_alone_us": alone, "bound_us": b_us,
            "bound_by": b_by}


def log_times(what, r, tflops=None):
    rate = "" if tflops is None else f" ({tflops:.2f} TFLOP/s)"
    lib = ("none" if r["library_ms"] is None else
           f"{r['library_ms']:.4f} ms, device {_us(r['library_device_us'])}")
    alone = r.get("device_alone_us")
    alone = "" if alone is None else f" (alone {_us(alone)})"
    log(f"time {what}: kernel {r['ms']:.4f} ms{rate}, device {_us(r['device_us'])}{alone}; plain "
        f"{r['plain_ms']:.4f} ms, device {_us(r['plain_device_us'])}; library {lib}; "
        f"bound {r['bound_us']:.2f} us ({r['bound_by']})")


def cuda_ms(torch, fn, reps: int = 30, warmup: int = 5, before=None) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events;
    ``before()``, if given, runs ahead of each, outside the events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(torch, fn, calls: int = 1000, chunk: int = 100) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls: the launch
    loops alone, timed by perf_counter with no sync inside, in chunks of
    ``chunk`` separated by a sync (outside the clock) so that the launch
    queue never fills and the host never waits for the device."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // chunk):
        t0 = time.perf_counter()
        for _ in range(chunk):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / calls * 1e6


def paired_device_us(torch, kernel, library, pattern: str, flops: float):
    """(kernel us, library us) a call, from one profiler window of calls of
    both in turns (kernel, library, library, kernel, ...) after a warm-up
    of the same, so that both meet the same clocks and caches: the device
    kernels whose name matches ``pattern`` are the kernel's, the others the
    library's. Each device kernel counts at its mean time, times its
    launches a call, so that events the profiler drops bias no side; None
    where it recorded none."""
    reps = PAIRED_REPS if flops < 2e10 else PAIRED_REPS_LONG
    for _ in range(10):
        kernel()
        library()
    torch.cuda.synchronize()

    def turns():
        for i in range(reps):
            for fn in ((kernel, library) if i % 2 == 0 else (library, kernel)):
                fn()

    us = [0.0, 0.0]
    for e in device_rows(torch, turns):
        side = 0 if re.search(pattern, e.key) else 1
        us[side] += e.self_device_time_total / e.count * max(1, round(e.count / reps))
    return us[0] or None, us[1] or None


def launches_a_call(torch, fn, counted, calls: int = 20, tries: int = 5) -> int:
    """Device kernels a call of ``fn`` launches: those of a profiler window
    of ``calls`` calls, over ``calls``. The profiler may drop events of a
    short window (it never adds any), so a window whose count is not a
    positive multiple of ``calls`` is taken again, up to ``tries`` windows;
    where none is whole, the launches the wrapper's counter (``counted()``)
    saw, logged as such."""
    fn()
    torch.cuda.synchronize()
    before = counted()
    made = [0]

    def window():
        for _ in range(calls):
            fn()
        made[0] += calls

    seen = []
    for _ in range(tries):
        n = sum(e.count for e in device_rows(torch, window, tries=1))
        if n and n % calls == 0:
            return n // calls
        seen.append(n)
    log(f"  launches a call by the wrapper's counter: the profiler's {tries} windows of "
        f"{calls} calls recorded {seen} kernels, none a whole window")
    return round((counted() - before) / made[0])


def plan_dict(tile_plan, plan) -> dict:
    return {"tile": f"{plan.bm}x{plan.bn}", "splits": plan.splits, "k_chunk": plan.k_chunk,
            "a_bytes": plan.a_bytes, "b_bytes": plan.b_bytes, "blocks": plan.blocks,
            "route": route_name(tile_plan, plan)}


def route_name(tile_plan, plan) -> str:
    return {tile_plan.WGMMA: "WGMMA", tile_plan.CP_WGMMA: "CP_WGMMA",
            tile_plan.WS_WGMMA: "WS_WGMMA"}.get(plan.route, "MMA_SYNC")


def kernels_a_call(tile_plan, plan) -> int:
    """Device kernels one f32 wrapper call launches: the f32 WGMMA route's
    pre-pass and GEMM, else the one GEMM (split-K reduced in it)."""
    return 2 if plan.route == tile_plan.WGMMA else 1


def misaligned_copy(torch, t):
    """A contiguous copy of ``t`` whose base lies one element past a 16-byte
    boundary: the same shape on the MMA_SYNC route."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def check_matmul_act(torch, dev, M, K, N, seed, profiled=True):
    """affine_sigmoid against its plain version; ``profiled``: device times
    and launches from profiler windows, else by the wrapper's counter and
    CUDA events alone (after a scheduled profiler window has run in this
    process, later windows record no device time)."""
    from nnet_asr_torch.ops.kernels import matmul_act as MA
    from nnet_asr_torch.ops.kernels import tile_plan

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=dev)
    w = torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)
    b = 0.1 * torch.randn((N,), generator=gen, device=dev)
    g = torch.randn((M, N), generator=gen, device=dev)
    pl = tile_plan.plan(M, N, K, K, N, x.data_ptr(), w.data_ptr())
    plan = plan_dict(tile_plan, pl)
    route = plan["route"]
    log(f"plan affine_sigmoid {M}x{K}->{N}: {json.dumps(plan)}")

    ts = [t.clone().requires_grad_(True) for t in (x, w, b)]
    ps = [t.clone().requires_grad_(True) for t in (x, w, b)]
    before = (MA.matmul_act.launches, MA.matmul_act.launches_f32_wgmma,
              MA.matmul_act.launches_f32_cp_wgmma)
    y = MA.affine_sigmoid(*ts)
    check((MA.matmul_act.launches, MA.matmul_act.launches_f32_wgmma,
           MA.matmul_act.launches_f32_cp_wgmma)
          == (before[0] + 1, before[1] + (route == "WGMMA"), before[2] + (route == "CP_WGMMA")),
          f"affine_sigmoid {M}x{K}->{N}: not one f32 launch on the {route} route")
    y.backward(g)
    yp = MA.matmul_act_plain(*ps)
    yp.backward(g)
    torch.cuda.synchronize()
    err_y = (y - yp).abs().max().item()
    check(err_y <= 1e-4, f"affine_sigmoid {M}x{K}->{N}: |y - plain| {err_y} > 1e-4")
    rel = {}
    for name, t, p in zip(("dx", "dw", "db"), ts, ps):
        rel[name] = (t.grad - p.grad).abs().max().item() / max(p.grad.abs().max().item(), 1e-30)
        check(rel[name] <= 1e-4, f"affine_sigmoid {M}x{K}->{N}: {name} rel err "
                                 f"{rel[name]} > 1e-4")
    z = MA.matmul_act(x, w, b, "none")
    err_z = (z - MA.matmul_act_plain(x, w, b, "none")).abs().max().item()
    check(err_z <= 1e-4 * max(z.abs().max().item(), 1.0),
          f"matmul_act none {M}x{K}->{N}: err {err_z}")
    # two launches on the same inputs: the same bits (split-K included)
    check(torch.equal(MA.matmul_act(x, w, b), MA.matmul_act(x, w, b)),
          f"affine_sigmoid {M}x{K}->{N}: a second launch differs")
    fns = (lambda: MA.matmul_act(x, w, b, "sigmoid"),
           lambda: MA.matmul_act_plain(x, w, b, "sigmoid"),
           lambda: torch.addmm(b, x, w).sigmoid_())      # library yardstick
    ms, plain_ms, lib_ms = (cuda_ms(torch, f) for f in fns)
    want = kernels_a_call(tile_plan, pl)
    if profiled:
        k_us, lib_us = paired_device_us(torch, fns[0], fns[2], "matmul_act", 2.0 * M * N * K)
        per_call = launches_a_call(torch, fns[0], lambda: want * MA.matmul_act.launches)
        dev = (k_us, device_us(torch, fns[1]), lib_us)
    else:
        before = MA.matmul_act.launches
        fns[0]()
        per_call, dev = want * (MA.matmul_act.launches - before), (None, None, None)
    check(per_call == want, f"affine_sigmoid {M}x{K}->{N}: {per_call} kernels a call, want {want}")
    r = record(f"{M}x{K}->{N}", err_y, ms, plain_ms, lib_ms, dev, 2.0 * M * N * K,
               4.0 * (M * K + K * N + N + M * N), PEAK_3XTF32,
               device_us(torch, fns[0]) if profiled else None)
    r["plan"], r["route"] = plan, route
    if route == "CP_WGMMA" and profiled:
        mma_sync_rows(torch, r, f"affine_sigmoid {M}x{K}->{N}", fns[2],
                      lambda: MA.matmul_act(x, w, b, "sigmoid"), "matmul_act",
                      2.0 * M * N * K)
    log(f"kernel affine_sigmoid {M}x{K}->{N} ({route}): max|y-plain| {err_y:.3e}, grad rel err "
        f"dx {rel['dx']:.2e} dw {rel['dw']:.2e} db {rel['db']:.2e}; {per_call} kernel(s) a call "
        f"(the f32 WGMMA route: pre-pass + GEMM), two launches equal bit for bit")
    log_times(f"affine_sigmoid {M}x{K}->{N} (plain: cuBLAS f32 + bias + sigmoid; library: "
              f"addmm + sigmoid_)", r, 2.0 * M * N * K / (ms * 1e-3) / 1e12)
    return r


def check_dgrad(torch, dev, B, In, Out, seed):
    """The f32 input gradient dx = dz W^T on its WGMMA kernel against an f64
    product (within 1e-5 of its largest element) and cuBLAS's FFMA product
    (torch.matmul, the library yardstick and the route it replaced), three
    calls equal bit for bit, two kernels a call (the pre-pass and the
    GEMM), its counter one a call; device times in turns with the library
    and alone, beside the bound."""
    from nnet_asr_torch.ops.kernels import matmul_act as MA
    from nnet_asr_torch.ops.kernels import tile_plan

    gen = torch.Generator(device=dev).manual_seed(seed)
    dz = torch.randn((B, Out), generator=gen, device=dev) / math.sqrt(Out)
    w = torch.randn((In, Out), generator=gen, device=dev)
    pl = tile_plan.dgrad_plan(B, In, Out, dz.data_ptr(), w.data_ptr())
    check(pl is not None and pl.route == tile_plan.WGMMA,
          f"dgrad {B}x{In}->{Out}: the plan leaves it to the library")
    plan = plan_dict(tile_plan, pl)
    log(f"plan dgrad {B}x{In}->{Out}: {json.dumps(plan)}")
    before = MA.dgrad.launches
    dx = [MA.dgrad(dz, w) for _ in range(3)]
    check(MA.dgrad.launches == before + 3, f"dgrad {B}x{In}->{Out}: not one launch a call")
    ref = dz.double() @ w.double().T
    lib = torch.matmul(dz, w.T)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    err, err_lib = ((t.double() - ref).abs().max().item() for t in (dx[0], lib))
    check(err <= 1e-5 * scale, f"dgrad {B}x{In}->{Out}: |dx - f64| {err} > 1e-5 * {scale}")
    check(all(torch.equal(dx[0], t) for t in dx[1:]),
          f"dgrad {B}x{In}->{Out}: a second launch differs")
    fns = (lambda: MA.dgrad(dz, w), lambda: torch.matmul(dz, w.T))
    flops = 2.0 * B * In * Out
    ms, lib_ms = (cuda_ms(torch, f) for f in fns)
    k_us, lib_us = paired_device_us(torch, fns[0], fns[1], "dgrad_f32_", flops)
    per_call = launches_a_call(torch, fns[0], lambda: 2 * MA.dgrad.launches)
    check(per_call == 2, f"dgrad {B}x{In}->{Out}: {per_call} kernels a call, want 2")
    r = record(f"{B}x{In}->{Out}", err, ms, lib_ms, lib_ms, (k_us, lib_us, lib_us), flops,
               4.0 * (B * Out + In * Out + B * In), PEAK_3XTF32, device_us(torch, fns[0]))
    r["plan"], r["route"], r["library_err"] = plan, "WGMMA", err_lib
    log(f"kernel dgrad {B}x{In}->{Out} (WGMMA): max|dx-f64| {err:.3e} (cuBLAS {err_lib:.3e}) of "
        f"max {scale:.3e}; 2 kernels a call (pre-pass + GEMM), three launches equal bit for bit")
    log_times(f"dgrad {B}x{In}->{Out} (plain and library: cuBLAS f32 dz @ W.T)", r,
              flops / (ms * 1e-3) / 1e12)
    return r


def mma_sync_rows(torch, r, what, library, kernel, pattern, flops):
    """The f32 mma.sync kernel the CP_WGMMA or WS_WGMMA route (``r``'s)
    replaced, forced at the same shape (gemm_ceiling.mma_sync_f32): device
    us in turns with the library and alone, into ``r``."""
    from nnet_asr_torch.tools.gemm_ceiling import mma_sync_f32

    def mma_sync():
        with mma_sync_f32():
            kernel()

    r["mma_sync_device_us"], r["mma_sync_library_us"] = paired_device_us(
        torch, mma_sync, library, pattern, flops)
    r["mma_sync_alone_us"] = device_us(torch, mma_sync)
    log(f"time {what} on mma.sync (forced): device {_us(r['mma_sync_device_us'])} in turns "
        f"with the library ({_us(r['mma_sync_library_us'])}), alone "
        f"{_us(r['mma_sync_alone_us'])}; {r['route']} {_us(r['device_us'])} in turns, alone "
        f"{_us(r['device_alone_us'])}; bound {r['bound_us']:.2f} us ({r['bound_by']})")


def _bits(torch, t):
    """The tensor's bits, so that NaNs compare equal to themselves."""
    return t.reshape(-1).view(torch.int32)


def compare_softmax_xent(torch, SC, logits, labels, what):
    """Kernel against plain on one input: err within 1e-6 where plain is
    finite and NaN where it is NaN; xent within 1e-5 relative, or NaN with
    plain's; correct equal; one launch a call; a second run equal bit for
    bit. Returns (max|err - plain|, xent rel err or None, correct)."""
    before = SC.softmax_xent.launches
    err, xent, corr = SC.softmax_xent(logits, labels)
    check(SC.softmax_xent.launches == before + 1, f"{what}: not one launch a call")
    perr, pxent, pcorr = SC.softmax_xent_plain(logits, labels)
    torch.cuda.synchronize()
    nan = torch.isnan(perr)
    check(torch.equal(torch.isnan(err), nan), f"{what}: NaNs of err differ from plain's")
    err_e = (err - perr)[~nan].abs().max().item()
    check(err_e <= 1e-6, f"{what}: |err - plain| {err_e} > 1e-6")
    rel_x = None
    if math.isnan(pxent.item()):
        check(math.isnan(xent.item()), f"{what}: xent {xent.item()}, plain's is NaN")
    else:
        rel_x = abs(xent.item() - pxent.item()) / abs(pxent.item())
        check(rel_x <= 1e-5, f"{what}: xent rel err {rel_x} > 1e-5")
    check(corr.item() == pcorr.item(), f"{what}: correct {corr.item()} != {pcorr.item()}")
    err2, xent2, corr2 = SC.softmax_xent(logits, labels)
    check(torch.equal(_bits(torch, err), _bits(torch, err2))
          and torch.equal(_bits(torch, xent), _bits(torch, xent2))
          and corr.item() == corr2.item(), f"{what}: a second run differs")
    return err_e, rel_x, (corr.item(), pcorr.item())


def check_softmax_xent(torch, dev, B, C, seed):
    from nnet_asr_torch.ops.kernels import softmax_ce as SC
    from nnet_asr_torch.ops.kernels import softmax_plan

    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = 3.0 * torch.randn((B, C), generator=gen, device=dev)
    labels = torch.randint(0, C, (B,), generator=gen, device=dev, dtype=torch.int32)
    labels[1] = -1                                  # a row that adds no stats ...
    logits[1, C // 2] = float("nan")                # ... holding a NaN
    logits[2, 3] = logits[2, C - 2] = logits[2].max() + 1.0   # tied max
    labels[2] = C - 2                               # first max (col 3) wins: a miss
    logits[4, 0] = logits[4, 7] = logits[4].max() + 1.0
    labels[4] = 0                                   # first max is the label: a hit
    what = f"softmax_xent {B}x{C}"
    err_e, rel_x, corr = compare_softmax_xent(torch, SC, logits, labels, what)
    # a NaN in a labelled row whose label is the first max of its other
    # columns: NaN xent and no hit (a NaN-dropping max would count one)
    nl, nb = logits.clone(), labels.clone()
    nl[5, 1] = nl[5].max() + 1.0
    nl[5, C - 1] = float("nan")
    nb[5] = 1
    nan_e, _, nan_corr = compare_softmax_xent(torch, SC, nl, nb, f"{what} NaN row")
    plan = softmax_plan.plan(B, C, logits.data_ptr())

    fns = (lambda: SC.softmax_xent(logits, labels),
           lambda: SC.softmax_xent_plain(logits, labels))
    ms, plain_ms = (cuda_ms(torch, f) for f in fns)
    dev_t = (*(device_us(torch, f) for f in fns), None)
    # L2 cold: FLUSH_BYTES written before each launch, the kernel's own
    # device time. Same-bytes yardsticks (not the same function, so no
    # library time): torch.softmax, and a copy of the logits, the practical
    # ceiling of one read and one write
    flush_buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    cold_ms = cuda_ms(torch, fns[0], before=flush_buf.zero_)
    cold_us = device_us(torch, lambda: (flush_buf.zero_(), fns[0]()), only="softmax_xent_")
    del flush_buf
    soft_ms = cuda_ms(torch, lambda: torch.softmax(logits, 1))
    soft_us = device_us(torch, lambda: torch.softmax(logits, 1))
    copy_out = torch.empty_like(logits)
    copy_us = device_us(torch, lambda: copy_out.copy_(logits))
    # no one PyTorch call forms err and both statistics: no library time.
    # Operations: max, exp, sum, scale, subtract per element (f32, FFMA)
    r = record(f"{B}x{C}", max(err_e, nan_e), ms, plain_ms, None, dev_t, 5.0 * B * C,
               4.0 * (2 * B * C + B), PEAK_F32)
    r.update(cold_ms=cold_ms, cold_device_us=cold_us, softmax_ms=soft_ms,
             softmax_device_us=soft_us, copy_device_us=copy_us,
             plan={"variant": ("narrow", "rows", "wide")[plan.variant],
                   "threads": plan.threads, "values_per_thread": plan.vpt,
                   "16B": plan.vec, "blocks": plan.blocks})
    share = "not measured" if cold_us is None else f"{r['bound_us'] / cold_us:.1%}"
    log(f"kernel {what}: max|err-plain| {err_e:.3e} (NaN row input {nan_e:.3e}), xent rel "
        f"err {rel_x:.2e}, correct {corr[0]} == {corr[1]} (NaN row input {nan_corr[0]} == "
        f"{nan_corr[1]}); plan {r['plan']}; one launch a call, two runs equal bit for bit")
    log_times(f"{what} ({2.0 * B * C * 4 / (ms * 1e-3) / 1e9:.1f} GB/s of "
              f"logits+err by events)", r)
    log(f"time {what} L2 flushed ({FLUSH_BYTES >> 20} MB written before each launch): kernel "
        f"{cold_ms:.4f} ms, device {_us(cold_us)}; bound share {share} of the flushed "
        f"device time; same-bytes yardsticks: torch.softmax(x, 1) {soft_ms:.4f} ms, device "
        f"{_us(soft_us)}; copy_ of the logits, device {_us(copy_us)}")
    return r


def bf16_ulp(torch, t):
    """One bf16 step at each element's magnitude (8 significant bits)."""
    mag = t.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_wgrad_momentum(torch, dev, B, In, Out, vdt, seed, force_cp=False):
    """The fused update against its plain version; ``force_cp``: on the f32
    CP_WGMMA kernel by that route's split rule, at a shape the plan sends
    elsewhere (beside the plan's kernel, for the comparison)."""
    from nnet_asr_torch.ops.kernels import _build
    from nnet_asr_torch.ops.kernels import sgd_fused as SF
    from nnet_asr_torch.ops.kernels import tile_plan

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, In), generator=gen, device=dev)
    e = torch.randn((B, Out), generator=gen, device=dev) / math.sqrt(B)
    p = torch.randn((In, Out), generator=gen, device=dev)
    v = torch.randn((In, Out), generator=gen, device=dev).to(
        torch.bfloat16 if vdt == "bf16" else torch.float32)
    a, m = 1e-3, 0.9
    pk, vk, pp, vp = p.clone(), v.clone(), p.clone(), v.clone()
    plan = tile_plan.plan(In, Out, B, a_pitch=In, b_pitch=Out, a_ptr=x.data_ptr(),
                          b_ptr=e.data_ptr(), wgrad=True, out_ptrs=(pk.data_ptr(), vk.data_ptr()))
    update = SF.wgrad_momentum_update
    stream = torch.cuda.current_stream(dev)
    if force_cp:
        check(plan.route != tile_plan.CP_WGMMA, f"{B}x{In}->{Out}: the plan takes the route")
        plan = tile_plan.cp_fixed(In, Out, B, tile_plan.CP_F32_TILE,
                                  tile_plan.cp_f32_splits(In, Out, B),
                                  tile_plan.copy_bytes(In, x.data_ptr()),
                                  tile_plan.copy_bytes(Out, e.data_ptr()), elem=4)

        def update(x, e, p, v, a, m):
            SF._launch_f32_cp_wgmma(_build.load_library(), x, e, p, v, a, m, plan, stream)
            SF.wgrad_momentum_update.launches += 1
    route = route_name(tile_plan, plan)
    what = (f"wgrad_momentum_update {B}x{In}->{Out} v {vdt}"
            f"{f' ({route} forced)' if force_cp else ''}")
    counters = (lambda: (SF.wgrad_momentum_update.launches,
                         SF.wgrad_momentum_update.launches_f32_wgmma,
                         SF.wgrad_momentum_update.launches_f32_cp_wgmma,
                         SF.wgrad_momentum_update.launches_f32_ws_wgmma))
    before = counters()
    update(x, e, pk, vk, a, m)
    check(counters() == (before[0] + 1, before[1] + (route == "WGMMA"),
                         before[2] + (route == "CP_WGMMA"), before[3] + (route == "WS_WGMMA")),
          f"{what}: not one f32 launch on the {route} route")
    SF.wgrad_momentum_update_plain(x, e, pp, vp, a, m)
    torch.cuda.synchronize()
    check(vk.dtype == vp.dtype == v.dtype, f"{what}: velocity dtype changed")
    # f32: within 1e-5 of the largest plain value (the bunch sums run in
    # another order); bf16 velocity: within that plus one bf16 step at the
    # element (the f32 sum may round to the neighbouring bf16 value; near
    # zero the sum's own error is larger than a bf16 step)
    err_p = (pk - pp).abs().max().item()
    dv = (vk.float() - vp.float()).abs()
    err_v = dv.max().item()
    f32_tol = 1e-5 * vp.float().abs().max().item()
    check(err_p <= 1e-5 * pp.abs().max().item(), f"{what}: max|p - plain| {err_p}")
    if vdt == "f32":
        check(err_v <= f32_tol, f"{what}: max|v - plain| {err_v}")
        v_note = f"max|v-plain| {err_v:.3e}"
    else:
        step = bf16_ulp(torch, torch.maximum(vk.float().abs(), vp.float().abs()))
        worst = ((dv - step) / f32_tol).max().item()
        check(worst <= 1.0, f"{what}: velocity beyond one bf16 step + {f32_tol}")
        v_note = (f"max|v-plain| {err_v:.3e}; {int((dv > step).sum())} of {dv.numel()} "
                  f"elements more than one bf16 step apart, by at most "
                  f"{max(worst, 0.0) * f32_tol:.3e} (tolerance {f32_tol:.3e})")
    # the same step again from the same state gives the same bits (the
    # split-K partials are summed in a fixed order, no float atomics)
    pk2, vk2 = p.clone(), v.clone()
    update(x, e, pk2, vk2, a, m)
    torch.cuda.synchronize()
    check(torch.equal(pk, pk2) and torch.equal(vk, vk2), f"{what}: a second run differs")
    # timed on the updated copies: each call is one more in-place step.
    # Library yardstick (f32 velocity): cuBLAS with beta, then one axpy
    pl, vl = p.clone(), v.clone()
    fns = [lambda: update(x, e, pk, vk, a, m),
           lambda: SF.wgrad_momentum_update_plain(x, e, pp, vp, a, m)]
    if vdt == "f32":
        fns.append(lambda: pl.add_(vl.addmm_(x.T, e, beta=m), alpha=-a))
    times = [cuda_ms(torch, f) for f in fns] + [None] * (3 - len(fns))
    flops = 2.0 * B * In * Out
    if vdt == "f32":
        k_us, lib_us = paired_device_us(torch, fns[0], fns[2], "wgrad_momentum", flops)
    else:
        k_us, lib_us = device_us(torch, fns[0]), None
    want = kernels_a_call(tile_plan, plan)
    per_call = launches_a_call(torch, fns[0], lambda: want * SF.wgrad_momentum_update.launches)
    check(per_call == want, f"{what}: {per_call} kernels a call, want {want}")
    dev = (k_us, device_us(torch, fns[1]), lib_us)
    check(bool(torch.isfinite(pk).all() and torch.isfinite(vk.float()).all()),
          f"{what}: non-finite values after the timed steps")
    vbytes = 2 if vdt == "bf16" else 4
    r = record(f"{B}x{In}->{Out} v {vdt}", max(err_p, err_v), *times, dev,
               flops, 4.0 * (B * In + B * Out) + In * Out * (8 + 2 * vbytes),
               PEAK_3XTF32, device_us(torch, fns[0]) if vdt == "f32" or route == "WGMMA" else None)
    r["plan"], r["route"] = plan_dict(tile_plan, plan), route
    log(f"plan {what}: {json.dumps(r['plan'])}")
    if route in ("CP_WGMMA", "WS_WGMMA") and vdt == "f32":
        mma_sync_rows(torch, r, what, fns[2],
                      lambda: SF.wgrad_momentum_update(x, e, pk, vk, a, m), "wgrad_momentum",
                      flops)
    r["forced"] = force_cp
    log(f"kernel {what} ({route}): max|p-plain| {err_p:.3e}, {v_note}; {per_call} kernel(s) a "
        f"call (the f32 WGMMA route: pre-pass + GEMM), two runs equal bit for bit")
    log_times(f"{what} (plain: cuBLAS f32 x.T@e + elementwise; library: addmm_ with beta "
              f"+ add_)", r, 2.0 * B * In * Out / (r["ms"] * 1e-3) / 1e12)
    return r


def bf16_tol(torch, t, ref):
    """One bf16 step at each element, plus 1e-5 of the largest value: f32
    sums taken in another order may round to neighbouring bf16 values, and
    near zero (cancellation) their own difference exceeds a bf16 step."""
    big = torch.maximum(t.float().abs(), ref.float().abs())
    return bf16_ulp(torch, big) + 1e-5 * ref.float().abs().max()


def check_matmul_act_bf16(torch, dev, M, K, N, seed):
    """The bf16 variant against its plain version (f32 product, bias and
    sigmoid, one rounding): y within bf16_tol; the JAX _bwd gradients (dz
    rounded to bf16, f32 GEMMs each rounded once) within two bf16 steps of
    the largest, against the same formula on the plain y."""
    from nnet_asr_torch.ops.kernels import matmul_act as MA
    from nnet_asr_torch.ops.kernels import tile_plan

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=dev).to(bf)
    w = (torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)).to(bf)
    b = (0.1 * torch.randn((N,), generator=gen, device=dev)).to(bf)
    g = torch.randn((M, N), generator=gen, device=dev).to(bf)
    what = f"affine_sigmoid bf16 {M}x{K}->{N}"
    ts = [t.clone().requires_grad_(True) for t in (x, w, b)]
    plan = tile_plan.plan(M, N, K, a_pitch=K, b_pitch=N, a_ptr=ts[0].data_ptr(),
                          b_ptr=ts[1].data_ptr(), elem=2)
    route = route_name(tile_plan, plan)
    # WGMMA needs rows of 16-byte multiples (598 and 500 bf16 values are
    # not); the other shapes here have rows of whole 4-byte units: CP_WGMMA
    check(route == ("CP_WGMMA" if (2 * K) % 16 or (2 * N) % 16 else "WGMMA"),
          f"{what}: route {route}")
    before = (MA.matmul_act.launches_bf16, MA.matmul_act.launches_bf16_wgmma,
              MA.matmul_act.launches_bf16_cp_wgmma)
    y = MA.affine_sigmoid(*ts)
    y.backward(g)
    yp = MA.matmul_act_plain(x, w, b)
    torch.cuda.synchronize()
    check((MA.matmul_act.launches_bf16, MA.matmul_act.launches_bf16_wgmma,
           MA.matmul_act.launches_bf16_cp_wgmma)
          == (before[0] + 1, before[1] + (route == "WGMMA"), before[2] + (route == "CP_WGMMA"))
          and y.dtype == bf, f"{what}: not one bf16 launch on the {route} route, or y not bf16")
    dy = (y.float() - yp.float()).abs()
    err_y = dy.max().item()
    check(bool((dy <= bf16_tol(torch, y, yp)).all()), f"{what}: y beyond one bf16 step")
    yf = yp.float()
    dz = g.float() * yf * (1.0 - yf)
    dzc = dz.to(bf).float()
    rel = {}
    for name, t, ref in zip(("dx", "dw", "db"), ts,
                            (dzc @ w.float().T, x.float().T @ dzc, dz.sum(0))):
        rel[name] = ((t.grad.float() - ref).abs().max().item()
                     / max(ref.abs().max().item(), 1e-30))
        check(rel[name] <= 2 ** -7, f"{what}: {name} rel err {rel[name]} > 2^-7")
    z = MA.matmul_act(x, w, b, "none")
    check(bool(((z.float() - MA.matmul_act_plain(x, w, b, "none").float()).abs()
                <= bf16_tol(torch, z, MA.matmul_act_plain(x, w, b, "none"))).all()),
          f"{what}: act none beyond one bf16 step")
    check(torch.equal(MA.matmul_act(x, w, b), MA.matmul_act(x, w, b)),
          f"{what}: a second launch differs")
    fns = (lambda: MA.matmul_act(x, w, b, "sigmoid"),
           lambda: MA.matmul_act_plain(x, w, b, "sigmoid"),
           lambda: torch.addmm(b, x, w).sigmoid_())      # library yardstick
    ms, plain_ms, lib_ms = (cuda_ms(torch, f) for f in fns)
    k_us, lib_us = paired_device_us(torch, fns[0], fns[2], "matmul_act", 2.0 * M * N * K)
    counter = ("launches_bf16_cp_wgmma" if route == "CP_WGMMA" else
               "launches_bf16_wgmma" if route == "WGMMA" else "launches_bf16")
    per_call = launches_a_call(torch, fns[0], lambda: getattr(MA.matmul_act, counter))
    check(per_call == 1, f"{what}: {per_call} launches a call")
    devt = (k_us, device_us(torch, fns[1]), lib_us)
    r = record(f"{M}x{K}->{N} bf16", err_y, ms, plain_ms, lib_ms, devt, 2.0 * M * N * K,
               2.0 * (M * K + K * N + N + M * N), PEAK_BF16, device_us(torch, fns[0]))
    r["route"] = route
    r["plan"] = plan_dict(tile_plan, plan)
    log(f"plan {what}: {json.dumps(r['plan'])}")
    if route == "CP_WGMMA":
        # the mma.sync kernel this route replaced, forced at the same shape:
        # in turns with the library, and alone
        from nnet_asr_torch.tools.gemm_ceiling import mma_sync_bf16

        def mma_sync():
            with mma_sync_bf16():
                return MA.matmul_act(x, w, b, "sigmoid")

        ym = mma_sync()
        check(bool(((ym.float() - yp.float()).abs() <= bf16_tol(torch, ym, yp)).all()),
              f"{what}: the mma.sync kernel beyond one bf16 step")
        r["mma_sync_device_us"], r["mma_sync_library_us"] = paired_device_us(
            torch, mma_sync, fns[2], "matmul_act", 2.0 * M * N * K)
        r["mma_sync_alone_us"] = device_us(torch, mma_sync)
        log(f"time {what} on mma.sync (forced): device {_us(r['mma_sync_device_us'])} in turns "
            f"with the library ({_us(r['mma_sync_library_us'])}), alone "
            f"{_us(r['mma_sync_alone_us'])}; CP_WGMMA {_us(k_us)} in turns, alone "
            f"{_us(r['device_alone_us'])}; bound {r['bound_us']:.2f} us ({r['bound_by']})")
    if route == "WGMMA" and K == 1024:
        # host us a call, this route beside MMA_SYNC at the same shape (x
        # one element off a 16-byte boundary)
        xm = misaligned_copy(torch, x)
        check(tile_plan.plan(M, N, K, K, N, xm.data_ptr(), w.data_ptr(), elem=2).route
              == tile_plan.MMA_SYNC, f"{what}: the misaligned copy is not on MMA_SYNC")
        r["host_us"] = host_us(torch, lambda: MA.matmul_act(x, w, b, "sigmoid"))
        r["host_us_mma_sync"] = host_us(torch, lambda: MA.matmul_act(xm, w, b, "sigmoid"))
        log(f"host {what}: {r['host_us']:.2f} us a wrapper call on WGMMA, "
            f"{r['host_us_mma_sync']:.2f} us on MMA_SYNC (1000 calls, no sync)")
    log(f"kernel {what} ({route}): max|y-plain| {err_y:.3e} (within one bf16 step + 1e-5 max), "
        f"grad rel err dx {rel['dx']:.2e} dw {rel['dw']:.2e} db {rel['db']:.2e}; one launch a "
        f"call, two launches equal bit for bit")
    log_times(f"{what} (plain: cuBLAS f32 of the upcast operands + bias + sigmoid + "
              f"rounding; library: bf16 addmm + sigmoid_)", r,
              2.0 * M * N * K / (ms * 1e-3) / 1e12)
    return r


def check_wgrad_momentum_bf16(torch, dev, B, In, Out, vdt, seed):
    """The bf16-operand variant against its plain version: g = x^T e
    rounded to bf16 once in both, so p and v within one bf16 step of g (the
    f32 sums may round to neighbouring values) plus v's own bf16 step; two
    runs equal bit for bit."""
    from nnet_asr_torch.ops.kernels import sgd_fused as SF
    from nnet_asr_torch.ops.kernels import tile_plan

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, In), generator=gen, device=dev).to(bf)
    e = (torch.randn((B, Out), generator=gen, device=dev) / math.sqrt(B)).to(bf)
    p = torch.randn((In, Out), generator=gen, device=dev)
    v = torch.randn((In, Out), generator=gen, device=dev).to(bf if vdt == "bf16" else torch.float32)
    a, m = 1e-3, 0.9
    what = f"wgrad_momentum_update bf16 x,e {B}x{In}->{Out} v {vdt}"
    pk, vk, pp, vp = p.clone(), v.clone(), p.clone(), v.clone()
    plan = tile_plan.plan(In, Out, B, a_pitch=In, b_pitch=Out, a_ptr=x.data_ptr(),
                          b_ptr=e.data_ptr(), wgrad=True, elem=2,
                          out_ptrs=(pk.data_ptr(), vk.data_ptr()))
    route = route_name(tile_plan, plan)
    # MLP3's rows (598 and 135 bf16) are off TMA: CP_WGMMA; the production
    # shapes WGMMA
    check(route == ("CP_WGMMA" if B == BUNCH else "WGMMA"), f"{what}: route {route}")
    counters = (lambda: (SF.wgrad_momentum_update.launches_bf16,
                         SF.wgrad_momentum_update.launches_bf16_wgmma,
                         SF.wgrad_momentum_update.launches_bf16_cp_wgmma))
    before = counters()
    SF.wgrad_momentum_update(x, e, pk, vk, a, m)
    check(counters() == (before[0] + 1, before[1] + (route == "WGMMA"),
                         before[2] + (route == "CP_WGMMA")),
          f"{what}: not one bf16 launch on the {route} route")
    SF.wgrad_momentum_update_plain(x, e, pp, vp, a, m)
    torch.cuda.synchronize()
    g = x.float().T @ e.float()
    tol_v = bf16_ulp(torch, g) + 1e-5 * vp.float().abs().max()
    if vdt == "bf16":
        tol_v = tol_v + bf16_ulp(torch, torch.maximum(vk.float().abs(), vp.float().abs()))
    dv = (vk.float() - vp.float()).abs()
    dp = (pk - pp).abs()
    check(bool((dv <= tol_v).all()), f"{what}: velocity beyond one bf16 step of g")
    check(bool((dp <= a * tol_v + 1e-6 * pp.abs().max()).all()), f"{what}: p beyond a bf16 step")
    differ = int((dv > 1e-5 * vp.float().abs().max()).sum())
    pk2, vk2 = p.clone(), v.clone()
    SF.wgrad_momentum_update(x, e, pk2, vk2, a, m)
    torch.cuda.synchronize()
    check(torch.equal(pk, pk2) and torch.equal(vk, vk2), f"{what}: a second run differs")
    pl, vl = p.clone(), v.clone()

    def library():          # bf16 x.T @ e, then the f32 update passes
        corr = (x.T @ e).float().add_(vl, alpha=m)
        vl.copy_(corr)
        pl.sub_(corr, alpha=a)

    fns = (lambda: SF.wgrad_momentum_update(x, e, pk, vk, a, m),
           lambda: SF.wgrad_momentum_update_plain(x, e, pp, vp, a, m), library)
    times = [cuda_ms(torch, f) for f in fns]
    k_us, lib_us = paired_device_us(torch, fns[0], fns[2], "wgrad_momentum", 2.0 * B * In * Out)
    per_call = launches_a_call(torch, fns[0], lambda: SF.wgrad_momentum_update.launches_bf16)
    check(per_call == 1, f"{what}: {per_call} launches a call")
    devt = (k_us, device_us(torch, fns[1]), lib_us)
    check(bool(torch.isfinite(pk).all() and torch.isfinite(vk.float()).all()),
          f"{what}: non-finite values after the timed steps")
    vbytes = 2 if vdt == "bf16" else 4
    r = record(f"{B}x{In}->{Out} bf16 x,e v {vdt}", max(dp.max().item(), dv.max().item()),
               *times, devt, 2.0 * B * In * Out,
               2.0 * (B * In + B * Out) + In * Out * (8 + 2 * vbytes), PEAK_BF16,
               device_us(torch, fns[0]))
    r["route"] = route
    r["plan"] = plan_dict(tile_plan, plan)
    log(f"plan {what}: {json.dumps(r['plan'])}")
    if route == "CP_WGMMA":
        # the mma.sync kernel this route replaced, forced at the same shape:
        # in turns with the library, and alone
        from nnet_asr_torch.tools.gemm_ceiling import mma_sync_bf16

        pm, vm, pq, vq = p.clone(), v.clone(), p.clone(), v.clone()

        def mma_sync():
            with mma_sync_bf16():
                SF.wgrad_momentum_update(x, e, pm, vm, a, m)

        mma_sync()
        SF.wgrad_momentum_update_plain(x, e, pq, vq, a, m)
        torch.cuda.synchronize()
        tol_q = bf16_ulp(torch, g) + 1e-5 * vq.float().abs().max()
        if vdt == "bf16":
            tol_q = tol_q + bf16_ulp(torch, torch.maximum(vm.float().abs(), vq.float().abs()))
        check(bool(((vm.float() - vq.float()).abs() <= tol_q).all()),
              f"{what}: the mma.sync kernel beyond one bf16 step of g")
        r["mma_sync_device_us"], r["mma_sync_library_us"] = paired_device_us(
            torch, mma_sync, fns[2], "wgrad_momentum", 2.0 * B * In * Out)
        r["mma_sync_alone_us"] = device_us(torch, mma_sync)
        log(f"time {what} on mma.sync (forced): device {_us(r['mma_sync_device_us'])} in turns "
            f"with the library ({_us(r['mma_sync_library_us'])}), alone "
            f"{_us(r['mma_sync_alone_us'])}; CP_WGMMA {_us(k_us)} in turns, alone "
            f"{_us(r['device_alone_us'])}; bound {r['bound_us']:.2f} us ({r['bound_by']})")
    if route == "WGMMA" and vdt == "f32" and In == 1024:   # as for affine_sigmoid bf16
        xm = misaligned_copy(torch, x)
        r["host_us"] = host_us(torch, lambda: SF.wgrad_momentum_update(x, e, pk, vk, a, m))
        r["host_us_mma_sync"] = host_us(torch,
                                        lambda: SF.wgrad_momentum_update(xm, e, pk, vk, a, m))
        log(f"host {what}: {r['host_us']:.2f} us a wrapper call on WGMMA, "
            f"{r['host_us_mma_sync']:.2f} us on MMA_SYNC (1000 calls, no sync)")
    log(f"kernel {what} ({route}): max|p-plain| {dp.max().item():.3e}, max|v-plain| "
        f"{dv.max().item():.3e}, {differ} of {dv.numel()} elements a bf16 rounding of g apart; "
        f"one launch a call, two runs equal bit for bit")
    log_times(f"{what} (plain: cuBLAS f32 of the upcast operands, rounded, + elementwise; "
              f"library: bf16 x.T@e + f32 update passes)", r,
              2.0 * B * In * Out / (r["ms"] * 1e-3) / 1e12)
    return r


# ---------------------------------------------------------------------------
# 4. the frame-CE path: tnet on a synthetic example-01-shaped corpus
# ---------------------------------------------------------------------------

def drained_frames(total: int, cache: int, bunch: int) -> int:
    """Frames that reach the stats: whole caches, then whole bunches of the rest."""
    return (total // cache) * cache + ((total % cache) // bunch) * bunch


XENT = re.compile(r"Xent:(\S+) frames:(\d+) err/frm:\S+ correct\[(\S+)%\]")
MSE = re.compile(r"Mse:(\S+) frames:(\d+) err/frm:\S+")


def tnet_argv(d, src, *extra):
    """tnet's arguments for phase 4's corpus (the frame-CE path)."""
    return ["tnet", "-H", src, "-I", os.path.join(d, "labs.mlf"), "-L", "*/", "-X", "lab",
            "-m", os.path.join(d, "map"), "-n", "0.008", "--GRAD-DIV-FRM=F",
            f"--BUNCHSIZE={BUNCH}", f"--CACHESIZE={CACHE}", "--RANDOMIZE=TRUE",
            f"--SEED={SEED}", f"--FEATURETRANSFORM={os.path.join(d, 'transform')}",
            f"--STARTFRMEXT={EXT}", f"--ENDFRMEXT={EXT}", *extra]


def run_tnet(d, src, *extra, device=None):
    """One tnet run: ``xent`` holds the Xent (or, with -O mse, the Mse)
    total, ``acc`` the accuracy (None for MSE)."""
    from nnet_asr_torch.tools import tnet

    out = stdout_of(tnet.main, tnet_argv(d, src, *extra), device=device)
    return tnet_result(out)


def tnet_result(out: str) -> dict:
    m = XENT.search(out) or MSE.search(out)
    check(m is not None, f"no Xent or Mse line in tnet output:\n{out}")
    fps = re.search(r"FPS:([\d.]+)", out)
    return {"xent": float(m.group(1)), "frames": int(m.group(2)),
            "acc": float(m.group(3)) if m.re is XENT else None,
            "fps": float(fps.group(1)) if fps else None, "log": out}


def main_path(torch, card: str, d: str, n: dict):
    import numpy as np

    from nnet_asr_torch.models.network import Network

    def j(name: str) -> str:
        return os.path.join(d, name)

    train = ("-S", j("train.scp"))
    cv = ("-S", j("cv.scp"), "-c")

    zero_counts()
    e1 = run_tnet(d, j("init.mmf"), *train, f"--TARGETMMF={j('e1.mmf')}")
    e2 = run_tnet(d, j("e1.mmf"), *train, f"--TARGETMMF={j('e2.mmf')}")
    cv0 = run_tnet(d, j("init.mmf"), *cv)
    cv2 = run_tnet(d, j("e2.mmf"), *cv)
    launches = read_counts()

    for name, r in (("epoch 1", e1), ("epoch 2", e2), ("cv init", cv0),
                    ("cv epoch 2", cv2)):
        log(f"tnet cuda:0 {name}: Xent {r['xent']:.10g} frames {r['frames']} "
            f"correct {r['acc']:.4f}% FPS {r['fps']}")
    log(f"main-path launches (4 tnet runs): {json.dumps(launches)}")
    graphs = _graph_launches()
    log(f"of them, by the Trainer's count: captured {json.dumps(graphs['captured'])}, "
        f"replayed from CUDA graphs {json.dumps(graphs['replayed'])}")
    check(graphs["replayed"]["softmax_xent.launches"] > 0,
          "main path: no training step was replayed from a CUDA graph")
    want_train = drained_frames(n["train"], CACHE, BUNCH)
    want_cv = drained_frames(n["cv"], CACHE, BUNCH)
    check(e1["frames"] == e2["frames"] == want_train,
          f"training frames {e1['frames']}, {e2['frames']} != {want_train}")
    check(cv0["frames"] == cv2["frames"] == want_cv,
          f"cv frames {cv0['frames']}, {cv2['frames']} != {want_cv}")
    check(all(math.isfinite(r["xent"]) for r in (e1, e2, cv0, cv2)), "Xent not finite")
    check(cv2["acc"] > cv0["acc"], f"cv accuracy did not improve: "
                                   f"{cv0['acc']}% -> {cv2['acc']}%")
    check(launches["matmul_act"] > 0 and launches["softmax_xent"] > 0,
          f"a kernel was not launched on the main path: {launches}")
    # every bunch's 960x598->1024 forward on the f32 CP_WGMMA route: 36 an
    # epoch, 7 a CV
    per_run = (want_train // BUNCH, want_train // BUNCH, want_cv // BUNCH, want_cv // BUNCH)
    check(launches["matmul_act_f32_cp_wgmma"] == launches["matmul_act"] == sum(per_run),
          f"main path: {launches['matmul_act_f32_cp_wgmma']} f32 CP_WGMMA forwards of "
          f"{launches['matmul_act']}, want {sum(per_run)} ({per_run} a run)")
    net2 = Network.read(j("e2.mmf"))
    check([l.tag for l in net2.layers] == ["<biasedlinearity>", "<sigmoid>",
                                           "<biasedlinearity>", "<softmax>"]
          and (net2.n_inputs, net2.n_outputs) == (FEAT_DIM * DCT, CLASSES),
          "written MMF has the wrong structure")
    check(all(np.isfinite(v).all() for p in net2.to_numpy_params() for v in p.values()),
          "written MMF has non-finite weights")
    log(f"MLP3 epoch throughput (tnet, cuda:0, {card}): {e1['fps']} and "
        f"{e2['fps']} frames/s (epochs 1 and 2, host intake included)")

    # the same first epoch on the CPU through the plain versions
    t0 = time.perf_counter()
    c1 = run_tnet(d, j("init.mmf"), *train, f"--TARGETMMF={j('c1.mmf')}", device="cpu")
    check_cpu_epoch("epoch 1", c1, e1, j("c1.mmf"), j("e1.mmf"), time.perf_counter() - t0)
    return launches


def check_cpu_epoch(what, c, e, c_mmf, e_mmf, cpu_seconds, rtol=1e-4, wtol=1e-4):
    """The CPU run ``c`` of an epoch agrees with its cuda:0 run ``e``: Xent
    (or Mse) within ``rtol`` relative, weights within ``wtol``, correct
    frames within 0.1% (argmax can flip on a near-tie under another
    summation order)."""
    import numpy as np

    from nnet_asr_torch.models.network import Network

    rel = abs(c["xent"] - e["xent"]) / abs(e["xent"])
    dcorr = 0.0 if c["acc"] is None else abs(c["acc"] - e["acc"]) * c["frames"] / 100.0
    wdiff = max(float(np.abs(a[k] - b[k]).max())
                for a, b in zip(Network.read(c_mmf).to_numpy_params(),
                                Network.read(e_mmf).to_numpy_params())
                for k in a)
    log(f"{what} cpu vs cuda:0: Xent/Mse {c['xent']:.10g} vs {e['xent']:.10g} "
        f"(rel {rel:.2e}), frames {c['frames']} vs {e['frames']}, correct differs "
        f"by {dcorr:.0f} frames, max|w_cpu - w_cuda| {wdiff:.2e} "
        f"({cpu_seconds:.1f}s on the CPU)")
    check(rel <= rtol, f"{what}: cpu/cuda Xent rel diff {rel} > {rtol}")
    check(c["frames"] == e["frames"], f"{what}: cpu/cuda frame counts differ")
    check(dcorr <= 1e-3 * c["frames"], f"{what}: cpu/cuda correct differs by {dcorr} frames")
    check(wdiff <= wtol, f"{what}: cpu/cuda weights differ by {wdiff} > {wtol}")


# ---------------------------------------------------------------------------
# 5. the momentum newbob path: scheduler -> tnet --MOMENTUM -> tfeacat, tnorm
# ---------------------------------------------------------------------------

def read_user_features(path):
    """An HTK feature file written big-endian: (n_samples, dim) float32."""
    import numpy as np

    n, _, size, _ = np.fromfile(path, dtype=">i4,>i4,>i2,>i2", count=1)[0]
    return np.fromfile(path, dtype=">f4", offset=12).reshape(int(n), int(size) // 4)


def run_tfeacat(d, mmf, out_dir, *extra, device=None):
    """Features of every cv utterance from ``tfeacat``, by file name."""
    from nnet_asr_torch.tools import tfeacat

    os.makedirs(out_dir)
    argv = ["tfeacat", "-H", mmf, "-S", os.path.join(d, "cv.scp"),
            f"--FEATURETRANSFORM={os.path.join(d, 'transform')}",
            f"--STARTFRMEXT={EXT}", f"--ENDFRMEXT={EXT}", "-l", out_dir, "-y", "fea", *extra]
    check(tfeacat.main(argv, device=device) == 0, "tfeacat failed")
    return {f: read_user_features(os.path.join(out_dir, f)) for f in sorted(os.listdir(out_dir))}


def run_tnorm(d, target, device=None):
    """(bias, window) that ``tnorm`` computes over the training part."""
    from nnet_asr_torch.models.network import Network
    from nnet_asr_torch.tools import tnorm

    argv = ["tnorm", "-H", os.path.join(d, "transform"), "-S", os.path.join(d, "train.scp"),
            f"--STARTFRMEXT={EXT}", f"--ENDFRMEXT={EXT}", f"--TARGETMMF={target}"]
    stdout_of(tnorm.main, argv, device=device)
    net = Network.read(target)
    check([l.tag for l in net.layers] == ["<bias>", "<window>"], "tnorm output structure")
    return [v for p in net.to_numpy_params() for v in p.values()]


def sched_argv(d, iters, weights, *extra):
    """The scheduler's arguments for momentum newbob on phase 4's corpus
    (phases 5, 8 and 12)."""
    def j(name: str) -> str:
        return os.path.join(d, name)

    return ["--nn-init", j("init.mmf"), "--mlf-train", j("labs.mlf"),
            "--mlf-cv", j("labs.mlf"), "--scp-train", j("train.scp"),
            "--scp-cv", j("cv.scp"), "--phonelist", j("map"),
            "--feature-transform", j("transform"), f"--frm-ext={EXT}",
            f"--bunchsize={BUNCH}", f"--cachesize={CACHE}", f"--seed={SEED}",
            f"--learnrate={MOM_LR!r}", f"--momentum={MOM!r}", f"--max-iter={iters}",
            "--weights-dir", weights, *extra]


def momentum_path(torch, card: str, d: str, n: dict):
    import glob

    import numpy as np

    from nnet_asr_torch.tools import scheduler, tnet

    def j(name: str) -> str:
        return os.path.join(d, name)

    weights = j("weights")
    sched = sched_argv(d, MOM_ITERS, weights)
    zero_counts()
    t0 = time.perf_counter()
    out = stdout_of(scheduler.main, sched)
    wall = time.perf_counter() - t0
    launches = read_counts()

    best_m = re.search(r"Best model: (\S+) \(CV ([\d.]+)%, (\d+) iterations\)", out)
    init_m = re.search(r"Initial CV accuracy: (\S+)", out)
    check(best_m is not None and init_m is not None, f"scheduler output:\n{out}")
    best, best_cv, iters = best_m.group(1), float(best_m.group(2)), int(best_m.group(3))
    init_cv = float(init_m.group(1))
    runs = [(float(x), int(f), float(a)) for x, f, a in XENT.findall(out)]
    fps = [float(v) for v in re.findall(r"FPS:([\d.]+)", out)]
    decisions = re.findall(r"^(accepting weights|reverting the weights.*|lrate=.*)$", out, re.M)
    log(f"scheduler (momentum {MOM}, learnrate {MOM_LR}, {iters} iterations) on cuda:0, "
        f"{card}: {wall:.1f}s; CV accuracy {init_cv}% -> best {best_cv}% "
        f"({os.path.basename(best)}); decisions {decisions}")
    for k, (x, f, a) in enumerate(runs):
        kind = "cv" if k % 2 == 0 else "train"
        log(f"  tnet run {k} ({kind}): Xent {x:.10g} frames {f} correct {a:.4f}% "
            f"FPS {fps[k] if k < len(fps) else None}")
    log(f"momentum-path launches (scheduler, {iters} epochs + {iters + 1} CV runs): "
        f"{json.dumps(launches)}")
    bunches = drained_frames(n["train"], CACHE, BUNCH) // BUNCH
    check(len(runs) == 2 * iters + 1, f"{len(runs)} tnet runs for {iters} iterations")
    check(all(math.isfinite(x) for x, _, _ in runs), "Xent not finite")
    check(launches["wgrad_momentum_update"] == 2 * iters * bunches,
          f"wgrad_momentum_update launched {launches['wgrad_momentum_update']} times, "
          f"not 2 x {iters} epochs x {bunches} bunches")
    # the hidden weight's update (960x598->1024) on the f32 CP_WGMMA route,
    # the output weight's (960x1024->135) on the WS_WGMMA route; every
    # forward on the f32 CP_WGMMA route
    check(launches["wgrad_momentum_update_f32_cp_wgmma"] == iters * bunches
          and launches["wgrad_momentum_update_f32_ws_wgmma"] == iters * bunches
          and launches["matmul_act_f32_cp_wgmma"] == launches["matmul_act"],
          f"momentum path: not every f32 launch on its route: {launches}")
    check(launches["matmul_act"] > 0 and launches["softmax_xent"] > 0,
          f"a kernel was not launched on the momentum path: {launches}")
    check(best_cv > init_cv, f"cv accuracy did not improve: {init_cv}% -> {best_cv}%")

    # the first momentum epoch again on the CPU, as the scheduler ran it
    e1_mmf = glob.glob(os.path.join(weights, "init.mmf_iter01_*"))
    check(len(e1_mmf) == 1, f"epoch-1 model: {e1_mmf}")
    argv = ["tnet", "-H", j("init.mmf"), "-I", j("labs.mlf"), "-S", j("train.scp"),
            f"--LEARNINGRATE={MOM_LR!r}", f"--MOMENTUM={MOM!r}", "--WEIGHTCOST=0.0",
            "--RANDOMIZE=TRUE", f"--SEED={SEED}", f"--TARGETMMF={j('mc1.mmf')}",
            "-m", j("map"), f"--BUNCHSIZE={BUNCH}", f"--CACHESIZE={CACHE}",
            f"--STARTFRMEXT={EXT}", f"--ENDFRMEXT={EXT}", "-L", "*/", "-X", "lab",
            f"--FEATURETRANSFORM={j('transform')}"]
    t0 = time.perf_counter()
    c1 = XENT.search(stdout_of(tnet.main, argv, device="cpu"))
    check(c1 is not None, "no Xent line in the CPU momentum epoch")
    as_run = {"xent": float(c1.group(1)), "frames": int(c1.group(2)),
              "acc": float(c1.group(3))}
    e1 = dict(zip(("xent", "frames", "acc"), runs[1]))
    check_cpu_epoch("momentum epoch 1", as_run, e1, j("mc1.mmf"), e1_mmf[0],
                    time.perf_counter() - t0)

    # posteriors of the best model: log-posteriors on cuda:0 and on the CPU
    # within 1e-4 (logits differ by f32 summation order, ~1e-5); each row's
    # posteriors sum to 1 within 1e-4
    t0 = time.perf_counter()
    lp = run_tfeacat(d, best, j("lpost_cuda"), "--LOGPOSTERIOR=TRUE")
    lp_s = time.perf_counter() - t0
    lp_cpu = run_tfeacat(d, best, j("lpost_cpu"), "--LOGPOSTERIOR=TRUE", device="cpu")
    with open(j("cv.scp")) as f:
        n_cv_files = len(f.read().split())
    check(sorted(lp) == sorted(lp_cpu) and len(lp) == n_cv_files,
          f"tfeacat files: {sorted(lp)}")
    frames = sum(a.shape[0] for a in lp.values())
    check(frames == n["cv"], f"tfeacat wrote {frames} frames, the cv part has {n['cv']}")
    lp_diff = max(float(np.abs(lp[f] - lp_cpu[f]).max()) for f in lp)
    sum_err = max(float(np.abs(np.exp(a.astype(np.float64)).sum(1) - 1).max())
                  for a in lp.values())
    check(all(a.shape[1] == CLASSES and np.isfinite(a).all() for a in lp.values()),
          "tfeacat log-posteriors: wrong width or not finite")
    log(f"tfeacat --LOGPOSTERIOR best model, {len(lp)} cv files, {frames} frames: "
        f"cuda:0 {lp_s:.2f}s; max|lp_cuda - lp_cpu| {lp_diff:.3e}; "
        f"max|sum(p) - 1| {sum_err:.3e}")
    check(lp_diff <= 1e-4, f"tfeacat cpu/cuda log-posteriors differ by {lp_diff}")
    check(sum_err <= 1e-4, f"tfeacat posteriors do not sum to 1: {sum_err}")
    gmm = run_tfeacat(d, best, j("gmm_cuda"), "--GMMBYPASS=TRUE")
    check(all(np.isfinite(a).all() and (a >= 0).all() for a in gmm.values()),
          "tfeacat --GMMBYPASS output not finite")

    # tnorm of the transform's output on cuda:0 and on the CPU (float64 sums
    # of f32 rows): the mean (-bias) within 1e-5 of the output's standard
    # deviation (1/window) -- the transform already normalises, so the mean
    # is a near-zero sum and its relative change means nothing -- and the
    # window within 1e-5 relative
    t0 = time.perf_counter()
    (bias, window) = run_tnorm(d, j("norm_cuda"))
    norm_s = time.perf_counter() - t0
    (bias_c, window_c) = run_tnorm(d, j("norm_cpu"), device="cpu")
    check(np.isfinite(bias).all() and np.isfinite(window).all() and (window > 0).all(),
          "tnorm output not finite")
    d_mean = float((np.abs(bias - bias_c) * window_c).max())
    d_window = float((np.abs(window - window_c) / window_c).max())
    log(f"tnorm over {n['train']} frames: cuda:0 {norm_s:.2f}s; cuda vs cpu: mean "
        f"differs by {d_mean:.3e} std, window by {d_window:.3e} relative (max|bias| "
        f"{np.abs(bias).max():.3e}, window {window.min():.4g}..{window.max():.4g})")
    check(d_mean <= 1e-5 and d_window <= 1e-5,
          f"tnorm cpu/cuda differ: mean by {d_mean} std, window by {d_window}")
    return launches


# ---------------------------------------------------------------------------
# 7. objectives and tags: MSE, BlockSoftmax, confusion, L1 SparseLinearity
# ---------------------------------------------------------------------------

def objectives_path(torch, card: str, d: str, n: dict):
    """tnet on phase 4's corpus with -O mse, a BlockSoftmax head, a
    confusion-mode CV and an L1 SparseLinearity model, each run on cuda:0
    with its exact wrapper launch counts; the MSE and BlockSoftmax epochs
    again on the CPU; tfeacat of the BlockSoftmax model on both."""
    import numpy as np

    from nnet_asr_torch.models.network import Network

    def j(name: str) -> str:
        return os.path.join(d, name)

    train = ("-S", j("train.scp"))
    cv = ("-S", j("cv.scp"), "-c")
    with open(j("init.mmf")) as f:
        init = f.read()
    with open(j("block.mmf"), "w") as f:      # BlockSoftmax (90, 45) head
        f.write(init.replace(f"<softmax> {CLASSES} {CLASSES}",
                             f"<blocksoftmax> {CLASSES} {CLASSES}\nv 2\n90 45"))
    with open(j("sparse.mmf"), "w") as f:     # the hidden affine as SparseLinearity
        f.write(init.replace("<biasedlinearity>", "<sparselinearity>", 1))
    n_train = drained_frames(n["train"], CACHE, BUNCH)
    n_cv = drained_frames(n["cv"], CACHE, BUNCH)
    totals = {"matmul_act": 0, "matmul_act_f32_cp_wgmma": 0, "softmax_xent": 0}

    def counted(what, frames, fused, *args):
        """A cuda:0 tnet run; affine_sigmoid launches once a drained bunch
        on the f32 CP_WGMMA route (none for a SparseLinearity pair),
        fused_softmax_xent once a bunch only where ``fused``."""
        zero_counts()
        r = run_tnet(d, *args)
        got = {k: v for k, v in read_counts().items() if k in totals}
        want = {"matmul_act": 0 if fused else frames // BUNCH,
                "matmul_act_f32_cp_wgmma": 0 if fused else frames // BUNCH,
                "softmax_xent": frames // BUNCH if fused else 0}
        log(f"tnet cuda:0 {what}: {'Xent' if r['acc'] is not None else 'Mse'} "
            f"{r['xent']:.10g} frames {r['frames']} correct {r['acc']} FPS {r['fps']}; "
            f"launches {json.dumps(got)}")
        check(r["frames"] == frames, f"{what}: {r['frames']} frames, want {frames}")
        check(math.isfinite(r["xent"]), f"{what}: not finite")
        check(got == want, f"{what}: launches {got}, want {want}")
        for k in totals:
            totals[k] += got[k]
        return r

    mse_cv0 = counted("-O mse cv init", n_cv, False, j("init.mmf"), *cv, "-O", "mse")
    mse_e1 = counted("-O mse epoch 1", n_train, False, j("init.mmf"), *train, "-O", "mse",
                     f"--TARGETMMF={j('mse1.mmf')}")
    mse_cv1 = counted("-O mse cv epoch 1", n_cv, False, j("mse1.mmf"), *cv, "-O", "mse")
    check("Objective function: Mse" in mse_e1["log"], "no 'Objective function: Mse' line")
    check(mse_cv1["xent"] < mse_cv0["xent"],
          f"-O mse: cv Mse did not fall: {mse_cv0['xent']} -> {mse_cv1['xent']}")
    blk_cv0 = counted("BlockSoftmax(90,45) cv init", n_cv, False, j("block.mmf"), *cv)
    blk_e1 = counted("BlockSoftmax(90,45) epoch 1", n_train, False, j("block.mmf"), *train,
                     f"--TARGETMMF={j('block1.mmf')}")
    blk_cv1 = counted("BlockSoftmax(90,45) cv epoch 1", n_cv, False, j("block1.mmf"), *cv)
    check(blk_cv1["acc"] > blk_cv0["acc"],
          f"BlockSoftmax: cv accuracy did not rise: {blk_cv0['acc']} -> {blk_cv1['acc']}")
    conf = counted("--CONFUSIONMODE=max cv of phase 4's epoch 2", n_cv, False, j("e2.mmf"),
                   *cv, "--CONFUSIONMODE=max")
    lines = conf["log"].splitlines()
    k = lines.index("Row:label Col:hyp")
    check(lines[k + 1] == f"m {CLASSES} {CLASSES}", "confusion matrix header")
    matrix = np.array([[float(v) for v in l.split()] for l in lines[k + 2:k + 2 + CLASSES]])
    check(matrix.shape == (CLASSES, CLASSES) and matrix.sum() == n_cv,
          f"confusion matrix {matrix.shape} sums to {matrix.sum()}, not {n_cv} cv frames")
    diag = int(np.trace(matrix))
    check(diag == round(conf["acc"] * n_cv / 100.0), "confusion diagonal != correct frames")
    per_class = [l for l in lines[k + 2 + CLASSES:] if "%" in l and l.endswith("]")]
    check(len(per_class) == CLASSES and per_class[0].split()[0] == "s0",
          f"{len(per_class)} per-class confusion lines")
    log(f"confusion max: {CLASSES}x{CLASSES} matrix sums to {int(matrix.sum())} cv frames, "
        f"diagonal {diag}; {len(per_class)} per-class lines, first: {per_class[0].strip()}")
    l1 = counted("SparseLinearity --L1=1e-5 epoch 1", n_train, True, j("sparse.mmf"), *train,
                 "--L1=1e-5", f"--TARGETMMF={j('sparse1.mmf')}")
    sparse = Network.read(j("sparse1.mmf")).layers[0]
    zeros = int((sparse.mask == 0).sum())
    check(sparse.tag == "<sparselinearity>" and zeros > 0,
          f"written SparseLinearity mask holds no zeros ({sparse.tag})")
    log(f"L1 epoch: written mask prunes {zeros} of {sparse.mask.numel()} weights "
        f"(Xent {l1['xent']:.10g}, correct {l1['acc']}%)")

    # the MSE and BlockSoftmax epochs again on the CPU (plain versions)
    for what, e, src, mmf, extra in (("-O mse epoch 1", mse_e1, "init.mmf", "mse1.mmf",
                                      ("-O", "mse")),
                                     ("BlockSoftmax epoch 1", blk_e1, "block.mmf",
                                      "block1.mmf", ())):
        t0 = time.perf_counter()
        c = run_tnet(d, j(src), *train, *extra, f"--TARGETMMF={j('cpu_' + mmf)}", device="cpu")
        check_cpu_epoch(what, c, e, j("cpu_" + mmf), j(mmf), time.perf_counter() - t0)

    # posteriors of the trained BlockSoftmax model: cuda:0 against the CPU
    # within 1e-4 (logits differ by f32 summation order), each span's
    # posteriors summing to 1 within 1e-4
    post = run_tfeacat(d, j("block1.mmf"), j("blk_cuda"))
    post_cpu = run_tfeacat(d, j("block1.mmf"), j("blk_cpu"), device="cpu")
    check(sorted(post) == sorted(post_cpu) and sum(a.shape[0] for a in post.values()) == n["cv"],
          "tfeacat BlockSoftmax files or frames")
    diff = max(float(np.abs(post[f] - post_cpu[f]).max()) for f in post)
    span_err = max(float(np.abs(a[:, s].astype(np.float64).sum(1) - 1).max())
                   for a in post.values() for s in (slice(0, 90), slice(90, CLASSES)))
    log(f"tfeacat BlockSoftmax model, {len(post)} cv files: max|p_cuda - p_cpu| {diff:.3e}; "
        f"max|sum(p over a span) - 1| {span_err:.3e}")
    check(diff <= 1e-4, f"tfeacat BlockSoftmax cpu/cuda differ by {diff}")
    check(span_err <= 1e-4, f"BlockSoftmax spans do not sum to 1: {span_err}")
    log(f"objectives-path launches (8 tnet runs on cuda:0): {json.dumps(totals)}")
    return totals


# ---------------------------------------------------------------------------
# 8. compute dtypes: tnet --COMPUTEDTYPE, scheduler --compute-dtype,
#    tfeacat --BF16/--INT8
# ---------------------------------------------------------------------------

COUNTERS = ("matmul_act", "matmul_act_f32_wgmma", "matmul_act_f32_cp_wgmma", "matmul_act_bf16",
            "matmul_act_bf16_wgmma", "matmul_act_bf16_cp_wgmma", "wgrad_momentum_update",
            "wgrad_momentum_update_f32_wgmma", "wgrad_momentum_update_f32_cp_wgmma",
            "wgrad_momentum_update_f32_ws_wgmma", "wgrad_momentum_update_bf16",
            "wgrad_momentum_update_bf16_wgmma", "wgrad_momentum_update_bf16_cp_wgmma",
            "softmax_xent", "dgrad")


def _counters():
    """(wrapper, attribute) of each launch counter, by name."""
    from nnet_asr_torch.ops.kernels import matmul_act as MA
    from nnet_asr_torch.ops.kernels import sgd_fused as SF
    from nnet_asr_torch.ops.kernels import softmax_ce as SC

    return {"matmul_act": (MA.matmul_act, "launches"),
            "matmul_act_f32_wgmma": (MA.matmul_act, "launches_f32_wgmma"),
            "matmul_act_f32_cp_wgmma": (MA.matmul_act, "launches_f32_cp_wgmma"),
            "matmul_act_bf16": (MA.matmul_act, "launches_bf16"),
            "matmul_act_bf16_wgmma": (MA.matmul_act, "launches_bf16_wgmma"),
            "matmul_act_bf16_cp_wgmma": (MA.matmul_act, "launches_bf16_cp_wgmma"),
            "wgrad_momentum_update": (SF.wgrad_momentum_update, "launches"),
            "wgrad_momentum_update_f32_wgmma": (SF.wgrad_momentum_update, "launches_f32_wgmma"),
            "wgrad_momentum_update_f32_cp_wgmma": (SF.wgrad_momentum_update,
                                                   "launches_f32_cp_wgmma"),
            "wgrad_momentum_update_f32_ws_wgmma": (SF.wgrad_momentum_update,
                                                   "launches_f32_ws_wgmma"),
            "wgrad_momentum_update_bf16": (SF.wgrad_momentum_update, "launches_bf16"),
            "wgrad_momentum_update_bf16_wgmma": (SF.wgrad_momentum_update,
                                                 "launches_bf16_wgmma"),
            "wgrad_momentum_update_bf16_cp_wgmma": (SF.wgrad_momentum_update,
                                                    "launches_bf16_cp_wgmma"),
            "softmax_xent": (SC.softmax_xent, "launches"),
            "dgrad": (MA.dgrad, "launches")}


def _graph_launches() -> dict:
    """The Trainer's own count of the launches of steps replayed from CUDA
    graphs: "captured" (the wrappers counted them, nothing ran) and
    "replayed" (they ran, no wrapper was called), by "<wrapper>.<counter>"."""
    from nnet_asr_torch.train.trainer import GRAPH_LAUNCHES

    return GRAPH_LAUNCHES


def zero_counts():
    for f, k in _counters().values():
        setattr(f, k, 0)
    for c in _graph_launches().values():
        c.clear()


def read_counts() -> dict:
    """The launches that ran, by counter: each wrapper's own count, less
    the launches captures recorded, plus those graph replays made."""
    g = _graph_launches()
    return {name: getattr(f, k) - g["captured"][f"{f.__name__}.{k}"]
            + g["replayed"][f"{f.__name__}.{k}"] for name, (f, k) in _counters().items()}


def compare_posteriors(what, post, post_cpu, tol):
    """cuda:0 against the CPU: every frame within 5e-2 (the JAX package's
    bound of a reduced-precision dump against f32), at most 1% of the frames
    beyond ``tol`` (a rounding or quantum that flips on a near-tie under
    another summation order moves a whole frame), the argmax equal on 99%."""
    import numpy as np

    check(sorted(post) == sorted(post_cpu), f"{what}: files differ")
    a = np.concatenate([post[f] for f in sorted(post)])
    b = np.concatenate([post_cpu[f] for f in sorted(post)])
    per_frame = np.abs(a - b).max(axis=1)
    beyond = float((per_frame > tol).mean())
    agree = float((a.argmax(1) == b.argmax(1)).mean())
    log(f"{what}: {a.shape[0]} frames, max|p_cuda - p_cpu| {per_frame.max():.3e}, "
        f"{beyond:.4%} of frames beyond {tol:g}, argmax equal on {agree:.4%}")
    check(np.isfinite(a).all() and per_frame.max() < 5e-2 and beyond <= 0.01
          and agree >= 0.99, f"{what}: cuda/cpu posteriors differ")


def dtypes_path(torch, card: str, d: str, n: dict):
    """tnet under each compute dtype on cuda:0 with exact launch counts per
    dtype, the bf16 and int8 epochs again on the CPU, the scheduler under
    bf16, and tfeacat --BF16/--INT8 against the CPU."""
    import glob

    from nnet_asr_torch.tools import scheduler

    def j(name: str) -> str:
        return os.path.join(d, name)

    train = ("-S", j("train.scp"))
    cv = ("-S", j("cv.scp"), "-c")
    n_train = drained_frames(n["train"], CACHE, BUNCH) // BUNCH
    n_cv = drained_frames(n["cv"], CACHE, BUNCH) // BUNCH
    totals = dict.fromkeys(COUNTERS, 0)

    def counted(what, bunches, extra_want, *args):
        """A cuda:0 tnet run: fused_softmax_xent once a bunch, and the
        launches in ``extra_want``, nothing else."""
        zero_counts()
        r = run_tnet(d, *args)
        got = read_counts()
        want = dict.fromkeys(COUNTERS, 0)
        want["softmax_xent"] = bunches
        want.update(extra_want)
        log(f"tnet cuda:0 {what}: Xent {r['xent']:.10g} frames {r['frames']} correct "
            f"{r['acc']}% FPS {r['fps']}; launches {json.dumps(got)}")
        check(r["frames"] == bunches * BUNCH, f"{what}: {r['frames']} frames")
        check(math.isfinite(r["xent"]), f"{what}: not finite")
        check(got == want, f"{what}: launches {got}, want {want}")
        for k in totals:
            totals[k] += got[k]
        return r

    cv0 = run_tnet(d, j("init.mmf"), *cv)           # f32, not counted
    runs = {}
    for dt in DTYPES:
        flag = f"--COMPUTEDTYPE={dt}"
        bf = dt == "bf16"
        # bf16: every bunch's 960x598->1024 forward on the CP_WGMMA route
        e = counted(f"{flag} epoch 1", n_train, {"matmul_act_bf16": n_train,
                                                 "matmul_act_bf16_cp_wgmma": n_train} if bf else {},
                    j("init.mmf"), *train, flag, f"--TARGETMMF={j(dt + '.mmf')}")
        c = counted(f"{flag} cv", n_cv, {"matmul_act_bf16": n_cv,
                                         "matmul_act_bf16_cp_wgmma": n_cv} if bf else {},
                    j(dt + ".mmf"), *cv, flag)
        check(c["acc"] > cv0["acc"], f"{flag}: cv accuracy {cv0['acc']}% -> {c['acc']}%")
        runs[dt] = e
    # both of MLP3's bf16 weight gradients (598->1024, 1024->135) on the
    # CP_WGMMA route
    counted("--COMPUTEDTYPE=bf16 --MOMENTUM=0.5 epoch 1", n_train,
            {"matmul_act_bf16": n_train, "matmul_act_bf16_cp_wgmma": n_train,
             "wgrad_momentum_update_bf16": 2 * n_train,
             "wgrad_momentum_update_bf16_cp_wgmma": 2 * n_train},
            j("init.mmf"), *train, "--COMPUTEDTYPE=bf16", "--MOMENTUM=0.5",
            f"--TARGETMMF={j('bf16_mom.mmf')}")

    # the bf16 and int8 epochs again on the CPU (plain versions): Xent
    # within the tests' 1e-3 (bf16) and f32's 1e-4 (int8) relative, weights
    # within 2e-3 for both. bf16: a gradient rounding that flips between the
    # two devices' f32 sums moves a weight by the learning rate times one
    # bf16 step of it. int8: an activation quantum (max|x|/127, one scale a
    # bunch) that rounds the other way where x/s lies within f32 rounding of
    # a tie moves that frame's gradient by |dz| times the quantum
    for dt, rtol in (("bf16", 1e-3), ("int8", 1e-4)):
        t0 = time.perf_counter()
        c = run_tnet(d, j("init.mmf"), *train, f"--COMPUTEDTYPE={dt}",
                     f"--TARGETMMF={j('cpu_' + dt + '.mmf')}", device="cpu")
        check_cpu_epoch(f"--COMPUTEDTYPE={dt} epoch 1", c, runs[dt], j(f"cpu_{dt}.mmf"),
                        j(f"{dt}.mmf"), time.perf_counter() - t0, rtol=rtol, wtol=2e-3)

    # newbob under bf16 with momentum: every epoch's weights through the bf16
    # wgrad, every bunch through the bf16 affine_sigmoid
    iters = DTYPE_SCHED_ITERS
    sched = sched_argv(d, iters, j("weights_bf16"), "--compute-dtype=bf16")
    zero_counts()
    t0 = time.perf_counter()
    out = stdout_of(scheduler.main, sched)
    wall = time.perf_counter() - t0
    got = read_counts()
    best_m = re.search(r"Best model: (\S+) \(CV ([\d.]+)%, (\d+) iterations\)", out)
    init_m = re.search(r"Initial CV accuracy: (\S+)", out)
    check(best_m is not None and init_m is not None, f"scheduler output:\n{out}")
    decisions = re.findall(r"^(accepting weights|reverting the weights.*|lrate=.*)$", out, re.M)
    log(f"scheduler --compute-dtype=bf16 (momentum {MOM}, learnrate {MOM_LR}, {iters} "
        f"iterations) on cuda:0, {card}: {wall:.1f}s; CV accuracy {init_m.group(1)}% -> best "
        f"{best_m.group(2)}%; decisions {decisions}; launches {json.dumps(got)}")
    want = dict.fromkeys(COUNTERS, 0)
    want.update(matmul_act_bf16=iters * n_train + (iters + 1) * n_cv,
                matmul_act_bf16_cp_wgmma=iters * n_train + (iters + 1) * n_cv,
                wgrad_momentum_update_bf16=2 * iters * n_train,
                wgrad_momentum_update_bf16_cp_wgmma=2 * iters * n_train,
                softmax_xent=iters * n_train + (iters + 1) * n_cv)
    check(got == want, f"scheduler bf16: launches {got}, want {want}")
    check(float(best_m.group(2)) > float(init_m.group(1)), "scheduler bf16: cv did not rise")
    check(len(glob.glob(j("weights_bf16/*"))) >= 1, "scheduler bf16 wrote no model")
    for k in totals:
        totals[k] += got[k]

    # posterior dumps of phase 4's model in the inference dtypes
    for flag, name, tol in (("--BF16=TRUE", "bf16", 2e-3), ("--INT8=TRUE", "int8", 1e-5)):
        t0 = time.perf_counter()
        post = run_tfeacat(d, j("e2.mmf"), j(f"tfeacat_{name}_cuda"), flag)
        secs = time.perf_counter() - t0
        post_cpu = run_tfeacat(d, j("e2.mmf"), j(f"tfeacat_{name}_cpu"), flag, device="cpu")
        check(sum(a.shape[0] for a in post.values()) == n["cv"], f"tfeacat {flag} frames")
        compare_posteriors(f"tfeacat {flag} cuda:0 ({secs:.2f}s) vs cpu", post, post_cpu, tol)
    log(f"compute-dtype launches (12 tnet runs and the scheduler on cuda:0): "
        f"{json.dumps(totals)}")
    return totals, got


# ---------------------------------------------------------------------------
# 9. RBM pretraining: rbm_init -> trbm -> rbm2mlplayer -> netjoin -> tnet
# ---------------------------------------------------------------------------

MSE_LINE = re.compile(r"Mse:(\S+) frames:(\d+) err/frm:(\S+)")


def generate(d, name, module, argv) -> str:
    """Write what the port's ``module.main(argv)`` prints to ``d/name``."""
    path = os.path.join(d, name)
    with open(path, "w") as f:
        f.write(stdout_of(module.main, argv))
    return path


def run_trbm(d, mmf, transform, lr, seed, *extra, device=None):
    """One trbm epoch over the training part, updating ``mmf`` in place as
    the recipe does."""
    from nnet_asr_torch.tools import trbm

    argv = ["trbm", "-H", mmf, "-S", os.path.join(d, "train.scp"), f"--TARGETMMF={mmf}",
            f"--FEATURETRANSFORM={transform}", f"--STARTFRMEXT={EXT}", f"--ENDFRMEXT={EXT}",
            f"--LEARNINGRATE={lr}", "--MOMENTUM=0.5", f"--BUNCHSIZE={RBM_BUNCH}",
            f"--CACHESIZE={RBM_CACHE}", f"--SEED={seed}", *extra]
    out = stdout_of(trbm.main, argv, device=device)
    m = MSE_LINE.search(out)
    fps = re.search(r"FPS:([\d.]+)", out)
    check(m is not None and fps is not None, f"no Mse or FPS line in trbm output:\n{out}")
    return {"mse": float(m.group(1)), "frames": int(m.group(2)),
            "per_frame": float(m.group(3)), "fps": float(fps.group(1))}


def no_threshold_ties(torch, spec, params, x, noise):
    """The noise, moved 1e-4 away from the CPU's hidden probabilities where
    it lies within 1e-5 of one: a Bernoulli threshold then falls the same
    way under either device's summation order."""
    if spec.hid_type != "bern":
        return noise
    p = spec.apply(params, x)
    near = (p - noise).abs() < 1e-5
    return torch.where(near, (p - 1e-4).clamp_min(0.0), noise)


def rbm_path(torch, card: str, d: str, n: dict):
    import numpy as np

    from nnet_asr_torch.models.network import Network
    from nnet_asr_torch.tools import gen_mlp_init, generators

    def j(name: str) -> str:
        return os.path.join(d, name)

    dim = FEAT_DIM * DCT
    want_frames = drained_frames(n["train"], RBM_CACHE, RBM_BUNCH)

    def epochs(what, mmf, transform, lr, seeds, *extra):
        rs = []
        for seed in seeds:
            t0 = time.perf_counter()
            r = run_trbm(d, mmf, transform, lr, seed, *extra)
            log(f"trbm cuda:0 {what}, seed {seed}: Mse {r['mse']:.10g} frames {r['frames']} "
                f"Mse/frame {r['per_frame']:.10g} FPS {r['fps']} ({time.perf_counter() - t0:.2f}s)")
            check(r["frames"] == want_frames, f"{what}: {r['frames']} frames, want {want_frames}")
            check(math.isfinite(r["mse"]), f"{what}: Mse not finite")
            rs.append(r)
        return rs

    # layer 1: Gaussian visible units on the transformed features
    rbm1 = generate(d, "rbm1.mmf", generators, ["rbm_init", f"--dim={dim}:{RBM_HID}", "--gauss",
                                                "--vistype=gauss", "--seed=11"])
    l1 = epochs(f"layer 1 {dim}:{RBM_HID} gauss-bern", rbm1, j("transform"), 0.001, (101, 102))
    check(l1[1]["per_frame"] < l1[0]["per_frame"],
          f"layer 1 Mse/frame did not fall: {l1[0]['per_frame']} -> {l1[1]['per_frame']}")
    layer1 = generate(d, "layer1.mmf", generators, ["rbm2mlplayer", rbm1, "-"])
    transf2 = generate(d, "transf2.mmf", generators, ["netjoin", j("transform"), layer1])
    # layer 2 on layer 1's activations
    rbm2 = generate(d, "rbm2.mmf", generators, ["rbm_init", f"--dim={RBM_HID}:{RBM_HID}",
                                                "--gauss", "--seed=12"])
    l2 = epochs(f"layer 2 {RBM_HID}:{RBM_HID} bern-bern", rbm2, transf2, 0.1, (201, 202))
    layer2 = generate(d, "layer2.mmf", generators, ["rbm2mlplayer", rbm2, "-"])
    top = generate(d, "top.mmf", gen_mlp_init, [f"--dim={RBM_HID}:{CLASSES}", "--gauss",
                                                "--seed=13"])
    pre = generate(d, "pretrained.mmf", generators, ["netjoin", layer1, layer2, top])
    rnd = generate(d, "random.mmf", gen_mlp_init, [f"--dim={dim}:{RBM_HID}:{RBM_HID}:{CLASSES}",
                                                   "--gauss", "--negbias", "--seed=14"])
    net = Network.read(pre)
    check([l.tag for l in net.layers] == ["<biasedlinearity>", "<sigmoid>"] * 2
          + ["<biasedlinearity>", "<softmax>"] and (net.n_inputs, net.n_outputs) == (dim, CLASSES)
          and net.layers[2].n_inputs == RBM_HID, "the stacked net has the wrong structure")
    check(all(np.isfinite(v).all() for p in net.to_numpy_params() for v in p.values()),
          "the stacked net has non-finite weights")
    # an <rbmsparse> epoch and an --RNGIMPL=rbg epoch
    sparse = generate(d, "rbmsparse.mmf", generators, [
        "rbm_init", f"--dim={dim}:{RBM_HID}", "--gauss", "--vistype=gauss", "--sparsitycost=1e-4",
        "--seed=15"])
    with open(sparse) as f:
        check(f.read(12).startswith("<rbmsparse>"), "rbm_init --sparsitycost wrote no <rbmsparse>")
    epochs("<rbmsparse> --sparsitycost=1e-4", sparse, j("transform"), 0.001, (301,))
    rbg = generate(d, "rbm_rbg.mmf", generators, ["rbm_init", f"--dim={dim}:{RBM_HID}", "--gauss",
                                                  "--vistype=gauss", "--seed=11"])
    epochs("layer 1 --RNGIMPL=rbg", rbg, j("transform"), 0.001, (101,), "--RNGIMPL=rbg")

    # the CE fine-tune through the kernels, beside the random init
    n_train = drained_frames(n["train"], CACHE, BUNCH) // BUNCH
    n_cv = drained_frames(n["cv"], CACHE, BUNCH) // BUNCH
    totals = dict.fromkeys(COUNTERS, 0)

    def counted(what, bunches, *args):
        """A cuda:0 tnet run: affine_sigmoid twice a bunch (two
        BL->Sigmoid pairs), fused_softmax_xent once, nothing else."""
        zero_counts()
        r = run_tnet(d, *args)
        got = read_counts()
        want = dict.fromkeys(COUNTERS, 0)
        want.update(matmul_act=2 * bunches, matmul_act_f32_cp_wgmma=2 * bunches,
                    softmax_xent=bunches)
        log(f"tnet cuda:0 {what}: Xent {r['xent']:.10g} frames {r['frames']} correct "
            f"{r['acc']}% FPS {r['fps']}; launches {json.dumps(got)}")
        check(r["frames"] == bunches * BUNCH and math.isfinite(r["xent"]), f"{what}: frames/Xent")
        check(got == want, f"{what}: launches {got}, want {want}")
        for k in totals:
            totals[k] += got[k]
        return r

    train, cv = ("-S", j("train.scp")), ("-S", j("cv.scp"), "-c")
    cv_rnd0 = counted("cv random init 598->1024->1024->135", n_cv, rnd, *cv)
    counted("epoch 1 pretrained", n_train, pre, *train, f"--TARGETMMF={j('pre1.mmf')}")
    cv_pre1 = counted("cv pretrained epoch 1", n_cv, j("pre1.mmf"), *cv)
    counted("epoch 1 random init", n_train, rnd, *train, f"--TARGETMMF={j('rnd1.mmf')}")
    cv_rnd1 = counted("cv random-init epoch 1", n_cv, j("rnd1.mmf"), *cv)
    log(f"RBM recipe on {card}: cv accuracy random init {cv_rnd0['acc']}%, after one CE epoch: "
        f"pretrained {cv_pre1['acc']}%, random init {cv_rnd1['acc']}%; layer 2 Mse/frame "
        f"{l2[0]['per_frame']:.6g} -> {l2[1]['per_frame']:.6g}")
    check(cv_pre1["acc"] > cv_rnd0["acc"], f"cv accuracy of the fine-tuned pretrained net "
          f"{cv_pre1['acc']}% not above the random init's {cv_rnd0['acc']}%")
    log(f"RBM fine-tune launches (5 tnet runs on cuda:0): {json.dumps(totals)}")
    return totals


def cd1_agreement(torch, dev):
    """One CD-1 step, 598->1024 Gaussian-Bernoulli at bunch 256, on cuda:0
    and on the CPU with the same injected noise: every tensor within rtol
    1e-4 and 1e-4 of its largest value (f32 GEMMs in two summation orders)."""
    from nnet_asr_torch.models.components import Rbm
    from nnet_asr_torch.train import rbm as R

    gen = torch.Generator().manual_seed(31)
    V, H, B = FEAT_DIM * DCT, RBM_HID, RBM_BUNCH
    spec = Rbm(V, H, vis_type="gauss", hid_type="bern")
    p = {"weight": 0.1 * torch.randn((V, H), generator=gen), "vis_bias": torch.zeros(V),
         "hid_bias": 0.1 * torch.randn((H,), generator=gen)}
    x = torch.randn((B, V), generator=gen)
    noise = no_threshold_ties(torch, spec, p, x, R.hidden_noise(spec, gen, (B, H)))
    cfg = R.RbmTrainConfig(learning_rate=0.001)
    out = []
    for d in (dev, torch.device("cpu")):
        params = {k: v.to(d, copy=True) for k, v in p.items()}
        state = R.init_rbm_state(spec, params, cfg)
        mse = R.cd1_step(spec, cfg, params, state, x.to(d), noise=noise.to(d))
        out.append({k: v.cpu() for k, v in {**params, **state, "mse": mse}.items()})
    worst = 0.0
    for k, c in out[1].items():
        g = out[0][k]
        tol = 1e-4 * (c.abs() + c.abs().max())
        err = float(((g - c).abs() / (c.abs() + c.abs().max()).clamp_min(1e-30)).max())
        worst = max(worst, err)
        check(bool(((g - c).abs() <= tol).all()), f"CD-1 cuda vs cpu: {k} differs ({err:.2e})")
    log(f"CD-1 step {V}->{H} gauss-bern bunch {B}, injected noise: cuda:0 vs CPU max "
        f"|d|/(|cpu| + max|cpu|) {worst:.2e} over params, corrections and Mse")


def time_cd1(torch, dev, card):
    """The CD-1 step by CUDA events and by a profiler window, at each shape
    and bunch: us a step, frames/s, TFLOP/s of the 5 GEMMs (5*2*V*H*B) beside
    the bound at 165 TFLOP/s and the bytes at 3.35 TB/s."""
    from nnet_asr_torch.models.components import Rbm
    from nnet_asr_torch.train import rbm as R

    for V, H, vt, ht in CD1_SHAPES:
        for B in CD1_BUNCHES:
            gen = torch.Generator(device=dev).manual_seed(V + B)
            spec = Rbm(V, H, vis_type=vt, hid_type=ht)
            params = {"weight": 0.05 * torch.randn((V, H), generator=gen, device=dev),
                      "vis_bias": torch.zeros(V, device=dev),
                      "hid_bias": torch.zeros(H, device=dev)}
            x = torch.randn((B, V), generator=gen, device=dev)
            if vt == "bern":
                x = (x > 0).float()
            cfg = R.RbmTrainConfig(learning_rate=1e-4)
            state = R.init_rbm_state(spec, params, cfg)

            def step():
                R.cd1_step(spec, cfg, params, state, x, gen)

            ms = cuda_ms(torch, step, reps=30, warmup=5)
            rows, wall_us, _ = profile_window(torch, step, n_steps=10)
            busy = sum(us for _, us, _ in rows)
            flops = 5 * 2.0 * V * H * B
            # x read; W and its correction read and written; the vectors
            nbytes = 4.0 * (B * V + 4 * V * H + 4 * (V + H))
            b_us, by = bound_us(flops, nbytes, PEAK_3XTF32)
            groups = group_times(rows, STEP_GROUPS, "elementwise and update passes")
            log(f"CD-1 {V}->{H} {vt}-{ht} bunch {B}, {card}: {ms * 1e3:.1f} us a step by events "
                f"= {B / (ms * 1e-3):.0f} frames/s = {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s over "
                f"the 5 GEMMs ({flops / 1e9:.3f} GFLOP); bound {b_us:.2f} us ({by}; 165 TFLOP/s "
                f"3xTF32, {nbytes / HBM_BYTES_S * 1e6:.2f} us of bytes at 3.35 TB/s); "
                + (split_line(busy, wall_us, groups) if busy > 0 else "no device time recorded"))


# ---------------------------------------------------------------------------
# 10. recurrent BPTT: recurrent_init -> trecurrent (segments, frame-serial)
# ---------------------------------------------------------------------------

def run_trecurrent(d, src, scp, *extra, device=None):
    """One trecurrent run over ``scp``: Xent, frames, accuracy, FPS."""
    from nnet_asr_torch.tools import trecurrent

    argv = ["trec", "-H", src, "-I", os.path.join(d, "labs.mlf"), "-L", "*/", "-X", "lab",
            "-S", scp, "-m", os.path.join(d, "map"), "-n", repr(REC_LR), f"--BPTT={REC_BPTT}",
            f"--FEATURETRANSFORM={os.path.join(d, 'transform')}", f"--STARTFRMEXT={EXT}",
            f"--ENDFRMEXT={EXT}", *extra]
    t0 = time.perf_counter()
    out = stdout_of(trecurrent.main, argv, device=device)
    m = XENT.search(out)
    fps = re.search(r"FPS:([\d.]+)", out)
    check(m is not None and fps is not None, f"no Xent or FPS line in trecurrent output:\n{out}")
    return {"xent": float(m.group(1)), "frames": int(m.group(2)), "acc": float(m.group(3)),
            "fps": float(fps.group(1)), "seconds": time.perf_counter() - t0}


def recurrent_path(torch, dev, card: str, d: str, n: dict):
    from nnet_asr_torch.models.network import Network
    from nnet_asr_torch.tools import gen_mlp_init, generators

    def j(name: str) -> str:
        return os.path.join(d, name)

    dim = FEAT_DIM * DCT
    rec = generate(d, "rec_layer.mmf", generators, ["recurrent_init", f"--dim={dim}:{REC_HID}",
                                                    "--gauss", "--seed=21"])
    top = generate(d, "rec_top.mmf", gen_mlp_init, [f"--dim={REC_HID}:{CLASSES}", "--gauss",
                                                    "--seed=22"])
    init = generate(d, "rec_init.mmf", generators, ["netjoin", rec, top])
    net = Network.read(init)
    check([l.tag for l in net.layers] == ["<recurrent>", "<biasedlinearity>", "<softmax>"]
          and tuple(net.layers[0].weight.shape) == (dim + REC_HID, REC_HID),
          "the recurrent net has the wrong structure")

    def logged(what, r):
        log(f"trecurrent {what}: Xent {r['xent']:.10g} frames {r['frames']} correct "
            f"{r['acc']:.4f}% FPS {r['fps']} ({r['seconds']:.2f}s)")
        check(math.isfinite(r["xent"]), f"trecurrent {what}: Xent not finite")
        return r

    cv0 = logged("cuda:0 cv init", run_trecurrent(d, init, j("cv.scp"), "-c"))
    e1 = logged(f"cuda:0 epoch 1 (--BPTT={REC_BPTT}, {dim}->rec {REC_HID}->{CLASSES})",
                run_trecurrent(d, init, j("train.scp"), f"--TARGETMMF={j('rec1.mmf')}"))
    cv1 = logged("cuda:0 cv epoch 1", run_trecurrent(d, j("rec1.mmf"), j("cv.scp"), "-c"))
    check(e1["frames"] == n["train"] and cv0["frames"] == cv1["frames"] == n["cv"],
          "trecurrent frame counts")
    check(cv1["acc"] > cv0["acc"], f"trecurrent: cv accuracy {cv0['acc']}% -> {cv1['acc']}%")

    # the epoch's first utterances, and frame-serial training, on the CPU too
    with open(j("train.scp")) as f:
        scp = f.read().split()
    for what, k, extra in ((f"epoch over the first {REC_CPU_UTTS} utterances", REC_CPU_UTTS, ()),
                           (f"--FRAMESERIAL=TRUE over the first {REC_SERIAL_UTTS} utterances",
                            REC_SERIAL_UTTS, ("--FRAMESERIAL=TRUE",))):
        sub = j(f"rec_first{k}.scp")
        with open(sub, "w") as f:
            f.write("".join(p + "\n" for p in scp[:k]))
        tag = "serial" if extra else "sub"
        g = logged(f"cuda:0 {what}", run_trecurrent(d, init, sub, *extra,
                                                     f"--TARGETMMF={j(f'rec_{tag}_cuda.mmf')}"))
        c = logged(f"cpu {what}", run_trecurrent(d, init, sub, *extra,
                                                  f"--TARGETMMF={j(f'rec_{tag}_cpu.mmf')}",
                                                  device="cpu"))
        check_cpu_epoch(f"trecurrent {what}", c, g, j(f"rec_{tag}_cpu.mmf"),
                        j(f"rec_{tag}_cuda.mmf"), c["seconds"])
    time_bptt(torch, dev, card)


def roofline_params(rng):
    """scripts/recurrent_roofline.py's stack's parameters, 0.05 N(0, 1)."""
    import numpy as np

    din, dr, dout = ROOFLINE_DIMS
    return [{"weight": (0.05 * rng.standard_normal((din, dr))).astype(np.float32),
             "bias": np.zeros(dr, np.float32)}, {},
            {"weight": (0.05 * rng.standard_normal((2 * dr, dr))).astype(np.float32),
             "bias": np.zeros(dr, np.float32)},
            {"weight": (0.05 * rng.standard_normal((dr, dout))).astype(np.float32),
             "bias": np.zeros(dout, np.float32)}, {}]


def roofline_network(params):
    from nnet_asr_torch.models.components import BiasedLinearity, Recurrent, Sigmoid, Softmax
    from nnet_asr_torch.models.network import Network

    din, dr, dout = ROOFLINE_DIMS
    return Network([BiasedLinearity(din, dr), Sigmoid(dr, dr), Recurrent(dr, dr),
                    BiasedLinearity(dr, dout), Softmax(dout, dout)]).from_numpy_params(params)


def time_bptt(torch, dev, card):
    """RecurrentTrainer.train_batch on scripts/recurrent_roofline.py's stack
    by CUDA events and a profiler window: ms a batch, frames/s, idle share."""
    import numpy as np

    from nnet_asr_torch.train.recurrent import RecurrentTrainer, RecurrentTrainerConfig
    from nnet_asr_torch.train.sgd import SgdConfig

    din, dr, dout = ROOFLINE_DIMS
    T = ROOFLINE_T
    rng = np.random.default_rng(1)
    params = roofline_params(rng)
    for B in ROOFLINE_BATCHES:
        net = roofline_network(params)
        tr = RecurrentTrainer(net, RecurrentTrainerConfig(
            bptt_order=REC_BPTT, sgd=SgdConfig(learning_rate=0.01)), device=dev)
        feats = [torch.from_numpy((0.3 * rng.standard_normal((T, din))).astype(np.float32)).to(dev)
                 for _ in range(B)]
        labels = [rng.integers(0, dout, T) for _ in range(B)]

        def step():
            tr.train_batch(feats, labels)

        ms = cuda_ms(torch, step, reps=3, warmup=1)
        rows, wall_us, _ = profile_window(torch, step, n_steps=1)
        busy = sum(us for _, us, _ in rows)
        groups = group_times(rows, STEP_GROUPS, "elementwise and update passes")
        log(f"BPTT batch {din}->{dr}->rec {dr}->{dout}, K {REC_BPTT}, T {T}, B {B} "
            f"({T // REC_BPTT} segment steps), {card}: {ms:.2f} ms a batch by events = "
            f"{B * T / (ms * 1e-3):.0f} frames/s; "
            + (split_line(busy, wall_us, groups) if busy > 0 else "no device time recorded"))
        check(math.isfinite(tr.stats.error), "BPTT batch stats not finite")


# ---------------------------------------------------------------------------
# 11. MPE/MMI sequence training: tnet -> tmpe (native and device engines)
# ---------------------------------------------------------------------------

MPE_LINE = re.compile(r"Avg MPE accuracy: (\S+) utts: (\d+)")
MPE_TIMES = re.compile(r"T-read: (\S+)s T-fwd: (\S+)s T-decode: (\S+)s T-update: (\S+)s")


def tmpe_argv(d, src, scp, *extra, lr=MPE_LR):
    """tmpe's arguments for phase 11's corpus (scripts/mpe_example01.sh's
    kappa, and its learning rate unless ``lr`` is given)."""
    return ["tmpe", "-H", src, "-I", os.path.join(d, "labs.mlf"), "-L", "*/", "-X", "lab",
            "-m", os.path.join(d, "map"), "-S", scp, f"--HMM={os.path.join(d, 'hmms.mmf')}",
            f"--LATTICEDIR={os.path.join(d, 'lats')}",
            f"--FEATURETRANSFORM={os.path.join(d, 'transform')}", f"--STARTFRMEXT={EXT}",
            f"--ENDFRMEXT={EXT}", f"--OUTPSCALE={MPE_KAPPA}", f"--LEARNINGRATE={lr}", *extra]


def run_tmpe(d, src, scp, *extra, device=None, lr=MPE_LR):
    """One tmpe run over ``scp``: Avg MPE accuracy, utterances, FPS, the
    time split."""
    from nnet_asr_torch.tools import tmpe

    return tmpe_result(stdout_of(tmpe.main, tmpe_argv(d, src, scp, *extra, lr=lr),
                                 device=device))


def tmpe_result(out: str) -> dict:
    m, t, fps = MPE_LINE.search(out), MPE_TIMES.search(out), re.search(r"FPS:([\d.]+)", out)
    check(m is not None and t is not None and fps is not None, f"tmpe output:\n{out}")
    return {"acc": float(m.group(1)), "utts": int(m.group(2)), "fps": float(fps.group(1)),
            "split": dict(zip(("read", "fwd", "decode", "update"), map(float, t.groups()))),
            "log": out}


def mmf_rel_diff(a_mmf, b_mmf) -> float:
    """The largest |a - b| of the two MMFs' weights over the largest |b|;
    NaN if a weight of ``a`` is not finite."""
    import numpy as np

    from nnet_asr_torch.models.network import Network

    pairs = [(a[k], b[k]) for a, b in zip(Network.read(a_mmf).to_numpy_params(),
                                          Network.read(b_mmf).to_numpy_params()) for k in a]
    if not all(np.isfinite(a).all() for a, _ in pairs):
        return math.nan
    return (max(float(np.abs(a - b).max()) for a, b in pairs)
            / max(float(np.abs(b).max()) for _, b in pairs))


def mmf_update_diff(a_mmf, b_mmf, base_mmf) -> tuple[float, float]:
    """How far the update of ``a`` (its weights less ``base``'s) is from
    ``b``'s, relative to ``b``'s update: the L2 norm of the difference over
    the norm of b's update, and the largest |difference| over b's largest
    |update|, over every weight and bias, in float64."""
    import numpy as np

    from nnet_asr_torch.models.network import Network

    def flat(mmf):
        return np.concatenate([p[k].astype(np.float64).ravel()
                               for p in Network.read(mmf).to_numpy_params() for k in sorted(p)])

    base = flat(base_mmf)
    da, db = flat(a_mmf) - base, flat(b_mmf) - base
    check(np.isfinite(da).all() and np.abs(db).max() > 0, f"{a_mmf}/{b_mmf}: the updates")
    return (float(np.linalg.norm(da - db) / np.linalg.norm(db)),
            float(np.abs(da - db).max() / np.abs(db).max()))


def mpe_path(torch, dev, card: str, d: str):
    """tmpe on a phone-structured corpus at MLP3's widths: the CE model of
    one tnet epoch, -c, one MPE iteration, -c, an --MMI and a
    --DELAYEDUPDATE iteration, each with exact affine_sigmoid launches; the
    device engine against the native one on the same card log-posteriors;
    the first utterances again on the CPU, their update held against the
    card's; affine_sigmoid against its plain version at one utterance's
    rows. Returns the path's launch counts and that shape's record."""
    import numpy as np

    from nnet_asr_torch.io.htk_hmm import parse_mmf
    from nnet_asr_torch.io.labels import LabelRepository
    from nnet_asr_torch.io.slf import LatticeArchive
    from nnet_asr_torch.models.network import Network
    from nnet_asr_torch.tools import gen_gmmbypass
    from nnet_asr_torch.tools.synth_corpus import CorpusShape, make_corpus, write_phone_lattices
    from nnet_asr_torch.train.mpe import MpeComputer, MpeConfig, labels_to_phone_segments

    def j(name: str) -> str:
        return os.path.join(d, name)

    t0 = time.perf_counter()
    n = make_corpus(d, CorpusShape(phones=MPE_PHONES), seed=SEED)
    lats = write_phone_lattices(d, seed=SEED)
    stdout_of(gen_gmmbypass.main, [j("map"), j("hmms.mmf"), "--state-sep=_s"])
    hmms = parse_mmf(j("hmms.mmf"))
    check(len(hmms) == MPE_PHONES and all(h.n_emitting == 3 for h in hmms.values()),
          "gen_gmmbypass: the HMM set")
    log(f"phase 11 corpus: {n['train']} training frames, {n['cv']} cv frames, "
        f"{lats['lattices']} lattices of {lats['arcs']} phone arcs, {len(hmms)} 3-state HMMs "
        f"({time.perf_counter() - t0:.1f}s to make)")
    ce = run_tnet(d, j("init.mmf"), "-S", j("train.scp"), f"--TARGETMMF={j('ce1.mmf')}")
    log(f"tnet cuda:0 CE epoch (phase 11 corpus): Xent {ce['xent']:.10g} correct {ce['acc']}% "
        f"FPS {ce['fps']}")
    with open(j("train.scp")) as f:
        n_utts = len(f.read().split())

    # the main path: every count from 0 here, read after the last tmpe run
    train = j("train.scp")
    runs = {}
    zero_counts()
    for name, src, extra in (("-c, CE model", j("ce1.mmf"), ("-c",)),
                             ("MPE iteration 1", j("ce1.mmf"), (f"--TARGETMMF={j('mpe1.mmf')}",)),
                             ("-c, MPE iteration 1", j("mpe1.mmf"), ("-c",)),
                             ("--MMI iteration", j("ce1.mmf"),
                              ("--MMI=TRUE", f"--TARGETMMF={j('mmi1.mmf')}")),
                             ("--DELAYEDUPDATE iteration", j("ce1.mmf"),
                              ("--DELAYEDUPDATE=TRUE", f"--TARGETMMF={j('del1.mmf')}"))):
        r = runs[name] = run_tmpe(d, src, train, "--MPEENGINE=native", *extra)
        log(f"tmpe cuda:0 {name} (native engine): Avg MPE accuracy {r['acc']:.6g} utts "
            f"{r['utts']} FPS {r['fps']} T-read {r['split']['read']:.2f}s T-fwd "
            f"{r['split']['fwd']:.2f}s T-decode {r['split']['decode']:.2f}s T-update "
            f"{r['split']['update']:.2f}s")
        check(r["utts"] == n_utts and math.isfinite(r["acc"]), f"tmpe {name}: utts/accuracy")
    got = read_counts()
    # one forward an utterance under -c, two (forward, then the update's) in training
    want = dict.fromkeys(COUNTERS, 0)
    want["matmul_act"] = want["matmul_act_f32_cp_wgmma"] = n_utts * (1 + 2 + 1 + 2 + 2)
    log(f"MPE path launches (5 tmpe runs on cuda:0, {n_utts} utterances each): {json.dumps(got)}")
    check(got == want, f"MPE path launches {got}, want {want}")
    log(f"MPE on {card}: Avg MPE accuracy (training set) {runs['-c, CE model']['acc']:.6g} "
        f"before, {runs['-c, MPE iteration 1']['acc']:.6g} after one iteration")
    for mmf in ("mpe1.mmf", "mmi1.mmf", "del1.mmf"):
        moved = mmf_rel_diff(j(mmf), j("ce1.mmf"))
        log(f"{mmf}: max|w - w_ce| / max|w_ce| = {moved:.3e}")
        check(0 < moved < 1, f"{mmf}: the update moved the weights by {moved} of their scale")
    # where an MPE iteration's wall goes: a profiler window over one more
    # (no model written), after a warm-up run
    rows, wall_us, _ = profile_window(
        torch, lambda: run_tmpe(d, j("ce1.mmf"), train, "--MPEENGINE=native"), n_steps=1)
    busy = sum(us for _, us, _ in rows)
    log(f"tmpe MPE iteration, {n_utts} utterances, {card}: "
        + (split_line(busy, wall_us, group_times(rows, MPE_GROUPS, "elementwise and update passes"))
           if busy > 0 else "no device time recorded"))

    # the device engine against the native one on the same card log-posteriors
    lp = run_tfeacat(d, j("mpe1.mmf"), j("lpost_mpe"), "--LOGPOSTERIOR=TRUE")
    # tmpe forwards one utterance at a time: the kernel at such a ragged row count
    rows = lp[sorted(lp)[0]].shape[0]
    k, n = Network.read(j("mpe1.mmf")).to_numpy_params()[0]["weight"].shape
    # (timed by the profiler in phase 3, at 284x598->1024: here, after the
    # scheduled window above, a profiler window records no device time)
    ragged = check_matmul_act(torch, dev, rows, k, n, seed=rows, profiled=False)
    repo = LabelRepository(j("labs.mlf"), j("map"), "*/", "lab")
    names = [None] * repo.n_outputs
    for tag, i in repo.label_map.items():
        names[i] = tag
    archive = LatticeArchive(j("lats"))
    cfg = MpeConfig(outprb_scale=MPE_KAPPA)
    native = MpeComputer(hmms, repo.label_map, cfg, engine="native")
    device = MpeComputer(hmms, repo.label_map, cfg, engine="jax", device=dev)
    check(native._native is not None, "the native MPE engine did not build")
    utts = []
    for f in sorted(lp)[:MPE_CHECK_UTTS]:
        post = lp[f].astype(np.float32)
        logical = os.path.splitext(f)[0] + ".fea"
        segs = labels_to_phone_segments(repo.get_frame_labels(post.shape[0], 100000, logical),
                                        names)
        utts.append((archive.get(logical), post, segs))
    device.compute(*utts[0])                       # warm-up
    ms, worst = {"native": [], "jax": []}, 0.0
    for lat, post, segs in utts:
        out = {}
        for name, comp in (("native", native), ("jax", device)):
            t1 = time.perf_counter()
            out[name] = comp.compute(lat, post, segs)
            if name == "jax":
                torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t1) * 1e3)
        worst = max(worst, float(np.abs(out["jax"][0] - out["native"][0]).max()))
        check(abs(out["jax"][1] - out["native"][1]) < 1e-6, "device/native MPE accuracy")
    log(f"MPE engines on {MPE_CHECK_UTTS} cv utterances ({card}): device (torch, cuda:0) "
        f"{statistics.median(ms['jax']):.2f} ms, native {statistics.median(ms['native']):.2f} "
        f"ms an utterance (median); max|gamma_device - gamma_native| {worst:.3e}")
    check(worst <= 1e-5, f"device/native MPE gammas differ by {worst}")
    first = j("mpe_first.scp")
    with open(train) as f, open(first, "w") as g:
        g.write("".join(p + "\n" for p in f.read().split()[:MPE_CHECK_UTTS]))
    auto = run_tmpe(d, j("ce1.mmf"), first, "-c", "--MPEENGINE=auto")
    log("tmpe --MPEENGINE=auto: " + " ".join(line for line in auto["log"].splitlines()
                                            if line.startswith("[MPEENGINE auto]")))

    # the first utterances' MPE iteration on the card and on the CPU: the
    # update is ~1e-5 of the weights' scale, so the card's update is held
    # against the CPU's, and a control at half the learning rate (update
    # diff 0.5; a flipped sign gives 2) must fail the same limit
    g = run_tmpe(d, j("ce1.mmf"), first, "--MPEENGINE=native", f"--TARGETMMF={j('mpe_g.mmf')}")
    run_tmpe(d, j("ce1.mmf"), first, "--MPEENGINE=native", f"--TARGETMMF={j('mpe_h.mmf')}",
             lr=MPE_LR / 2)
    t1 = time.perf_counter()
    c = run_tmpe(d, j("ce1.mmf"), first, "--MPEENGINE=native", f"--TARGETMMF={j('mpe_c.mmf')}",
                 device="cpu")
    rel = mmf_rel_diff(j("mpe_c.mmf"), j("mpe_g.mmf"))
    upd = mmf_update_diff(j("mpe_g.mmf"), j("mpe_c.mmf"), j("ce1.mmf"))
    ctl = mmf_update_diff(j("mpe_h.mmf"), j("mpe_c.mmf"), j("ce1.mmf"))
    log(f"MPE iteration over the first {MPE_CHECK_UTTS} utterances, cpu vs cuda:0: Avg MPE "
        f"accuracy {c['acc']:.6g} vs {g['acc']:.6g}, MMF rel diff {rel:.2e}; update diff "
        f"(L2, max) {upd[0]:.3e} {upd[1]:.3e}, control at lr/2 {ctl[0]:.3e} {ctl[1]:.3e}, "
        f"limit {MPE_UPDATE_TOL:g} on L2 ({time.perf_counter() - t1:.1f}s on the CPU)")
    check(abs(c["acc"] - g["acc"]) <= 1e-4 and rel <= 1e-4, "MPE cpu/cuda disagree")
    check(upd[0] <= MPE_UPDATE_TOL, f"MPE update cpu/cuda: L2 diff {upd[0]} > {MPE_UPDATE_TOL}")
    check(ctl[0] > MPE_UPDATE_TOL, f"the update check cannot see the lr/2 control ({ctl[0]})")
    return got, ragged


# ---------------------------------------------------------------------------
# 12. resident newbob: the TIMIT-scale recipe, and phases 5 and 8 again
# ---------------------------------------------------------------------------

DONE_LINE = re.compile(r"^Done (\d+) frames in (\S+)s \[FPS:([\d.]+)", re.M)
HISTORY_LINE = re.compile(r"^(?:Initial CV|TR|CV) accuracy:.*$", re.M)
DECISION_LINE = re.compile(r"^(?:accepting weights|reverting the weights.*|lrate=.*)$", re.M)


@contextlib.contextmanager
def timed_intake(torch, intakes: list):
    """Record each ResidentNewbob and the seconds of its one-time intake."""
    from nnet_asr_torch.train.resident import ResidentNewbob

    prepare = ResidentNewbob.prepare

    def timed(self, *args, **kw):
        t0 = time.perf_counter()
        prepare(self, *args, **kw)
        torch.cuda.synchronize()
        intakes.append((self, time.perf_counter() - t0))

    ResidentNewbob.prepare = timed
    try:
        yield
    finally:
        ResidentNewbob.prepare = prepare


def run_scheduler(torch, argv) -> dict:
    """One scheduler run from zeroed counts and peak-memory stats: its
    output, wall, launches, peak device bytes, newbob lines, Done lines
    and, resident, its intake and its ResidentNewbob (whose stacks stay
    allocated until the caller drops it)."""
    from nnet_asr_torch.tools import scheduler

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    intakes = []
    t0 = time.perf_counter()
    with timed_intake(torch, intakes):
        out = stdout_of(scheduler.main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    best = re.search(r"Best model: (\S+) \(CV ([\d.]+)%, (\d+) iterations\)", out)
    init = re.search(r"Initial CV accuracy: (\S+)", out)
    check(best is not None and init is not None, f"scheduler output:\n{out}")
    return {"out": out, "wall": wall, "launches": read_counts(),
            "peak": torch.cuda.max_memory_allocated(),
            "history": HISTORY_LINE.findall(out), "decisions": DECISION_LINE.findall(out),
            "done": [(int(f), float(t), float(fps)) for f, t, fps in DONE_LINE.findall(out)],
            "best": best.group(1), "best_cv": float(best.group(2)), "iters": int(best.group(3)),
            "init_cv": float(init.group(1)),
            "runner": intakes[0][0] if intakes else None,
            "intake": {"seconds": intakes[0][1], "resident_bytes": intakes[0][0].resident_bytes,
                       "parked_bytes": intakes[0][0].parked_bytes} if intakes else None}


def same_files(dir_a: str, dir_b: str, what: str) -> int:
    """Every file of two weights directories byte-identical; their count."""
    names = sorted(os.listdir(dir_a))
    check(names == sorted(os.listdir(dir_b)), f"{what}: weight files {names} vs "
                                              f"{sorted(os.listdir(dir_b))}")
    for name in names:
        with open(os.path.join(dir_a, name), "rb") as a, open(os.path.join(dir_b, name), "rb") as b:
            check(a.read() == b.read(), f"{what}: {name} differs")
    return len(names)


def timit_path(torch, card: str, d: str):
    """examples/run_timit_scale.sh stages 2-4 through the port's CLIs on a
    TIMIT-scale corpus: tjoiner, hamm_dct + tnorm, gen_mlp_init 368:500:39,
    then newbob streaming, --resident, and --resident with half the
    training stacks' bytes as the device budget: the same history and
    byte-identical weights in all three, exact launches, CV rising; a
    profiler window over one more resident epoch. Returns the launches of
    the three runs."""
    from nnet_asr_torch.tools import gen_mlp_init, generators, tjoiner, tnorm
    from nnet_asr_torch.tools.synth_corpus import TIMIT, make_corpus

    def j(name: str) -> str:
        return os.path.join(d, name)

    s = TIMIT
    ext, dim = s.ext, s.feat_dim * s.dct
    t_phase = t0 = time.perf_counter()
    n = make_corpus(d, s, seed=SEED, transform=False)
    t_corpus = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = stdout_of(tjoiner.main, ["tjoiner", "-T", "01", "-S", j("train.scp"), "-l", j("joined"),
                                   f"--OUTPUTSCRIPT={j('train_join.scp')}",
                                   f"--STARTFRMEXT={ext}", f"--ENDFRMEXT={ext}"])
    t_join = time.perf_counter() - t0
    check(f"TJoiner: {s.n_train} files -> " in out, f"tjoiner: {out}")
    hamm = j(f"tr_{s.feat_dim}Tcontext{2 * ext + 1}_Ham_dct{s.dct}")
    with open(hamm, "w") as f:
        f.write(stdout_of(generators.main, ["hamm_dct", f"--dimIn={s.feat_dim}",
                                            f"--startFrmExt={ext}", f"--endFrmExt={ext}",
                                            f"--dctBaseCnt={s.dct}"]))
    t0 = time.perf_counter()
    stdout_of(tnorm.main, ["tnorm", "-T", "1", "-S", j("train_join.scp"), "-H", hamm,
                           f"--TARGETMMF={hamm}.norm", f"--STARTFRMEXT={ext}",
                           f"--ENDFRMEXT={ext}"])
    torch.cuda.synchronize()
    t_norm = time.perf_counter() - t0
    with open(hamm + ".transf", "w") as f:
        for part in (hamm, hamm + ".norm"):
            with open(part) as g:
                f.write(g.read())
    nn_init = j(f"nnet_{dim}_{s.hidden}_{s.classes}.init")
    with open(nn_init, "w") as f:
        f.write(stdout_of(gen_mlp_init.main, [f"--dim={dim}:{s.hidden}:{s.classes}", "--gauss",
                                              "--negbias", f"--seed={TS_INIT_SEED}"]))
    log(f"phase 12 recipe, {card}: corpus {s.n_train} + {s.n_cv} utterances, {n['train']} "
        f"training + {n['cv']} cv frames ({t_corpus:.1f}s to make); tjoiner {t_join:.1f}s "
        f"({out.strip()}); tnorm over the joined script {t_norm:.1f}s")

    argv = ["--nn-init", nn_init, "--mlf-train", j("labs.mlf"), "--mlf-cv", j("labs.mlf"),
            "--scp-train", j("train_join.scp"), "--scp-cv", j("cv.scp"), "--phonelist", j("map"),
            f"--learnrate={TS_LR!r}", f"--frm-ext={ext}", "--feature-transform", hamm + ".transf",
            f"--bunchsize={TS_BUNCH}", f"--cachesize={TS_CACHE}", f"--max-iter={TS_ITERS}"]
    n_train = drained_frames(n["train"], TS_CACHE, TS_BUNCH) // TS_BUNCH
    n_cv = drained_frames(n["cv"], TS_CACHE, TS_BUNCH) // TS_BUNCH
    stack_bytes = n_train * TS_BUNCH * (4 * dim + 4)
    budget_mb = stack_bytes / 2 / 2 ** 20
    runs = {"streaming": run_scheduler(torch, argv + ["--weights-dir", j("w_stream")]),
            "resident": run_scheduler(torch, argv + ["--weights-dir", j("w_res"), "--resident"])}
    profile_resident_epoch(torch, card, runs["resident"].pop("runner"), nn_init, j("w_res"),
                           j("profiled.mmf"), n_train)
    runs["budget"] = run_scheduler(torch, argv + ["--weights-dir", j("w_budget"), "--resident",
                                                  f"--hbm-budget-mb={budget_mb!r}"])
    runs["budget"].pop("runner")
    ref = runs["streaming"]
    for name, r in runs.items():
        want = dict.fromkeys(COUNTERS, 0)
        want["matmul_act"] = want["softmax_xent"] = r["iters"] * n_train + (r["iters"] + 1) * n_cv
        want["matmul_act_f32_cp_wgmma"] = want["matmul_act"]
        intake = ("" if r["intake"] is None else
                  f"; intake {r['intake']['seconds']:.2f}s, {r['intake']['resident_bytes']} "
                  f"bytes resident, {r['intake']['parked_bytes']} bytes host-parked")
        log(f"scheduler {name} (368:500:39, lr {TS_LR}, {r['iters']} iterations), {card}: "
            f"{r['wall']:.1f}s; CV {r['init_cv']}% -> best {r['best_cv']}%; decisions "
            f"{r['decisions']}; peak device memory {r['peak']} bytes{intake}; launches "
            f"{json.dumps(r['launches'])}")
        check(r["iters"] == TS_ITERS and len(r["done"]) == 2 * r["iters"] + 1,
              f"{name}: {r['iters']} iterations, {len(r['done'])} Done lines")
        check(r["launches"] == want, f"{name}: launches {r['launches']}, want {want}")
        check(r["history"] == ref["history"] and r["decisions"] == ref["decisions"],
              f"{name}: newbob history {r['history']} differs from streaming's {ref['history']}")
        check(os.path.basename(r["best"]) == os.path.basename(ref["best"]), f"{name}: best model")
        check(r["best_cv"] > r["init_cv"], f"{name}: cv {r['init_cv']}% -> {r['best_cv']}%")
    files = [same_files(j("w_stream"), j(w), f"{name} weights")
             for name, w in (("resident", "w_res"), ("budget", "w_budget"))]
    res, bud = runs["resident"]["intake"], runs["budget"]["intake"]
    check("host-parked" not in runs["resident"]["out"] and res["parked_bytes"] == 0,
          "full residency parked a stack")
    check("host-parked" in runs["budget"]["out"] and bud["parked_bytes"] > 0
          and 0 < bud["resident_bytes"] <= budget_mb * 2 ** 20,
          f"budget run: {bud['resident_bytes']} resident, {bud['parked_bytes']} parked")
    check(res["resident_bytes"] == bud["resident_bytes"] + bud["parked_bytes"],
          "stack bytes differ")
    log(f"weights: {files[0]} files of streaming, resident and budgeted ({budget_mb:.2f} MiB) "
        f"runs byte-identical; newbob histories equal: {ref['history']}")
    for k, what in enumerate(["cv init"] + [f"{p} {i}" for i in range(1, TS_ITERS + 1)
                                            for p in ("epoch", "cv")]):
        log(f"  {what}: frames/s streaming {ref['done'][k][2]}, resident "
            f"{runs['resident']['done'][k][2]}, budgeted {runs['budget']['done'][k][2]} "
            f"({ref['done'][k][0]} frames; {ref['done'][k][1]} / "
            f"{runs['resident']['done'][k][1]} / {runs['budget']['done'][k][1]} s)")
    log(f"phase 12 recipe: {time.perf_counter() - t_phase:.1f}s")
    return {k: sum(r["launches"][k] for r in runs.values()) for k in COUNTERS}


def profile_resident_epoch(torch, card, runner, nn_init, weights, dst, n_train):
    """One more resident epoch from ``nn_init`` at phase 12's learning
    rate (epoch 1 again) in a profiler window: device busy and idle share,
    time by kernel group; its weights byte-identical to epoch 1's."""
    import glob

    e1 = glob.glob(os.path.join(weights, "*_iter01_*"))
    check(len(e1) == 1, f"resident epoch-1 model: {e1}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stdout_of(runner.train_epoch, nn_init, TS_LR, dst)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.key, getattr(e, "self_device_time_total", 0), e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    rows = [r for r in rows if r[1] > 0]
    busy = sum(us for _, us, _ in rows)
    if busy > 0:
        log(f"trace resident epoch (368:500:39, {n_train} bunches), {card}: "
            + split_line(busy, wall_us, group_times(rows, KERNEL_GROUPS + MPE_GROUPS[2:])))
        for key, us, count in rows[:10]:
            log(f"  {us:11.1f} us x{count:<6d} {key[:100]}")
    else:
        log("trace resident epoch: the profiler recorded no device time")
    with open(e1[0], "rb") as a, open(dst, "rb") as b:
        check(a.read() == b.read(), "the profiled resident epoch differs from epoch 1")


def resident_reruns(torch, card: str, d: str, want_mom: dict, want_bf16: dict):
    """Phase 5's momentum newbob and phase 8's bf16 one again with
    --resident: every weight file byte-identical to theirs, the same
    launches. Returns the launches of both, and the momentum run."""
    def j(name: str) -> str:
        return os.path.join(d, name)

    total = dict.fromkeys(COUNTERS, 0)
    for name, iters, extra, ref, want in (
            ("momentum", MOM_ITERS, (), "weights", want_mom),
            ("bf16 momentum", DTYPE_SCHED_ITERS, ("--compute-dtype=bf16",), "weights_bf16",
             want_bf16)):
        r = run_scheduler(torch, sched_argv(d, iters, j(ref + "_res"), *extra, "--resident"))
        got = {k: r["launches"][k] for k in want}
        files = same_files(j(ref), j(ref + "_res"), f"resident {name} newbob")
        log(f"scheduler --resident {name} (phase {5 if ref == 'weights' else 8}'s run), {card}: "
            f"{r['wall']:.1f}s, intake {r['intake']['seconds']:.2f}s; {files} weight files "
            f"byte-identical to {ref}/; launches {json.dumps(r['launches'])}; epoch frames/s "
            f"{[fps for _, _, fps in r['done'][1::2]]}")
        check(got == want and sum(r["launches"].values()) == sum(want.values()),
              f"resident {name}: launches {r['launches']}, want {want}")
        for k in total:
            total[k] += r["launches"][k]
        if ref == "weights":
            momentum_run = {k: r[k] for k in ("decisions", "best", "launches")}
    return total, momentum_run


# ---------------------------------------------------------------------------
# 13. multi-device: the (data, model) mesh, one process per rank on the card
# ---------------------------------------------------------------------------

MESH_TIMEOUT = 420          # seconds a fleet may run before its ranks are killed
MESH_COLLECTIVE_S = 180     # init_process_group's timeout: a lost rank raises
MESH_PROD_STEPS = 3         # timed production steps after one warm-up step
# the f32 dgrads a rank of the 2x2 production mesh launches: 512 rows of
# every layer after the first (the output layer's 4096-wide stripe too) are
# one wave of 128 tiles of dx^T
MESH_PROD_DGRADS = DGRAD_PER_STEP * (1 + MESH_PROD_STEPS)
MESH_REC_B, MESH_CD1_B = 32, 256


def run_mesh_fleet(world: int, cases: list, d: str, name: str):
    """``world`` ranks of this script (``--mesh-rank``: fresh interpreters,
    never a fork of this CUDA process) run ``cases`` ([name, case, kwargs])
    in order on a group formed through a file in ``d``. The phase fails when
    a rank exits non-zero (its peers are killed at once) or the fleet
    outlives MESH_TIMEOUT. Returns (each rank's results, each rank's log)."""
    spec = os.path.join(d, f"{name}.json")
    with open(spec, "w") as f:
        json.dump({"cases": cases, "rdv": "file://" + os.path.join(d, f"{name}.rdv")}, f)
    env = dict(os.environ, WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
               OMP_NUM_THREADS="2")
    logs = [os.path.join(d, f"{name}.r{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank", spec],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=f,
                stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            if (time.perf_counter() - t0 > MESH_TIMEOUT
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    text = []
    for r, path in enumerate(logs):
        with open(path) as f:
            text.append(f.read())
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"{name}: rank {r} exited {p.returncode} after "
                                 f"{time.perf_counter() - t0:.0f}s:\n{text[r][-3000:]}")
    results = []
    for r in range(world):
        with open(os.path.join(d, f"{name}.r{r}.json")) as f:
            results.append(json.load(f))
    return results, text


def mesh_rank_main(spec_path: str) -> int:
    """One rank of a phase-13 fleet: load the built kernels, join the group
    (backend by parallel/mesh.py's rule), run the cases with the launch
    counts zeroed before each, write their results as JSON."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from nnet_asr_torch.ops.kernels import _build
    from nnet_asr_torch.parallel import mesh as M

    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    M.init_process_group(M.rank_device(), init_method=spec["rdv"],
                         timeout=timedelta(seconds=MESH_COLLECTIVE_S))
    out = {"_backend": dist.get_backend()}
    for name, case, kw in spec["cases"]:
        zero_counts()
        t0 = time.perf_counter()
        r = MESH_CASES[case](torch, **kw)
        torch.cuda.synchronize()
        r.update(launches=read_counts(), seconds=time.perf_counter() - t0)
        out[name] = r
        log(f"rank {rank}: {name} {r['seconds']:.1f}s, launches {json.dumps(r['launches'])}")
    with open(spec_path[:-len(".json")] + f".r{rank}.json", "w") as f:
        json.dump(out, f)
    return 0


def mesh_case_tool(torch, module: str, argv: list) -> dict:
    """A tool's ``main(argv)`` on this rank (its device: the rank's card)."""
    import importlib

    return {"log": stdout_of(importlib.import_module(f"nnet_asr_torch.tools.{module}").main,
                             argv)}


def mesh_case_probe(torch) -> dict:
    """Which collectives the group's backend carries for CUDA tensors."""
    import torch.distributed as dist

    world, dev = dist.get_world_size(), torch.device("cuda", torch.cuda.current_device())
    t = torch.full((4,), float(dist.get_rank() + 1), device=dev)
    ops = {"all_reduce(SUM)": lambda: dist.all_reduce(t.clone()),
           "all_reduce(MAX)": lambda: dist.all_reduce(t.clone(), dist.ReduceOp.MAX),
           "all_reduce(MIN)": lambda: dist.all_reduce(t.clone(), dist.ReduceOp.MIN),
           "all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(world)], t),
           "broadcast": lambda: dist.broadcast(t.clone(), 0),
           "barrier": dist.barrier}
    out = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {str(e)[:160]}"
    return {"collectives": out}


def rel_max_diff(got: list, want: list) -> float:
    """The largest |got - want| over the largest |want|, tensor by tensor."""
    import numpy as np

    return max(float(np.abs(np.asarray(a[k], np.float64) - b[k]).max() / np.abs(b[k]).max())
               for a, b in zip(got, want) for k in b if np.abs(b[k]).max() > 0)


def restore_counts(counts: dict) -> None:
    """Set the launch counters back (launches made to compare paths do not count)."""
    for name, (f, k) in _counters().items():
        setattr(f, k, counts[name])
    for c in _graph_launches().values():
        c.clear()


def mesh_case_production(torch, data: int, model: int) -> dict:
    """The production stack (momentum 0.9) on the mesh: one warm-up step,
    MESH_PROD_STEPS timed by CUDA events on this rank, its peak device
    memory; rank 0 holds the parameters against the single-device
    Trainer's on the same bunches on the card."""
    from nnet_asr_torch.parallel.mesh import make_mesh
    from nnet_asr_torch.parallel.sharded_step import make_sharded_train_step, zero_acc
    from nnet_asr_torch.train.sgd import SgdConfig
    from nnet_asr_torch.train.trainer import Trainer, TrainerConfig

    mesh = make_mesh(data, model)
    dev = mesh.device
    sgd = SgdConfig(learning_rate=0.01, momentum=0.9)
    state, step, _, _ = make_sharded_train_step(production_network(), sgd, mesh)
    gen = torch.Generator(device=dev).manual_seed(13)
    bunches = [(0.1 * torch.randn((PROD_BUNCH, PROD_DIMS[0]), generator=gen, device=dev),
                torch.randint(0, PROD_DIMS[-1], (PROD_BUNCH,), generator=gen, device=dev,
                              dtype=torch.int32)) for _ in range(1 + MESH_PROD_STEPS)]
    rows = mesh.rows(PROD_BUNCH)
    acc = step(zero_acc("xent", dev), bunches[0][0][rows], bunches[0][1][rows])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for X, y in bunches[1:]:
        acc = step(acc, X[rows], y[rows])
    end.record()
    torch.cuda.synchronize()
    out = {"ms": start.elapsed_time(end) / MESH_PROD_STEPS,
           "peak": torch.cuda.max_memory_allocated(dev), "xent": float(acc["xent"]),
           "frames": int(acc["frames"])}
    got = state.host_params()
    if mesh.is_main:
        before = read_counts()
        tr = Trainer(production_network(), TrainerConfig(
            bunchsize=PROD_BUNCH, cachesize=PROD_BUNCH * PROD_CACHE_BUNCHES, sgd=sgd), device=dev)
        for X, y in bunches:
            tr._train_step(X, y)
        out["rel"] = rel_max_diff(got, tr.net.to_numpy_params())
        restore_counts(before)
        del tr
    mesh.barrier()
    return out


def mesh_case_recurrent(torch, data: int, model: int) -> dict:
    """A RecurrentTrainer batch on the mesh (368->500->rec 500->39, T 512,
    B MESH_REC_B: the utterances over ``data``); rank 0 holds it against
    the single-device batch on the card."""
    import numpy as np

    from nnet_asr_torch.parallel.mesh import make_mesh
    from nnet_asr_torch.train.recurrent import RecurrentTrainer, RecurrentTrainerConfig
    from nnet_asr_torch.train.sgd import SgdConfig

    mesh = make_mesh(data, model)
    rng = np.random.default_rng(1)
    params = roofline_params(rng)
    feats = [(0.3 * rng.standard_normal((ROOFLINE_T, ROOFLINE_DIMS[0]))).astype(np.float32)
             for _ in range(MESH_REC_B)]
    labels = [rng.integers(0, ROOFLINE_DIMS[2], ROOFLINE_T) for _ in range(MESH_REC_B)]
    cfg = RecurrentTrainerConfig(bptt_order=REC_BPTT, sgd=SgdConfig(learning_rate=0.01))
    tr = RecurrentTrainer(roofline_network(params), cfg, mesh=mesh)
    t0 = time.perf_counter()
    tr.train_batch(feats, labels)
    torch.cuda.synchronize()
    out = {"ms": (time.perf_counter() - t0) * 1e3, "frames": tr.stats.frames}
    if mesh.is_main:
        ref = RecurrentTrainer(roofline_network(params), cfg, device=mesh.device)
        ref.train_batch(feats, labels)
        out["rel"] = rel_max_diff(tr.net.to_numpy_params(), ref.net.to_numpy_params())
        out["ref_frames"] = ref.stats.frames
    mesh.barrier()
    return out


def mesh_case_cd1(torch, data: int, model: int) -> dict:
    """One CD-1 step 598->1024 Gaussian-Bernoulli at bunch MESH_CD1_B on the
    mesh (rows over ``data``, the global noise row-sliced); rank 0 holds it
    against the single-device step with the same noise on the card."""
    from nnet_asr_torch.models.components import Rbm
    from nnet_asr_torch.parallel.mesh import make_mesh
    from nnet_asr_torch.parallel.sharded_aux import make_sharded_cd1_step, place_cd1_inputs
    from nnet_asr_torch.train import rbm as R

    mesh = make_mesh(data, model)
    dev = mesh.device
    gen = torch.Generator().manual_seed(31)
    V, H, B = FEAT_DIM * DCT, RBM_HID, MESH_CD1_B
    spec = Rbm(V, H, vis_type="gauss", hid_type="bern")
    p = {"weight": 0.1 * torch.randn((V, H), generator=gen), "vis_bias": torch.zeros(V),
         "hid_bias": 0.1 * torch.randn((H,), generator=gen)}
    x = torch.randn((B, V), generator=gen)
    noise = no_threshold_ties(torch, spec, p, x, R.hidden_noise(spec, gen, (B, H))).to(dev)
    cfg = R.RbmTrainConfig(learning_rate=0.001)
    state0 = R.init_rbm_state(spec, p, cfg)
    params, state, xb = place_cd1_inputs(mesh, {k: v.numpy() for k, v in p.items()},
                                         {k: v.numpy() for k, v in state0.items()}, x.numpy())
    mse = make_sharded_cd1_step(spec, cfg, mesh)(params, state, xb, noise=noise)
    out = {"mse": float(mse)}
    if mesh.is_main:
        rp = {k: v.to(dev, copy=True) for k, v in p.items()}
        rs = R.init_rbm_state(spec, rp, cfg)
        rmse = R.cd1_step(spec, cfg, rp, rs, x.to(dev), noise=noise)
        out["rel"] = rel_max_diff([{**{k: v.cpu().numpy() for k, v in params.items()},
                                    **{k: v.cpu().numpy() for k, v in state.items()},
                                    "mse": mse.cpu().numpy()}],
                                  [{**{k: v.cpu().numpy() for k, v in rp.items()},
                                    **{k: v.cpu().numpy() for k, v in rs.items()},
                                    "mse": rmse.cpu().numpy()}])
    mesh.barrier()
    return out


MESH_CASES = {"tool": mesh_case_tool, "probe": mesh_case_probe,
              "production": mesh_case_production, "recurrent": mesh_case_recurrent,
              "cd1": mesh_case_cd1}


def replay_distributed(torch, d: str, dev, data: int, target: str):
    """The global bunch sequence of ``tnet --DISTRIBUTED --MESH=<data>x1``
    on phase 4's corpus (``data`` local caches, each round's agreed bunch
    count, data rank 0's rows first) through the single-device Trainer on
    the card, as tests/test_multihost.py replays it; the model is written to
    ``target``. Returns (bunches drained, frames left in each cache)."""
    from nnet_asr_torch.io.htk import FeatureReader
    from nnet_asr_torch.io.labels import LabelRepository
    from nnet_asr_torch.io.scp import read_scp
    from nnet_asr_torch.models.network import Network
    from nnet_asr_torch.parallel.sharded_trainer import fill_cache
    from nnet_asr_torch.train.cache import DeviceFrameCache
    from nnet_asr_torch.train.sgd import SgdConfig
    from nnet_asr_torch.train.trainer import Trainer, TrainerConfig, read_utterances

    def j(name: str) -> str:
        return os.path.join(d, name)

    cfg = TrainerConfig(bunchsize=BUNCH, cachesize=CACHE, seed=SEED, randomize=True,
                        sgd=SgdConfig(learning_rate=0.008, grad_div_frm=False))
    tr = Trainer(Network.read(j("init.mmf")), cfg, Network.read(j("transform")), EXT, EXT,
                 device=dev)
    reader = FeatureReader(start_frm_ext=EXT, end_frm_ext=EXT)
    labels = LabelRepository(j("labs.mlf"), j("map"), "*/", "lab")
    entries = read_scp(j("train.scp"))
    caches = [DeviceFrameCache(CACHE // data, BUNCH // data, SEED, True) for _ in range(data)]
    its = [iter(read_utterances(reader, entries[k::data], labels, EXT, EXT))
           for k in range(data)]
    drained = 0
    while True:
        for cache, it in zip(caches, its):
            fill_cache(cache, it, tr.pipeline)
        agreed = min(min(c.rows, c.cachesize) // (BUNCH // data) for c in caches)
        if agreed == 0:
            break
        parts = [c.take_stacked(max_bunches=agreed) for c in caches]
        tr.drain_train(torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1))
        drained += agreed
    tr.updated_network().write(target)
    return drained, [c.rows for c in caches]


def mesh_path(torch, card: str, d: str, n: dict, resident_mom: dict) -> dict:
    """Phase 13 (the module doc); returns the launches summed over every
    rank of its fleets."""
    def j(name: str) -> str:
        return os.path.join(d, name)

    t_phase = time.perf_counter()
    total = dict.fromkeys(COUNTERS, 0)
    per_epoch = drained_frames(n["train"], CACHE, BUNCH) // BUNCH
    per_cv = drained_frames(n["cv"], CACHE, BUNCH) // BUNCH
    train = ("-S", j("train.scp"))

    def launched(results, case, want, what):
        if "matmul_act" in want:   # every f32 forward at a rank's rows on the CP_WGMMA route
            want = {**want, "matmul_act_f32_cp_wgmma": want["matmul_act"],
                    "matmul_act_f32_wgmma": 0}
        for r, res in enumerate(results):
            got = res[case]["launches"]
            for k in total:
                total[k] += got[k]
            check(all(got[k] == v for k, v in want.items()),
                  f"{what}: rank {r} launches {got}, want {want}")

    # 13.1 --MESH=1x1: one rank, NCCL, the single-device epoch byte for byte
    r1, _ = run_mesh_fleet(1, [
        ["e1", "tool", {"module": "tnet", "argv": tnet_argv(
            d, j("init.mmf"), *train, f"--TARGETMMF={j('mesh1x1_e1.mmf')}", "--MESH=1x1")}],
        ["cv", "tool", {"module": "tnet", "argv": tnet_argv(
            d, j("mesh1x1_e1.mmf"), "-S", j("cv.scp"), "-c", "--MESH=1x1")}]], d, "mesh1x1")
    e1 = tnet_result(r1[0]["e1"]["log"])
    with open(j("mesh1x1_e1.mmf"), "rb") as a, open(j("e1.mmf"), "rb") as b:
        same = a.read() == b.read()
    rel = mmf_rel_diff(j("mesh1x1_e1.mmf"), j("e1.mmf"))
    log(f"tnet --MESH=1x1 (1 rank, {r1[0]['_backend']}), {card}: Xent {e1['xent']:.10g} "
        f"frames {e1['frames']}, FPS {e1['fps']}; MMF "
        f"{'byte-identical to' if same else 'differs from'} phase 4's epoch 1 (max rel "
        f"{rel:.2e}); {r1[0]['e1']['seconds']:.1f}s")
    check(r1[0]["_backend"] == "nccl", f"--MESH=1x1: backend {r1[0]['_backend']}, want nccl")
    check(same or rel <= 1e-6, f"--MESH=1x1 epoch differs from the single-device one: {rel}")
    launched(r1, "e1", {"matmul_act": per_epoch, "softmax_xent": per_epoch,
                        "wgrad_momentum_update": 0}, "--MESH=1x1 epoch")
    launched(r1, "cv", {"matmul_act": per_cv, "softmax_xent": per_cv}, "--MESH=1x1 cv")

    # 13.2 --MESH=2x2, 13.4 scheduler --resident --mesh=2x2, 13.6 production
    # width, a recurrent batch and a CD-1 step: 4 ranks on the one card
    r4, logs4 = run_mesh_fleet(4, [
        ["probe", "probe", {}],
        ["tnet", "tool", {"module": "tnet", "argv": tnet_argv(
            d, j("init.mmf"), *train, f"--TARGETMMF={j('mesh2x2_e1.mmf')}", "--MESH=2x2")}],
        ["sched", "tool", {"module": "scheduler", "argv": sched_argv(
            d, MOM_ITERS, j("weights_mesh"), "--resident", "--mesh=2x2")}],
        ["prod", "production", {"data": 2, "model": 2}],
        ["rec", "recurrent", {"data": 2, "model": 2}],
        ["cd1", "cd1", {"data": 2, "model": 2}]], d, "mesh2x2")
    log(f"4 ranks on {card}: backend {r4[0]['_backend']}; collectives on CUDA tensors "
        f"{json.dumps(r4[0]['probe']['collectives'])}; "
        + "; ".join(line for line in logs4[0].splitlines() if line.startswith("[mesh]")))
    check(r4[0]["_backend"] == "gloo", "4 ranks on one card must take gloo")
    e22 = tnet_result(r4[0]["tnet"]["log"])
    xrel = abs(e22["xent"] - e1["xent"]) / abs(e1["xent"])
    wrel = mmf_rel_diff(j("mesh2x2_e1.mmf"), j("e1.mmf"))
    log(f"tnet --MESH=2x2 (135 senones padded to 136 over model=2), {card}: Xent "
        f"{e22['xent']:.10g} (rel {xrel:.2e} to phase 4's epoch 1), MMF max rel {wrel:.2e}; "
        f"FPS {e22['fps']} (rank 0; 4 ranks sharing one card over gloo: not a scaling "
        f"figure); {r4[0]['tnet']['seconds']:.1f}s")
    check("mesh=data:2xmodel:2" in r4[0]["tnet"]["log"], "--MESH=2x2: the FPS line's mesh")
    check(xrel <= 1e-4 and wrel <= 1e-4, f"--MESH=2x2 epoch: Xent rel {xrel}, MMF rel {wrel}")
    launched(r4, "tnet", {"matmul_act": per_epoch, "softmax_xent": 0,
                          "wgrad_momentum_update": 0}, "--MESH=2x2 epoch")
    sched = r4[0]["sched"]["log"]
    decisions = DECISION_LINE.findall(sched)
    best = re.search(r"Best model: (\S+) \(CV", sched).group(1)
    brel = mmf_rel_diff(best, resident_mom["best"])
    log(f"scheduler --resident --mesh=2x2 (phase 5's momentum newbob), {card}: decisions "
        f"{decisions} (single-device resident {resident_mom['decisions']}); best "
        f"{os.path.basename(best)}, max rel {brel:.2e} to the single-device best; "
        f"{r4[0]['sched']['seconds']:.1f}s")
    check(decisions == resident_mom["decisions"], "resident mesh: newbob decisions differ")
    check(brel <= 1e-4, f"resident mesh: best model rel {brel}")
    check(all(DECISION_LINE.findall(res["sched"]["log"]) == decisions for res in r4),
          "resident mesh: the ranks' decisions differ")
    launched(r4, "sched", {"matmul_act": resident_mom["launches"]["matmul_act"],
                           "softmax_xent": 0, "wgrad_momentum_update": 0},
             "resident mesh scheduler")
    prod = [res["prod"] for res in r4]
    log(f"production 1024->4096x4->8192 f32 momentum 0.9, bunch {PROD_BUNCH}, 2x2 mesh, "
        f"{card}: 4 ranks sharing one card over gloo: not a scaling figure: rank 0 "
        f"{prod[0]['ms']:.1f} ms a step by CUDA events ({MESH_PROD_STEPS} steps after a "
        f"warm-up); peak device memory a rank {[p['peak'] for p in prod]} bytes; parameters "
        f"max rel {prod[0]['rel']:.2e} to the single-device Trainer on the same bunches")
    check(prod[0]["rel"] <= 1e-4, f"production mesh: parameters rel {prod[0]['rel']}")
    check(prod[0]["frames"] == PROD_BUNCH * (1 + MESH_PROD_STEPS), "production mesh: frames")
    launched(r4, "prod", {"matmul_act": (len(PROD_DIMS) - 2) * (1 + MESH_PROD_STEPS),
                          "softmax_xent": 0, "wgrad_momentum_update": 0,
                          "dgrad": MESH_PROD_DGRADS}, "production mesh")
    rec, cd1 = r4[0]["rec"], r4[0]["cd1"]
    log(f"RecurrentTrainer batch 368->500->rec 500->39, T {ROOFLINE_T}, B {MESH_REC_B} over "
        f"data=2 of the 2x2 mesh, {card}: {rec['ms']:.1f} ms (host clock), max rel "
        f"{rec['rel']:.2e} to the single-device batch; CD-1 598->1024 bunch {MESH_CD1_B} over "
        f"data=2: max rel {cd1['rel']:.2e} to the single-device step")
    check(rec["rel"] <= 3e-4 and rec["frames"] == rec["ref_frames"], f"recurrent mesh: {rec}")
    check(cd1["rel"] <= 2e-4, f"CD-1 mesh: rel {cd1['rel']}")
    launched(r4, "probe", {}, "probe")
    launched(r4, "rec", {}, "recurrent mesh")
    launched(r4, "cd1", {}, "CD-1 mesh")

    # 13.3 tnet --DISTRIBUTED --MESH=2x1 and 13.5 tmpe --MESH=2x1: 2 ranks
    mpe = j("mpe")
    r2, logs2 = run_mesh_fleet(2, [
        ["dist", "tool", {"module": "tnet", "argv": tnet_argv(
            d, j("init.mmf"), *train, f"--TARGETMMF={j('mesh_dist.mmf')}",
            "--DISTRIBUTED=TRUE", "--MESH=2x1")}],
        ["tmpe", "tool", {"module": "tmpe", "argv": tmpe_argv(
            mpe, os.path.join(mpe, "ce1.mmf"), os.path.join(mpe, "train.scp"),
            "--MPEENGINE=native", "--MESH=2x1",
            f"--TARGETMMF={os.path.join(mpe, 'mpe_mesh.mmf')}")}]], d, "mesh2x1")
    drained, left = replay_distributed(torch, d, torch.device("cuda", 0), 2, j("dist_replay.mmf"))
    drel = mmf_rel_diff(j("mesh_dist.mmf"), j("dist_replay.mmf"))
    lines = [line for text in logs2 for line in text.splitlines()
             if line.startswith(("[distributed]", "[sharded]"))]
    log(f"tnet --DISTRIBUTED=TRUE --MESH=2x1, {card}: {drained} global bunches, FPS "
        f"{tnet_result(r2[0]['dist']['log'])['fps']} (rank 0), MMF max rel {drel:.2e} to the "
        f"single-device Trainer fed the replayed bunches; " + "; ".join(lines))
    check(drel <= 1e-4, f"--DISTRIBUTED: MMF rel {drel} to the replay")
    for r in range(2):
        check(any(line.startswith(f"[distributed] rank {r} ") for line in lines),
              f"--DISTRIBUTED: rank {r}'s shard line")
        check((f"[sharded] rank {r}: dropping {left[r]} unmatched" in logs2[r]) == (left[r] > 0),
              f"--DISTRIBUTED: rank {r}'s drop line ({left[r]} frames left)")
    launched(r2, "dist", {"matmul_act": drained, "softmax_xent": drained,
                          "wgrad_momentum_update": 0}, "--DISTRIBUTED epoch")
    t = tmpe_result(r2[0]["tmpe"]["log"])
    upd = mmf_update_diff(os.path.join(mpe, "mpe_mesh.mmf"), os.path.join(mpe, "mpe1.mmf"),
                          os.path.join(mpe, "ce1.mmf"))
    log(f"tmpe --MESH=2x1 (rank 0's forward-backward, err broadcast), {card}: Avg MPE "
        f"accuracy {t['acc']:.6g} over {t['utts']} utterances; update vs the single-device "
        f"iteration: L2 {upd[0]:.2e}, max {upd[1]:.2e} (tolerance {MPE_UPDATE_TOL:g} L2); "
        f"{r2[0]['tmpe']['seconds']:.1f}s")
    check(upd[0] <= MPE_UPDATE_TOL, f"tmpe mesh: update L2 {upd[0]}")
    launched(r2, "tmpe", {"matmul_act": 2 * t["utts"], "softmax_xent": 0,
                          "wgrad_momentum_update": 0}, "tmpe mesh")
    log(f"phase 13: {time.perf_counter() - t_phase:.1f}s; launches over every rank "
        f"{json.dumps(total)}")
    return total


# ---------------------------------------------------------------------------
# 6. production width through the Trainer
# ---------------------------------------------------------------------------

def production_network():
    """The production-width stack 1024->4096x4->8192 + softmax, weights
    0.05 N(0, 1) from numpy seed 7, zero biases, on the CPU."""
    import numpy as np

    from nnet_asr_torch.models.components import BiasedLinearity, Sigmoid, Softmax
    from nnet_asr_torch.models.network import Network

    rng = np.random.default_rng(7)
    layers, params = [], []
    for i in range(len(PROD_DIMS) - 1):
        layers.append(BiasedLinearity(PROD_DIMS[i], PROD_DIMS[i + 1]))
        params.append({"weight": (0.05 * rng.standard_normal(
            (PROD_DIMS[i], PROD_DIMS[i + 1]), dtype=np.float32)),
            "bias": np.zeros(PROD_DIMS[i + 1], np.float32)})
        if i < len(PROD_DIMS) - 2:
            layers.append(Sigmoid(PROD_DIMS[i + 1], PROD_DIMS[i + 1]))
            params.append({})
    layers.append(Softmax(PROD_DIMS[-1], PROD_DIMS[-1]))
    params.append({})
    return Network(layers).from_numpy_params(params)


def production(torch, dev, card: str):
    import numpy as np

    from nnet_asr_torch.models.components import BiasedLinearity, BlockSoftmax, Sigmoid, Softmax
    from nnet_asr_torch.models.network import Network
    from nnet_asr_torch.train.sgd import SgdConfig
    from nnet_asr_torch.train.trainer import Trainer, TrainerConfig

    zero_counts()
    net = production_network()
    n_params = sum(p.numel() for p in net.parameters())
    cfg = TrainerConfig(bunchsize=PROD_BUNCH, cachesize=PROD_BUNCH * PROD_CACHE_BUNCHES,
                        seed=1, sgd=SgdConfig(learning_rate=0.01))
    tr = Trainer(net, cfg, device=dev)

    def utts(n_caches, seed):
        # made before the timed epoch: generating it is set-up, not intake
        r = np.random.default_rng(seed)
        return [((0.1 * r.standard_normal((PROD_BUNCH, PROD_DIMS[0]), dtype=np.float32)),
                 r.integers(0, PROD_DIMS[-1], PROD_BUNCH).astype(np.int32))
                for _ in range(n_caches * PROD_CACHE_BUNCHES)]

    tr.run_epoch(utts(1, 11))                      # warm-up cache
    data = utts(4, 12)
    tr.total_frames, tr.wall = 0, 0.0
    tr.run_epoch(data)
    epoch_fps = tr.total_frames / tr.wall
    check(math.isfinite(tr.stats.error) and tr.stats.frames > 0, "production stats")

    feats = 0.1 * torch.randn((PROD_BUNCH, PROD_DIMS[0]), device=dev)
    labels = torch.randint(0, PROD_DIMS[-1], (PROD_BUNCH,), device=dev, dtype=torch.int32)
    step_ms = cuda_ms(torch, lambda: tr._train_step(feats, labels), reps=20, warmup=3)
    step_fps = PROD_BUNCH / (step_ms * 1e-3)
    log(f"production 1024->4096x4->8192 f32 ({n_params} params), bunch {PROD_BUNCH}, "
        f"{card}: train step {step_ms:.3f} ms = {step_fps:.0f} frames/s = "
        f"{6 * n_params * step_fps / 1e12:.2f} TFLOP/s (6*params*frames/s); "
        f"epoch incl. host intake {epoch_fps:.0f} frames/s = "
        f"{6 * n_params * epoch_fps / 1e12:.2f} TFLOP/s")

    # the momentum step (every weight through the fused wgrad+momentum
    # kernel) beside momentum 0, then the MSE objective and a
    # BlockSoftmax(4096, 4096) head (plain objective passes in place of the
    # fused softmax-CE kernel) at momentum 0 and 0.9, in turns on the same
    # weights
    block_net = Network(list(net.layers[:-1]) + [
        BlockSoftmax(PROD_DIMS[-1], PROD_DIMS[-1], dims=(PROD_DIMS[-1] // 2,) * 2)])
    steps = {"momentum 0": tr}
    for name, vdt in (("momentum 0.9 f32 velocity", None), ("momentum 0.9 bf16 velocity", "bf16")):
        steps[name] = Trainer(net, TrainerConfig(
            bunchsize=PROD_BUNCH, cachesize=PROD_BUNCH * PROD_CACHE_BUNCHES, seed=1,
            sgd=SgdConfig(learning_rate=0.01, momentum=0.9, velocity_dtype=vdt)), device=dev)
    for name, n_, objective in (("mse", net, "mse"), ("blocksoftmax(4096,4096)", block_net, "xent")):
        for m in (0.0, 0.9):
            steps[f"{name} momentum {m:g}"] = Trainer(n_, TrainerConfig(
                bunchsize=PROD_BUNCH, cachesize=PROD_BUNCH * PROD_CACHE_BUNCHES, seed=1,
                objective=objective, sgd=SgdConfig(learning_rate=0.01, momentum=m)), device=dev)
    # the bf16 compute dtype: bf16 affine_sigmoid, and at momentum 0.9 the
    # bf16-operand wgrad, on the same f32 master weights
    for m in (0.0, 0.9):
        steps[f"bf16 momentum {m:g}"] = Trainer(net, TrainerConfig(
            bunchsize=PROD_BUNCH, cachesize=PROD_BUNCH * PROD_CACHE_BUNCHES, seed=1,
            compute_dtype="bf16", sgd=SgdConfig(learning_rate=0.01, momentum=m)), device=dev)
    times = {name: [] for name in steps}
    for name in [*steps, *reversed(steps)]:
        times[name].append(cuda_ms(torch, lambda: steps[name]._train_step(feats, labels),
                                   reps=20, warmup=3))
    for name, ms in times.items():
        fps = [PROD_BUNCH / (t * 1e-3) for t in ms]
        bound = (f" ({6 * n_params / PEAK_BF16 * PROD_BUNCH * 1e3:.3f} ms at the 989 TFLOP/s "
                 f"bf16 bound)" if name.startswith("bf16") else "")
        log(f"production train step, {name}, {card}: "
            + ", ".join(f"{t:.3f} ms = {f:.0f} frames/s = {6 * n_params * f / 1e12:.2f} "
                        f"TFLOP/s" for t, f in zip(ms, fps)) + bound)
    check(all(bool(torch.isfinite(p).all()) for p in net.parameters()),
          "production weights not finite after the momentum steps")
    momentum_step_routes(torch, dev, feats, labels, card)
    # per step in the profiler window: every GEMM kernel of a step on the
    # WGMMA route of its operand type (4 affine_sigmoid; at momentum 0.9 5
    # wgrad; at f32 the 4 dgrads), none on MMA_SYNC
    hidden, weights = len(PROD_DIMS) - 2, len(PROD_DIMS) - 1
    forward = {t: {f"matmul_act{t}": hidden, f"matmul_act_{t[1:] or 'f32'}_wgmma": hidden}
               for t in ("", "_bf16")}
    forward[""]["dgrad"] = DGRAD_PER_STEP
    update = {t: {f"wgrad_momentum_update{t}": weights,
                  f"wgrad_momentum_update_{t[1:] or 'f32'}_wgmma": weights} for t in ("", "_bf16")}
    routes = {"momentum 0": forward[""], "mse momentum 0": forward[""],
              "blocksoftmax(4096,4096) momentum 0": forward[""],
              "momentum 0.9 f32 velocity": {**forward[""], **update[""]},
              "momentum 0.9 bf16 velocity": {**forward[""], **update[""]},
              "bf16 momentum 0": forward["_bf16"],
              "bf16 momentum 0.9": {**forward["_bf16"], **update["_bf16"]}}
    gemm_keys = [k for k in COUNTERS if k != "softmax_xent"]
    for name, route in routes.items():
        launched = trace_steps(torch, name, lambda: steps[name]._train_step(feats, labels), card)
        got = {k: launched[k] for k in gemm_keys}
        want = {k: route.get(k, 0) for k in gemm_keys}
        check(got == want, f"production {name}: GEMM launches a step {got}, want {want}")
    return read_counts()


def momentum_step_routes(torch, dev, feats, labels, card):
    """Two f32 steps of the production stack, at momentum 0 and 0.9 (f32
    velocity), from the same weights on the f32 WGMMA route and on the
    MMA_SYNC one: every parameter and velocity within 1e-5 of its largest
    (the two routes sum in other orders). The launches count nowhere."""
    from nnet_asr_torch.tools.gemm_ceiling import mma_sync_f32
    from nnet_asr_torch.train.sgd import SgdConfig
    from nnet_asr_torch.train.trainer import Trainer, TrainerConfig

    before = read_counts()
    for m in (0.0, 0.9):
        nets = []
        for wgmma in (True, False):
            tr = Trainer(production_network(), TrainerConfig(
                bunchsize=PROD_BUNCH, cachesize=PROD_BUNCH * PROD_CACHE_BUNCHES, seed=1,
                sgd=SgdConfig(learning_rate=0.01, momentum=m)), device=dev)
            with contextlib.nullcontext() if wgmma else mma_sync_f32():
                for _ in range(2):
                    tr._train_step(feats, labels)
            torch.cuda.synchronize()
            nets.append([t.detach().float().cpu().numpy() for t in tr.net.parameters()]
                        + [t.float().cpu().numpy() for layer in tr.velocity
                           for t in layer.values()])
            del tr
        rel = rel_max_diff([{"t": a} for a in nets[0]], [{"t": b} for b in nets[1]])
        log(f"production momentum {m:g}, {card}: two f32 steps on the f32 WGMMA route against "
            f"the MMA_SYNC route: parameters and velocity max rel {rel:.3e}")
        check(rel <= 1e-5, f"production momentum {m:g} steps: the routes differ by {rel} > 1e-5")
    restore_counts(before)


# (group, pattern searched in the kernel's name), first match wins; the
# operand type is the template argument after the Tile; the f32 WGMMA
# route's kernels (and their pre-passes) carry "_f32_" in their names, the
# bf16 WGMMA route's not
KERNEL_GROUPS = (("affine_sigmoid f32 CP_WGMMA (ours)", "matmul_act_f32_cp_"),
                 ("affine_sigmoid f32 WGMMA (ours)", "matmul_act_f32_"),
                 ("affine_sigmoid bf16 (ours)",
                  r"matmul_act_kernel.*Tile<[^>]*>, __nv_bfloat16|matmul_act_wgmma_kernel"
                  r"|matmul_act_cp_wgmma_kernel"),
                 ("affine_sigmoid (ours)", "matmul_act_kernel"),
                 ("wgrad_momentum_update f32 CP_WGMMA (ours)", "wgrad_momentum_f32_cp_"),
                 ("wgrad_momentum_update f32 WS_WGMMA (ours)", "wgrad_momentum_f32_ws_"),
                 ("wgrad_momentum_update f32 WGMMA (ours)", "wgrad_momentum_f32_"),
                 ("wgrad_momentum_update bf16 CP_WGMMA (ours)", "wgrad_momentum_bf16_cp_"),
                 ("wgrad_momentum_update bf16 (ours)",
                  r"wgrad_momentum_kernel.*Tile<[^>]*>, __nv_bfloat16|wgrad_momentum_wgmma_kernel"),
                 ("wgrad_momentum_update (ours)", "wgrad_"),
                 ("softmax_xent (ours)", "softmax_xent_"),
                 ("dgrad f32 WGMMA (ours)", "dgrad_f32_"),
                 ("cuBLAS GEMM", "gemm|xmma|cutlass|nvjet"))


# the bf16 forward, the bf16 wgrad at f32 and bf16 v; the same in f32; the
# bf16 CP_WGMMA forward, its wgrad on column tiles and on the ROWS tile at
# f32 and bf16 v; the f32 CP_WGMMA forward, its wgrad at f32 and bf16 v;
# the f32 WS_WGMMA wgrad at f32 and bf16 v; the f32 dgrad
WGMMA_KERNELS = 17


def wgmma_spills(build_log: str) -> dict:
    """Spill bytes (stores + loads) by WGMMA-route kernel, from ptxas's -v
    report: each kernel's "Compiling entry function" line, then its
    "bytes spill stores, ... bytes spill loads" line."""
    spills, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S*wgmma_kernel\S*)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name is not None:
            spills[name] = int(m.group(1)) + int(m.group(2))
            name = None
    return spills


def profile_window(torch, step, n_steps=5):
    """(rows, wall us a step, wrapper launches a step) of a torch.profiler
    window of ``n_steps`` steps after one warm-up step (the schedule drops
    its events): rows are (kernel name, device us a step, calls a step) with
    device time, longest first; the wall is the window's (profiler on)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    # one cycle; no step() after the last active step, which would end the
    # cycle and clear its events before key_averages reads them
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n_steps, repeat=1)) as prof:
        step()
        torch.cuda.synchronize()   # the warm-up step's kernels end before the window
        prof.step()
        before = read_counts()
        t0 = time.perf_counter()
        for i in range(n_steps):
            step()
            if i < n_steps - 1:
                prof.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / n_steps
        launched = {k: (v - before[k]) / n_steps for k, v in read_counts().items()}
    rows = sorted(((e.key, getattr(e, "self_device_time_total", 0) / n_steps, e.count / n_steps)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    return [r for r in rows if r[1] > 0], wall_us, launched


def group_times(rows, groups, other="other"):
    """Device us by group: each row's first matching pattern, else ``other``."""
    out = {}
    for key, us, _ in rows:
        group = next((g for g, pat in groups if re.search(pat, key)), other)
        out[group] = out.get(group, 0.0) + us
    return out


def split_line(busy, wall_us, groups) -> str:
    return (f"device {busy:.1f} us of {wall_us:.1f} us wall under the profiler (idle share "
            f"{1 - busy / wall_us:.3f}); "
            + "; ".join(f"{g} {us:.1f} us ({us / busy:.1%})"
                        for g, us in sorted(groups.items(), key=lambda kv: -kv[1])))


def trace_steps(torch, name, step, card, n_steps=5):
    """Device time per production train step by kernel name, the idle
    share, and the wrappers' launch counts over the same steps."""
    rows, wall_us, launched = profile_window(torch, step, n_steps)
    busy = sum(us for _, us, _ in rows)
    if busy <= 0:
        log(f"trace {name}: the profiler recorded no device time")
        return launched
    log(f"trace production step, {name}, {card}: "
        + split_line(busy, wall_us, group_times(rows, KERNEL_GROUPS))
        + f"; wrapper launches per step {json.dumps(launched)}")
    for key, us, count in rows[:12]:
        log(f"  {us:9.1f} us x{count:<4.1f} {key[:110]}")
    return launched


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from nnet_asr_torch.ops.kernels import _build
    from nnet_asr_torch.tools.synth_corpus import CorpusShape, make_corpus

    # 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f}s (nvcc {_build.build_seconds}) -> "
        f"{os.path.relpath(_build.library_path())}")

    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line or "registers" in line or "spill" in line:
            log(f"  ptxas: {line.split(':', 1)[-1].strip()}")
    spills = wgmma_spills(_build.build_log)
    log(f"ptxas, WGMMA-route kernels: {json.dumps(spills)}")
    check(not _build.build_log or (len(spills) == WGMMA_KERNELS and not any(spills.values())),
          f"a WGMMA-route kernel spills, or is missing from the build log: {spills}")

    # 3. kernels against their plain versions; the first shape of each is
    # the MLP3 shape the kernels line reports. The f32 rows of the first
    # three lists take the MMA_SYNC route at every shape (mma_sync_f32), the
    # f32 WGMMA route's rows at the production shapes follow them
    from nnet_asr_torch.tools.gemm_ceiling import mma_sync_f32

    with mma_sync_f32():
        shapes = {
            "affine_sigmoid": [check_matmul_act(torch, dev, M, K, N, seed=M + K)
                               for M, K, N in AFFINE_SHAPES],
            "fused_softmax_xent": [check_softmax_xent(torch, dev, B, C, seed=B + C)
                                   for B, C in SOFTMAX_SHAPES],
            "wgrad_momentum_update": [
                check_wgrad_momentum(torch, dev, B, In, Out, vdt, seed=B + In + Out)
                for B, In, Out, vdts in WGRAD_SHAPES for vdt in vdts]}
    shapes.update({
        "affine_sigmoid_f32_wgmma": [check_matmul_act(torch, dev, M, K, N, seed=M + K)
                                     for M, K, N in F32_WGMMA_AFFINE],
        "wgrad_momentum_update_f32_wgmma": [
            check_wgrad_momentum(torch, dev, B, In, Out, vdt, seed=B + In + Out)
            for B, In, Out, vdts in F32_WGMMA_WGRAD for vdt in vdts],
        "affine_sigmoid_f32_cp_wgmma": [check_matmul_act(torch, dev, M, K, N, seed=M + K)
                                        for M, K, N in F32_CP_AFFINE],
        "wgrad_momentum_update_f32_cp_wgmma": [
            check_wgrad_momentum(torch, dev, B, In, Out, vdt, seed=B + In + Out,
                                 force_cp=(B, In, Out) in F32_CP_ELSEWHERE)
            for B, In, Out, vdts in F32_CP_WGRAD for vdt in vdts],
        "wgrad_momentum_update_f32_ws_wgmma": [
            check_wgrad_momentum(torch, dev, B, In, Out, vdt, seed=B + In + Out + 2)
            for B, In, Out, vdts in F32_CP_WGRAD if (B, In, Out) in F32_CP_ELSEWHERE
            for vdt in vdts],
        "dgrad_f32_wgmma": [check_dgrad(torch, dev, B, In, Out, seed=B + In + Out + 3)
                            for B, In, Out in DGRAD_SHAPES],
        "affine_sigmoid_bf16": [check_matmul_act_bf16(torch, dev, M, K, N, seed=M + K + 1)
                                for M, K, N in AFFINE_SHAPES],
        "wgrad_momentum_update_bf16": [
            check_wgrad_momentum_bf16(torch, dev, B, In, Out, vdt, seed=B + In + Out + 1)
            for B, In, Out, _ in WGRAD_SHAPES for vdt in ("f32", "bf16")]})
    for name in ("affine_sigmoid", "wgrad_momentum_update"):
        check(all(r["route"] == "MMA_SYNC" for r in shapes[name])
              and all(r["route"] == "WGMMA" for r in shapes[f"{name}_f32_wgmma"])
              and all(r["route"] == "CP_WGMMA" for r in shapes[f"{name}_f32_cp_wgmma"]),
              f"{name}: the f32 rows are not on the routes they name")
    check(all(r["route"] == "WS_WGMMA" for r in shapes["wgrad_momentum_update_f32_ws_wgmma"]),
          "wgrad_momentum_update: the plan does not take 960x1024->135 to WS_WGMMA")

    # 4. the frame-CE path, 5. the momentum newbob path, 7. objectives,
    # 8. compute dtypes, 9. RBM pretraining, 10. recurrent BPTT, on one
    # corpus; 11. MPE on a phone-structured one; 12. resident newbob on the
    # first and on a TIMIT-scale one; 13. the mesh on the first and phase
    # 11's; then 6. production width
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        t0 = time.perf_counter()
        n = make_corpus(d, CorpusShape(), seed=SEED)
        log(f"corpus: {n['train']} training frames, {n['cv']} cv frames "
            f"({time.perf_counter() - t0:.1f}s to make)")
        launches_ce = main_path(torch, card, d, n)
        launches_mom = momentum_path(torch, card, d, n)
        launches_obj = objectives_path(torch, card, d, n)
        launches_dt, launches_dt_sched = dtypes_path(torch, card, d, n)
        t0 = time.perf_counter()
        launches_rbm = rbm_path(torch, card, d, n)
        cd1_agreement(torch, dev)
        time_cd1(torch, dev, card)
        t9 = time.perf_counter() - t0
        recurrent_path(torch, dev, card, d, n)
        log(f"phases 9 and 10: {t9:.1f}s and {time.perf_counter() - t0 - t9:.1f}s")
        t0 = time.perf_counter()
        os.makedirs(os.path.join(d, "mpe"))
        launches_mpe, ragged = mpe_path(torch, dev, card, os.path.join(d, "mpe"))
        shapes["affine_sigmoid_f32_cp_wgmma"].append(ragged)
        log(f"phase 11: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        launches_res, resident_mom = resident_reruns(torch, card, d, launches_mom,
                                                     launches_dt_sched)
        os.makedirs(os.path.join(d, "timit"))
        launches_ts = timit_path(torch, card, os.path.join(d, "timit"))
        log(f"phase 12: {time.perf_counter() - t0:.1f}s")
        launches_mesh = mesh_path(torch, card, d, n, resident_mom)
    launches_prod = production(torch, dev, card)
    launches = {k: sum(p.get(k, 0) for p in (launches_ce, launches_mom, launches_obj,
                                             launches_dt, launches_rbm, launches_mpe,
                                             launches_res, launches_ts, launches_mesh))
                for k in COUNTERS}
    log(f"production-path launches (phase 6): {json.dumps(launches_prod)}")
    # every f32 launch at the recipes' widths on the f32 CP_WGMMA route,
    # phase by phase, but the momentum runs' output-layer updates
    # (960x1024->135, half their wgrad launches), all on the WS_WGMMA route
    # (WS_OUT_LAUNCHES): no f32 mma.sync launch, and no f32 WGMMA launch
    # outside phase 6
    per_phase = {"4": launches_ce, "5": launches_mom, "7": launches_obj, "8": launches_dt,
                 "9": launches_rbm, "11": launches_mpe,
                 "12": {k: launches_res[k] + launches_ts[k] for k in COUNTERS},
                 "13": launches_mesh}
    for phase, got in per_phase.items():
        f32 = {fn: [got.get(fn, 0), got.get(f"{fn}_f32_cp_wgmma", 0),
                    got.get(f"{fn}_f32_ws_wgmma", 0), got.get(f"{fn}_f32_wgmma", 0)]
               for fn in ("matmul_act", "wgrad_momentum_update")}
        want = {"matmul_act": [0, 0], "wgrad_momentum_update": [WS_OUT_LAUNCHES.get(phase, 0), 0]}
        log(f"phase {phase}: f32 launches [all, CP_WGMMA, WS_WGMMA, WGMMA] {json.dumps(f32)}, "
            f"[WS_WGMMA, mma.sync] off the CP_WGMMA route {json.dumps(want)}")
        check(all([ws, every - cp - ws] == want[fn] and wg == 0
                  for fn, (every, cp, ws, wg) in f32.items()),
              f"phase {phase}: f32 launches off their routes: {json.dumps(f32)}")
        # the recipes' widths, their mesh rank's rows and bf16 leave every dx
        # to cuBLAS; phase 13's 4 ranks of the production mesh take theirs
        want_dgrad = 4 * MESH_PROD_DGRADS if phase == "13" else 0
        check(got.get("dgrad", 0) == want_dgrad,
              f"phase {phase}: {got.get('dgrad')} dgrad launches, want {want_dgrad}")

    # the WGMMA-route kernels as entries of their own: the production shapes
    # of phase 3, launched by phase 6
    for name in ("affine_sigmoid_bf16", "wgrad_momentum_update_bf16"):
        shapes[f"{name}_wgmma"] = [r for r in shapes[name] if r["route"] == "WGMMA"]
    # the CP_WGMMA route at the recipes' shapes, launched by phases 8 and 12
    for name in ("affine_sigmoid_bf16", "wgrad_momentum_update_bf16"):
        shapes[f"{name}_cp_wgmma"] = [r for r in shapes[name] if r["route"] == "CP_WGMMA"]
    bf16 = {k: launches[f"matmul_act_bf16{k}"] for k in ("", "_cp_wgmma", "_wgmma")}
    log(f"bf16 affine_sigmoid launches on the recipes' paths: {bf16['']}, of them CP_WGMMA "
        f"{bf16['_cp_wgmma']}, WGMMA {bf16['_wgmma']}, mma.sync "
        f"{bf16[''] - bf16['_cp_wgmma'] - bf16['_wgmma']}")
    f32_main = [f"{B}x{In}->{Out} v f32" for B, In, Out, _ in F32_WGMMA_WGRAD][-1]

    log(f"total {time.perf_counter() - t_start:.1f}s; kernel times below at the MLP3 "
        f"shapes (960x598->1024, 960x135, wgrad 960x598->1024) on {card}, the WGMMA-route "
        f"kernels' (bf16 and f32) at 1024x4096->4096 and 1024x4096->8192 f32 v, every shape "
        f"under 'shapes'; launches summed over the frame-CE, momentum, objectives, "
        f"compute-dtype, RBM fine-tune, MPE, resident and mesh paths (every rank), for "
        f"the WGMMA-route kernels over the production path")
    # name: (source, TPU kernel, counter, launches by path, main shape's
    # index); affine_sigmoid and affine_sigmoid_bf16 are the forward as the
    # wrapper routes it (its counter counts every route of its dtype), the
    # route entries beside them
    meta = {"affine_sigmoid": ("matmul_act.cu", "matmul_act.py:86", "matmul_act", launches, 0),
            "fused_softmax_xent": ("softmax_ce.cu", "softmax_ce.py:113", "softmax_xent",
                                   launches, 0),
            "wgrad_momentum_update": ("sgd_fused.cu", "sgd_fused.py:105",
                                      "wgrad_momentum_update", launches, 0),
            "affine_sigmoid_bf16": ("matmul_act.cu", "matmul_act.py:86", "matmul_act_bf16",
                                    launches, 0),
            "wgrad_momentum_update_bf16": ("sgd_fused.cu", "sgd_fused.py:105",
                                           "wgrad_momentum_update_bf16", launches, 0),
            "affine_sigmoid_bf16_cp_wgmma": ("matmul_act.cu", "matmul_act.py:86",
                                             "matmul_act_bf16_cp_wgmma", launches, 0),
            "wgrad_momentum_update_bf16_cp_wgmma": ("sgd_fused.cu", "sgd_fused.py:105",
                                                    "wgrad_momentum_update_bf16_cp_wgmma",
                                                    launches, 0),
            "affine_sigmoid_bf16_wgmma": ("matmul_act.cu", "matmul_act.py:86",
                                          "matmul_act_bf16_wgmma", launches_prod, -1),
            "wgrad_momentum_update_bf16_wgmma": ("sgd_fused.cu", "sgd_fused.py:105",
                                                 "wgrad_momentum_update_bf16_wgmma",
                                                 launches_prod, -2),
            "affine_sigmoid_f32_wgmma": ("matmul_act.cu", "matmul_act.py:86",
                                         "matmul_act_f32_wgmma", launches_prod, -1),
            "affine_sigmoid_f32_cp_wgmma": ("matmul_act.cu", "matmul_act.py:86",
                                            "matmul_act_f32_cp_wgmma", launches, 0),
            "wgrad_momentum_update_f32_cp_wgmma": ("sgd_fused.cu", "sgd_fused.py:105",
                                                   "wgrad_momentum_update_f32_cp_wgmma",
                                                   launches, 0),
            "wgrad_momentum_update_f32_ws_wgmma": (
                "sgd_fused.cu", "sgd_fused.py:105", "wgrad_momentum_update_f32_ws_wgmma", launches,
                [r["shape"] for r in shapes["wgrad_momentum_update_f32_ws_wgmma"]]
                .index(f"{BUNCH}x1024->{CLASSES} v f32")),
            "wgrad_momentum_update_f32_wgmma": (
                "sgd_fused.cu", "sgd_fused.py:105", "wgrad_momentum_update_f32_wgmma",
                launches_prod, [r["shape"] for r in shapes["wgrad_momentum_update_f32_wgmma"]]
                .index(f32_main)),
            # the dx of affine_sigmoid's VJP, which the JAX package leaves to XLA
            "dgrad_f32_wgmma": ("dgrad.cu", "matmul_act.py:128", "dgrad", launches_prod, 0)}
    kernels = []
    for name, (src, tpu, counter, counts, main) in meta.items():
        main_shape = shapes[name][main]
        check(counts[counter] > 0, f"{name} was not launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": f"nnet_asr_torch/csrc/{src}",
            "replaces": f"nnet_asr_tpu/ops/pallas/{tpu}", "launches": counts[counter],
            "max_abs_err": max(r["max_abs_err"] for r in shapes[name]),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_us"] * 1e-3, "bound_us": main_shape["bound_us"],
            "bound_by": main_shape["bound_by"], "library_ms": main_shape["library_ms"],
            "shapes": shapes[name]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-rank":
        sys.exit(mesh_rank_main(sys.argv[2]))
    sys.exit(main())

"""Training scheduler CLI: newbob over the port's tnet, or resident (port
of the single-device modes of nnet_asr_tpu/tools/scheduler.py).

Runs the newbob loop (initial CV, per-epoch train + CV, accept/reject, LR
halving) of ``train/newbob.py`` ``run_newbob`` (the port's copy of the JAX
package's)
in process against the port's ``tnet``, with the JAX tool's flags and
environment variables (NN_INIT, MLF_TRAIN, MLF_CV, SCP_TRAIN_LOCAL,
SCP_CV_LOCAL, PHONELIST, LEARNRATE, FEATURE_TRANSFORM, FRM_EXT, BUNCHSIZE,
CACHESIZE, MAX_ITER, MOMENTUM, ...), and its ``Best model:`` line. Every
epoch passes ``--MOMENTUM`` to tnet, so a nonzero ``--momentum`` trains
through the fused wgrad+momentum kernel.

``--resident`` (or RESIDENT) runs newbob over ``train/resident.py``
``ResidentNewbob`` in process instead: the corpus is read, transformed
and shuffled once into bunch stacks kept in device memory, and each epoch
only drains them, with the trajectory (and every weight file) of the
streaming mode. ``--hbm-budget-mb`` (or HBM_BUDGET_MB) caps the device
memory those stacks take, in MiB; the stacks beyond it wait on the host
and are copied to the device once an epoch.

``main(argv, device)`` passes ``device`` to ``tnet.main`` or
``ResidentNewbob`` (None: cuda:0, as tnet's ``--GPUSELECT`` default; the
tests pass "cpu"). ``--compute-dtype`` (or COMPUTE_DTYPE) other than f32
is passed on to every tnet run as ``--COMPUTEDTYPE``, or to the resident
Trainer.

``--mesh=DxM`` (or MESH) trains on a (data, model) mesh of ``D*M`` ranks,
one process each (``torchrun --nproc-per-node=D*M -m
nnet_asr_torch.tools.scheduler --mesh=DxM ...``): every rank runs the same
newbob decisions; streaming passes ``--MESH`` to the in-process tnet,
``--resident`` keeps each rank's row block of the stacks. Rank 0 alone
writes and renames the weight files, and every rank meets a barrier before
the next epoch reads them. ``--distributed`` (or DISTRIBUTED) adds tnet's
``--DISTRIBUTED`` per-rank SCP shards, to both modes. From the command line
only rank 0 prints.

    python -m nnet_asr_torch.tools.scheduler --nn-init init.mmf \\
        --mlf-train labs.mlf --mlf-cv labs.mlf --scp-train train.scp \\
        --scp-cv cv.scp --phonelist map --feature-transform transform \\
        --frm-ext 25 --bunchsize 960 --cachesize 14400 --momentum 0.5
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import re
import sys

from ..io.htk import FeatureReader
from ..io.labels import LabelRepository
from ..io.scp import read_scp
from ..train.newbob import NewbobConfig, run_newbob

from ..device import DeviceLike
from ..models.network import Network
from ..parallel.mesh import make_mesh, parse_mesh, quiet_unless_rank0
from ..train.resident import ResidentNewbob
from ..train.sgd import SgdConfig
from ..train.trainer import TrainerConfig
from . import tnet


def _env(name, default=None):
    return os.environ.get(name, default)


def main(argv=None, device: DeviceLike = None) -> int:
    ap = argparse.ArgumentParser(prog="scheduler")
    ap.add_argument("--nn-init", default=_env("NN_INIT"))
    ap.add_argument("--mlf-train", default=_env("MLF_TRAIN"))
    ap.add_argument("--mlf-cv", default=_env("MLF_CV"))
    ap.add_argument("--scp-train", default=_env("SCP_TRAIN_LOCAL"))
    ap.add_argument("--scp-cv", default=_env("SCP_CV_LOCAL"))
    ap.add_argument("--phonelist", default=_env("PHONELIST"))
    ap.add_argument("--learnrate", type=float,
                    default=float(_env("LEARNRATE", "0.06")))
    ap.add_argument("--feature-transform", default=_env("FEATURE_TRANSFORM"))
    ap.add_argument("--frm-ext", type=int, default=int(_env("FRM_EXT", "0")))
    ap.add_argument("--bunchsize", type=int,
                    default=int(_env("BUNCHSIZE", "512")))
    ap.add_argument("--cachesize", type=int,
                    default=int(_env("CACHESIZE", "16384")))
    ap.add_argument("--max-iter", type=int, default=int(_env("MAX_ITER", "20")))
    ap.add_argument("--min-iter", type=int, default=int(_env("MIN_ITER", "1")))
    ap.add_argument("--keep-lrate-iter", type=int,
                    default=int(_env("KEEP_LRATE_ITER", "0")))
    ap.add_argument("--start-halving-inc", type=float,
                    default=float(_env("START_HALVING_INC", "0.5")))
    ap.add_argument("--end-halving-inc", type=float,
                    default=float(_env("END_HALVING_INC", "0.1")))
    ap.add_argument("--halving-factor", type=float,
                    default=float(_env("HALVING_FACTOR", "0.5")))
    ap.add_argument("--momentum", type=float,
                    default=float(_env("MOMENTUM", "0")))
    ap.add_argument("--weightcost", type=float,
                    default=float(_env("WEIGHTCOST", "0")))
    ap.add_argument("--weights-dir", default="weights")
    ap.add_argument("--seed", type=int, default=123)
    # read, transform and shuffle once into device-resident bunch stacks;
    # each epoch only drains them (train/resident.py)
    ap.add_argument("--resident", action="store_true",
                    default=bool(_env("RESIDENT")))
    # a (data, model) mesh 'DxM' of D*M ranks: streaming passes --MESH to
    # tnet, resident keeps each rank's row block of the stacks
    ap.add_argument("--mesh", default=_env("MESH"))
    # per-rank SCP shards (tnet --DISTRIBUTED), streaming or resident
    ap.add_argument("--distributed", action="store_true",
                    default=bool(_env("DISTRIBUTED")))
    # resident mode's device-memory budget in MiB (the JAX tool's HBM
    # budget): stacks beyond it wait on the host and are copied to the
    # device once an epoch
    ap.add_argument("--hbm-budget-mb", type=float,
                    default=float(_env("HBM_BUDGET_MB", "0")) or None)
    ap.add_argument("--compute-dtype", default=_env("COMPUTE_DTYPE"),
                    choices=[None, "f32", "bf16", "int8", "int8pf",
                             "int8pfsr", "int8full"])
    args = ap.parse_args(argv)

    for req in ("nn_init", "mlf_train", "mlf_cv", "scp_train", "scp_cv",
                "phonelist"):
        if getattr(args, req) is None:
            raise SystemExit(f"--{req.replace('_', '-')} (or its env var) "
                             "is required")
    mesh = None
    if args.mesh or args.distributed:
        mesh = make_mesh(*(parse_mesh(args.mesh) if args.mesh else (None, 1)), device=device)

    common = [
        "-m", args.phonelist,
        "--BUNCHSIZE=" + str(args.bunchsize),
        "--CACHESIZE=" + str(args.cachesize),
        "--STARTFRMEXT=" + str(args.frm_ext),
        "--ENDFRMEXT=" + str(args.frm_ext),
        "-L", "*/", "-X", "lab",
    ]
    if args.feature_transform:
        common.append("--FEATURETRANSFORM=" + args.feature_transform)
    if args.compute_dtype not in (None, "f32"):
        common.append("--COMPUTEDTYPE=" + args.compute_dtype)
    if args.mesh:
        common.append("--MESH=" + args.mesh)
    if args.distributed:
        common.append("--DISTRIBUTED=TRUE")

    def parse_accu(log: str) -> float:
        hits = re.findall(r"correct\[([\d.]+)%\]", log)
        if not hits:
            raise SystemExit("Error, No accuracy returned, terminating...")
        return float(hits[-1])

    def run_tnet(extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tnet.main(["tnet"] + extra + common, device=device)
        out = buf.getvalue()
        sys.stdout.write(out)
        return parse_accu(out)

    def train_epoch(src, lrate, dst):
        return run_tnet([
            "-H", src, "-I", args.mlf_train, "-S", args.scp_train,
            "--LEARNINGRATE=" + repr(lrate),
            "--MOMENTUM=" + repr(args.momentum),
            "--WEIGHTCOST=" + repr(args.weightcost),
            "--RANDOMIZE=TRUE", "--SEED=" + str(args.seed),
            "--TARGETMMF=" + dst])

    def crossvalidate(mmf):
        return run_tnet([
            "-c", "-H", mmf, "-I", args.mlf_cv, "-S", args.scp_cv,
            "--RANDOMIZE=FALSE"])

    cfg = NewbobConfig(
        learning_rate=args.learnrate, max_iter=args.max_iter,
        min_iter=args.min_iter, keep_lrate_iter=args.keep_lrate_iter,
        start_halving_inc=args.start_halving_inc,
        end_halving_inc=args.end_halving_inc,
        halving_factor=args.halving_factor)
    if args.resident:
        train_epoch, crossvalidate = _resident(args, device, mesh)
    # every rank replays the same decisions; rank 0 alone moves the weight
    # files, behind barriers
    fleet = {} if mesh is None else dict(fs_ops=mesh.is_main, barrier=mesh.barrier)
    best, st = run_newbob(cfg, args.nn_init, args.weights_dir,
                          train_epoch, crossvalidate, **fleet)
    print(f"Best model: {best} (CV {st.accu_best:.4f}%, "
          f"{len(st.history)} iterations)")
    return 0


def _resident(args, device: DeviceLike, mesh=None):
    """(train_epoch, crossvalidate) of a ResidentNewbob after its intake."""
    reader = FeatureReader(start_frm_ext=args.frm_ext, end_frm_ext=args.frm_ext)
    labels_repo = LabelRepository(args.mlf_train, args.phonelist, "*/", "lab")
    cv_repo = (labels_repo if args.mlf_cv == args.mlf_train else
               LabelRepository(args.mlf_cv, args.phonelist, "*/", "lab"))
    transform = (Network.read(args.feature_transform)
                 if args.feature_transform else None)
    tcfg = TrainerConfig(
        bunchsize=args.bunchsize, cachesize=args.cachesize, seed=args.seed,
        randomize=True,
        compute_dtype=None if args.compute_dtype in (None, "f32") else args.compute_dtype,
        sgd=SgdConfig(learning_rate=args.learnrate, momentum=args.momentum,
                      weightcost=args.weightcost))
    budget = (int(args.hbm_budget_mb * 1024 * 1024)
              if args.hbm_budget_mb else None)
    runner = ResidentNewbob(args.nn_init, transform, reader, labels_repo, tcfg,
                            args.frm_ext, mesh=mesh, hbm_budget_bytes=budget, device=device,
                            distributed=args.distributed)
    train_entries, cv_entries = read_scp(args.scp_train), read_scp(args.scp_cv)
    if args.distributed:
        d = mesh.shape["data"]
        train_entries = train_entries[mesh.data_index::d]
        cv_entries = cv_entries[mesh.data_index::d]
    runner.prepare(train_entries, cv_entries, cv_labels_repo=cv_repo)
    return runner.train_epoch, runner.crossvalidate


def _cli():
    """Reference-style top-level error handling (TNet.cc:371-376)."""
    quiet_unless_rank0()
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except Exception as e:
        print("Exception thrown", file=sys.stderr)
        print(e, file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    _cli()

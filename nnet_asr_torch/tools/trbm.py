"""TRbm — RBM CD-1 pretrainer CLI on one CUDA device (port of
nnet_asr_tpu/tools/trbm.py, TRbmCu.cc, SNAME "TRBM").

The first component of the source MMF must be <rbm> or <rbmsparse>
(TRbmCu.cc:228-232); one pass of CD-1 over the training set updates it and
the whole network is written back. Reports the reconstruction MSE. The
features go through ``--FEATURETRANSFORM`` on the device, 32 utterances at
a time, into the trainer's shuffling cache.

The device comes from ``--GPUSELECT`` as in the port's tnet (-1 means
``cuda:0``) and the run raises without CUDA; only ``main(argv,
device="cpu")`` runs on the CPU. ``--RNGIMPL=threefry|rbg`` names JAX's key
types: both draw from the trainer's one ``torch.Generator``
(``train/rbm.py``).

    python -m nnet_asr_torch.tools.trbm -H rbm.mmf -S train.scp \\
        --FEATURETRANSFORM=transform --STARTFRMEXT=25 --ENDFRMEXT=25 \\
        --LEARNINGRATE=0.001 --MOMENTUM=0.5 --TARGETMMF=rbm.mmf
"""

from __future__ import annotations

import sys
import time

from ..io.scp import parse_scp_entry, read_scp
from ..utils.config import UserInterface

from .. import __version__
from ..device import DeviceLike, gpuselect_device, resolve_device
from ..models.components import Rbm
from ..models.network import Network
from ..train.pipeline import TransformPipeline
from ..train.rbm import RNG_IMPLS, RbmTrainConfig, RbmTrainer

OPTION_STRING = (
    " -D n   PRINTCONFIG=TRUE"
    " -H l   SOURCEMMF"
    " -S l   SCRIPT"
    " -T r   TRACE"
    " -V n   PRINTVERSION=TRUE"
)

SNAME = "TRBM"
BATCH = 32      # utterances transformed per device call


def main(argv=None, device: DeviceLike = None) -> int:
    """Run the tool. ``device`` overrides ``--GPUSELECT`` (the tests pass "cpu")."""
    argv = list(sys.argv if argv is None else argv)
    ui = UserInterface()
    args_parsed = ui.parse_options(argv, OPTION_STRING, SNAME)

    reader, feaparams = ui.make_feature_reader()
    p_source_mmf = ui.get_str("SOURCEMMF")
    p_transform = ui.get_str("FEATURETRANSFORM")
    p_targetmmf = ui.get_str("TARGETMMF")
    p_script = ui.get_str("SCRIPT")
    learning_rate = ui.get_flt("LEARNINGRATE", 0.10)
    momentum = ui.get_flt("MOMENTUM", 0.50)
    weightcost = ui.get_flt("WEIGHTCOST", 0.0002)
    bunchsize = ui.get_int("BUNCHSIZE", 256)
    cachesize = ui.get_int("CACHESIZE", 12800)
    randomize = ui.get_bool("RANDOMIZE", True)
    seed = ui.get_int("SEED", 0)
    rng_impl = ui.get_enum("RNGIMPL", "threefry", list(RNG_IMPLS))
    trace = ui.get_int("TRACE", 0)
    gpuselect = ui.get_int("GPUSELECT", -1)
    if ui.get_bool("PRINTCONFIG", False):
        ui.print_config()
    if ui.get_bool("PRINTVERSION", False):
        print(f"\n======= TRBM v{__version__} (nnet_asr_torch) =======\n")
    ui.check_command_line_param_use()

    if p_source_mmf is None:
        raise SystemExit("Source MMF must be specified [-H]")
    if p_targetmmf is None:
        raise SystemExit("Target MMF must be specified [--TARGETMMF]")

    net = Network.read(p_source_mmf)
    if not len(net.layers) or not isinstance(net.layers[0], Rbm):
        raise SystemExit("First component of the network must be <rbm> or "
                         "<rbmsparse> (TRbmCu.cc:228-232)")
    dev = gpuselect_device(gpuselect) if device is None else resolve_device(device)
    transform = Network.read(p_transform) if p_transform else None
    pipe = TransformPipeline(transform, feaparams["start_frm_ext"],
                             feaparams["end_frm_ext"], device=dev)

    entries = read_scp(p_script) if p_script else []
    for extra in argv[args_parsed:]:
        entries.append(parse_scp_entry(extra))

    cfg = RbmTrainConfig(learning_rate=learning_rate, momentum=momentum,
                         weightcost=weightcost, rng_impl=rng_impl)
    rbm = net.layers[0]
    trainer = RbmTrainer(rbm, rbm.param_dict(), cfg, bunchsize=bunchsize,
                         cachesize=cachesize, seed=seed, randomize=randomize, device=dev)

    print("===== TRbm TRAINING STARTED =====")
    print(f"learning rate: {learning_rate:g} momentum: {momentum:g} "
          f"weightcost: {weightcost:g}")
    t0 = time.time()
    for lo in range(0, len(entries), BATCH):
        pend = [reader.read(e.physical, e.logical) for e in entries[lo:lo + BATCH]]
        rows, valid = pipe.transform_block(pend)
        trainer.ingest_block(rows, valid)
        if trace & 2:
            print("." * len(pend), end="", flush=True)
    trainer.finish_epoch()

    rbm.load_params(trainer.numpy_params())
    net.write(p_targetmmf)

    dt = time.time() - t0
    fps = trainer.frames / max(dt, 1e-9)
    print(f"\n===== TRbm FINISHED ( {dt:.1f}s ) "
          f"[FPS:{fps:.1f},RT:{fps / 100.0:.4f}] =====")
    print(trainer.report(), end="")
    return 0


def _cli():
    """Reference-style top-level error handling (TNet.cc:371-376)."""
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

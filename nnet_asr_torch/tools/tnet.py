"""TNet — frame-level CE/MSE trainer CLI on one CUDA device (port of nnet_asr_tpu/tools/tnet.py).

Accepts the reference tools' option vocabulary (same short options, long
``--PARAM=VAL`` names and ``-C`` config files, SNAME "TNET"), prints the
same ``===== TNET ... =====``, ``Xent:`` and FPS lines, and writes the same
ASCII MMF. The device comes from ``--GPUSELECT`` as in TNetCu (-1 means
``cuda:0``) and the run raises without CUDA; only ``main(argv,
device="cpu")`` runs on the CPU, through the kernels' plain versions.
``--THREADS`` and ``--SCANUNROLL`` are accepted and ignored.

``-O mse``, ``--CONFUSIONMODE=max|soft|dmax|dsoft`` (with the label map's
tags in the per-class lines) and ``--L1`` (SparseLinearity layers) work as
in the JAX tool. ``--SAVESTATE``/``--RESUMESTATE`` write and read the
Trainer's npz state (parameters, velocities, stats) after and before the
epoch, in the JAX tool's format. ``--COMPUTEDTYPE=bf16|int8|int8pf|
int8pfsr|int8full`` selects the Trainer's compute dtype, as in the JAX tool
(``train/trainer.py`` says what each does). ``--MESH``, ``--DISTRIBUTED``
and ``--JAXPROFILE`` raise NotImplementedError naming the ROADMAP.md item
that brings them.

    python -m nnet_asr_torch.tools.tnet -H init.mmf -I labs.mlf -L '*/' \\
        -X lab -S train.scp -m label_map -n 0.008 --GRAD-DIV-FRM=F \\
        --TARGETMMF=epoch1.mmf --BUNCHSIZE=960 --CACHESIZE=14400 \\
        --FEATURETRANSFORM=transform.mmf --STARTFRMEXT=25 --ENDFRMEXT=25
"""

from __future__ import annotations

import sys
import time

from ..io.labels import LabelRepository
from ..io.scp import parse_scp_entry, read_scp
from ..utils.config import UserInterface
from ..utils.profiler import enable_from_trace, profiler

from .. import __version__
from ..device import DeviceLike, gpuselect_device, resolve_device
from ..models.network import Network
from ..train.sgd import SgdConfig
from ..train.trainer import Trainer, TrainerConfig, read_utterances
from . import not_ported

OPTION_STRING = (
    " -c n   CROSSVALIDATE=TRUE"
    " -B n   SAVEBINARY=TRUE"
    " -m r   OUTPUTLABELMAP"
    " -n r   LEARNINGRATE"
    " -o r   TARGETMODELEXT"
    " -D n   PRINTCONFIG=TRUE"
    " -H l   SOURCEMMF"
    " -I r   SOURCEMLF"
    " -L r   SOURCETRANSCDIR"
    " -M r   TARGETMODELDIR"
    " -O r   OBJECTIVEFUNCTION"
    " -S l   SCRIPT"
    " -T r   TRACE"
    " -V n   PRINTVERSION=TRUE"
    " -X r   SOURCETRANSCEXT"
)

SNAME = "TNET"


def main(argv=None, device: DeviceLike = None) -> int:
    """Run the tool. ``device`` overrides ``--GPUSELECT`` (the tests pass "cpu")."""
    argv = list(sys.argv if argv is None else argv)
    ui = UserInterface()
    args_parsed = ui.parse_options(argv, OPTION_STRING, SNAME)

    reader, feaparams = ui.make_feature_reader()

    p_source_mmf = ui.get_str("SOURCEMMF")
    p_transform = ui.get_str("FEATURETRANSFORM")
    p_targetmmf = ui.get_str("TARGETMMF")
    p_trg_dir = ui.get_str("TARGETMODELDIR", "")
    p_trg_ext = ui.get_str("TARGETMODELEXT", "")
    p_script = ui.get_str("SCRIPT")
    p_label_map = ui.get_str("OUTPUTLABELMAP")
    learning_rate = ui.get_flt("LEARNINGRATE", 0.06)
    lr_factors = ui.get_str("LEARNRATEFACTORS", None)
    momentum = ui.get_flt("MOMENTUM", 0.0)
    weightcost = ui.get_flt("WEIGHTCOST", 0.0)
    l1 = ui.get_flt("L1", 0.0)
    grad_div_frm = ui.get_bool("GRADDIVFRM", True)
    objective = ui.get_enum("OBJECTIVEFUNCTION", "ent", ["ent", "mse"])
    confusion_mode = ui.get_enum("CONFUSIONMODE", "no",
                                 ["no", "max", "soft", "dmax", "dsoft"])
    p_mlf = ui.get_str("SOURCEMLF")
    p_lbl_dir = ui.get_str("SOURCETRANSCDIR")
    p_lbl_ext = ui.get_str("SOURCETRANSCEXT", "lab")
    bunchsize = ui.get_int("BUNCHSIZE", 256)
    cachesize = ui.get_int("CACHESIZE", 12800)
    randomize = ui.get_bool("RANDOMIZE", True)
    seed = ui.get_int("SEED", 0)
    crossval = ui.get_bool("CROSSVALIDATE", False)
    trace = ui.get_int("TRACE", 0)
    ui.get_int("THREADS", 1)        # accepted for script compat; ignored
    gpuselect = ui.get_int("GPUSELECT", -1)
    ui.get_bool("SAVEBINARY", False)  # accepted; models are ASCII MMF
    ui.get_str("TEMPBASISFOLDER")   # cluster temp-basis staging dir; n/a
    if not ui.get_bool("MLFTRANSC", True):
        print("WARNING: --MLFTRANSC=FALSE (per-file transcriptions) is not "
              "supported; labels come from the -I MLF", file=sys.stderr)

    if ui.get_bool("PRINTCONFIG", False):
        print()
        ui.print_config()
        print()
    if ui.get_bool("PRINTVERSION", False):
        print(f"\n======= TNET v{__version__} (nnet_asr_torch) =======\n")
    mesh_spec = ui.get_str("MESH")
    distributed = ui.get_bool("DISTRIBUTED", False)
    p_resume = ui.get_str("RESUMESTATE")
    p_save = ui.get_str("SAVESTATE")
    p_jaxprofile = ui.get_str("JAXPROFILE")
    ui.get_int("SCANUNROLL", 8)     # an XLA scan knob; accepted and ignored
    velocity_dtype = ui.get_enum("VELOCITYDTYPE", "f32", ["f32", "bf16"])
    compute_dtype = ui.get_enum(
        "COMPUTEDTYPE", "f32",
        ["f32", "bf16", "int8", "int8pf", "int8pfsr", "int8full"])
    ui.check_command_line_param_use()

    if mesh_spec or distributed:
        raise not_ported("--MESH/--DISTRIBUTED", "queue 1 item 14")
    if p_jaxprofile:
        raise not_ported("--JAXPROFILE", "queue 1 item 9")

    if p_script is None:
        print("WARNING: The script file is missing [-S]", file=sys.stderr)
    if p_mlf is None:
        raise SystemExit("Source mlf file is missing [-I]")
    if p_label_map is None:
        raise SystemExit("Output label map is missing [-m]")
    if p_source_mmf is None:
        raise SystemExit("Source MMF must be specified [-H]")

    dev = gpuselect_device(gpuselect) if device is None else resolve_device(device)

    entries = read_scp(p_script) if p_script else []
    for extra in argv[args_parsed:]:
        entries.append(parse_scp_entry(extra))

    labels_repo = LabelRepository(p_mlf, p_label_map, p_lbl_dir, p_lbl_ext)
    transform = Network.read(p_transform) if p_transform else None
    net = Network.read(p_source_mmf)

    cfg = TrainerConfig(
        bunchsize=bunchsize, cachesize=cachesize, seed=seed,
        randomize=randomize and not crossval, crossvalidate=crossval,
        objective="xent" if objective == "ent" else "mse",
        sgd=SgdConfig(learning_rate=learning_rate, momentum=momentum,
                      weightcost=weightcost, l1=l1, grad_div_frm=grad_div_frm,
                      lr_factors=SgdConfig.parse_factors(lr_factors),
                      velocity_dtype=(None if velocity_dtype == "f32"
                                      else velocity_dtype)),
        confusion_mode=confusion_mode,
        compute_dtype=None if compute_dtype == "f32" else compute_dtype)
    trainer = Trainer(net, cfg, transform, feaparams["start_frm_ext"],
                      feaparams["end_frm_ext"], device=dev)
    if cfg.objective == "xent":
        trainer.stats.confusion_mode = confusion_mode
        trainer.stats.label_map_file = p_label_map

    print(f"===== TNET {'CROSSVALIDATION' if crossval else 'TRAINING'} STARTED =====")
    print(f"Objective function: {'Xent' if cfg.objective == 'xent' else 'Mse'}")
    if not crossval:
        print(f"Learning rate: {learning_rate:g}")
    sys.stdout.flush()

    t0 = time.time()

    def utterance_iter():
        for feats, labs in read_utterances(reader, entries, labels_repo,
                                           feaparams["start_frm_ext"],
                                           feaparams["end_frm_ext"]):
            if trace & 2:
                print(".", end="", flush=True)
            yield feats, labs

    enable_from_trace(trace)
    if p_resume:
        trainer.load_state(p_resume)
    trainer.run_epoch(utterance_iter())
    if p_save:
        trainer.save_state(p_save)

    if not crossval:
        out_net = trainer.updated_network()
        if p_targetmmf:
            out_net.write(p_targetmmf)
        elif p_trg_dir or p_trg_ext:
            from ..io.htk import make_htk_filename
            out_net.write(make_htk_filename(p_source_mmf, p_trg_dir, p_trg_ext))
        else:
            print("WARNING: no target model specified, not saving",
                  file=sys.stderr)

    print()
    print(f"===== TNET FINISHED ( {time.time() - t0:.1f}s ) =====")
    print(trainer.report(), end="")
    print(trainer.throughput_report(), end="")
    if profiler.enabled:
        print(profiler.report(), end="")
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

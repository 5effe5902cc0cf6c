"""TRecurrent — recurrent-net trainer CLI on one CUDA device (port of
nnet_asr_tpu/tools/trecurrent.py, TRecurrentCu.cc).

The same option surface (SNAME "TNET", ``--BPTT`` order, per-utterance
history reset, ``--FRAMESERIAL`` for the reference's one-update-per-frame
trajectory); by default each utterance trains as segments of K frames with
truncated BPTT (``train/recurrent.py``). ``BUNCHSIZE``, ``CACHESIZE``,
``RANDOMIZE`` and ``SEED`` are accepted and discarded, as the reference
does (TRecurrentCu.cc:218-220).

The device comes from ``--GPUSELECT`` as in the port's tnet (-1 means
``cuda:0``) and the run raises without CUDA; only ``main(argv,
device="cpu")`` runs on the CPU.

    python -m nnet_asr_torch.tools.trecurrent -H rec.mmf -I labs.mlf \\
        -L '*/' -X lab -S train.scp -m label_map -n 0.06 --BPTT=4 \\
        --TARGETMMF=rec1.mmf
"""

from __future__ import annotations

import sys
import time

from ..io.labels import LabelRepository
from ..io.scp import parse_scp_entry, read_scp
from ..utils.config import UserInterface

from .. import __version__
from ..device import DeviceLike, gpuselect_device, resolve_device
from ..models.network import Network
from ..train.pipeline import TransformPipeline
from ..train.recurrent import RecurrentTrainer, RecurrentTrainerConfig
from ..train.sgd import SgdConfig

OPTION_STRING = (
    " -c n   CROSSVALIDATE=TRUE"
    " -m r   OUTPUTLABELMAP"
    " -n r   LEARNINGRATE"
    " -D n   PRINTCONFIG=TRUE"
    " -H l   SOURCEMMF"
    " -I r   SOURCEMLF"
    " -L r   SOURCETRANSCDIR"
    " -S l   SCRIPT"
    " -T r   TRACE"
    " -V n   PRINTVERSION=TRUE"
    " -X r   SOURCETRANSCEXT"
)

SNAME = "TNET"   # TRecurrentCu.cc:51 uses the TNET namespace


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
    p_label_map = ui.get_str("OUTPUTLABELMAP")
    p_mlf = ui.get_str("SOURCEMLF")
    p_lbl_dir = ui.get_str("SOURCETRANSCDIR")
    p_lbl_ext = ui.get_str("SOURCETRANSCEXT", "lab")
    learning_rate = ui.get_flt("LEARNINGRATE", 0.06)
    lr_factors = ui.get_str("LEARNRATEFACTORS", None)
    momentum = ui.get_flt("MOMENTUM", 0.0)
    weightcost = ui.get_flt("WEIGHTCOST", 0.0)
    bptt = ui.get_int("BPTT", 4)
    crossval = ui.get_bool("CROSSVALIDATE", False)
    frame_serial = ui.get_bool("FRAMESERIAL", False)
    trace = ui.get_int("TRACE", 0)
    gpuselect = ui.get_int("GPUSELECT", -1)
    # CE only, as in the reference's actual use
    ui.get_enum("OBJECTIVEFUNCTION", "ent", ["ent"])
    # read and discarded, as the reference does (TRecurrentCu.cc:218-220)
    ui.get_int("BUNCHSIZE", 256)
    ui.get_int("CACHESIZE", 12800)
    ui.get_bool("RANDOMIZE", True)
    ui.get_int("SEED", 0)
    if not ui.get_bool("MLFTRANSC", True):
        print("WARNING: --MLFTRANSC=FALSE (per-file transcriptions) is not "
              "supported; labels come from the -I MLF", file=sys.stderr)
    if ui.get_bool("PRINTCONFIG", False):
        ui.print_config()
    if ui.get_bool("PRINTVERSION", False):
        print(f"\n======= TRECURRENT v{__version__} (nnet_asr_torch) =======\n")
    ui.check_command_line_param_use()

    for req, msg in ((p_source_mmf, "Source MMF must be specified [-H]"),
                     (p_mlf, "Source mlf file is missing [-I]"),
                     (p_label_map, "Output label map is missing [-m]")):
        if req is None:
            raise SystemExit(msg)

    net = Network.read(p_source_mmf)
    if not net.has_recurrent():
        print("WARNING: network has no <recurrent> layer", file=sys.stderr)
    dev = gpuselect_device(gpuselect) if device is None else resolve_device(device)
    transform = Network.read(p_transform) if p_transform else None
    pipe = TransformPipeline(transform, feaparams["start_frm_ext"],
                             feaparams["end_frm_ext"], device=dev)
    labels_repo = LabelRepository(p_mlf, p_label_map, p_lbl_dir, p_lbl_ext)

    entries = read_scp(p_script) if p_script else []
    for extra in argv[args_parsed:]:
        entries.append(parse_scp_entry(extra))

    cfg = RecurrentTrainerConfig(
        bptt_order=bptt, crossvalidate=crossval,
        frame_serial=frame_serial and not crossval,
        sgd=SgdConfig(learning_rate=learning_rate, momentum=momentum,
                      weightcost=weightcost, grad_div_frm=False,
                      lr_factors=SgdConfig.parse_factors(lr_factors)))
    trainer = RecurrentTrainer(net, cfg, device=dev)

    print(f"===== TRecurrent {'CROSSVAL' if crossval else 'TRAINING'} STARTED =====")
    t0 = time.time()
    frames = 0
    for e in entries:
        feats = pipe([reader.read(e.physical, e.logical)])[0]
        labs = labels_repo.get_frame_labels(
            feats.shape[0], reader.last_header.sample_period, e.logical)
        if cfg.frame_serial:
            trainer.train_utterance_serial(feats, labs)
        else:
            trainer.train_utterance(feats, labs)
        frames += feats.shape[0]
        if trace & 2:
            print(".", end="", flush=True)

    if not crossval and p_targetmmf:
        trainer.updated_network().write(p_targetmmf)

    dt = time.time() - t0
    fps = frames / max(dt, 1e-9)
    print(f"\n===== TRecurrent FINISHED ( {dt:.1f}s ) "
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

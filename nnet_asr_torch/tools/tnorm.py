"""TNorm — compute feature-normalization layers (port of nnet_asr_tpu/tools/tnorm.py).

Forwards the training set through the transform network on one device,
accumulates float64 mean/variance of the (halo-trimmed) outputs on the
host, and writes a ``<bias>`` (-mean) + ``<window>`` (1/stddev)
normalization network (TNorm.cc:207-305).

Parity note: the reference divides the accumulated sums by the count of
*extended* frames (``framesN += feats_host.Rows()``, TNorm.cc:260) while
accumulating only trimmed rows; this tool does the same, as the JAX one.

The device comes from ``--GPUSELECT`` as in the port's tnet (-1 means
``cuda:0``) and the run raises without CUDA; only ``main(argv,
device="cpu")`` runs on the CPU.

    python -m nnet_asr_torch.tools.tnorm -H transform -S train.scp \\
        --STARTFRMEXT=25 --ENDFRMEXT=25 --TARGETMMF=norm.mmf
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..io.mmf import write_vector
from ..io.scp import parse_scp_entry, read_scp
from ..utils.config import UserInterface

from .. import __version__
from ..device import DeviceLike, gpuselect_device, resolve_device
from ..models.network import Network
from ..train.pipeline import TransformPipeline

OPTION_STRING = (
    " -H l   SOURCEMMF"
    " -D n   PRINTCONFIG=TRUE"
    " -S l   SCRIPT"
    " -T r   TRACE"
    " -V n   PRINTVERSION=TRUE"
)

SNAME = "TNORM"


def main(argv=None, device: DeviceLike = None) -> int:
    """Run the tool. ``device`` overrides ``--GPUSELECT`` (the tests pass "cpu")."""
    argv = list(sys.argv if argv is None else argv)
    ui = UserInterface()
    args_parsed = ui.parse_options(argv, OPTION_STRING, SNAME)

    reader, feaparams = ui.make_feature_reader()
    # the reference passes the transform as -H SOURCEMMF (TNorm.cc:142);
    # FEATURETRANSFORM is accepted as an alias
    p_transform = ui.get_str("SOURCEMMF") or ui.get_str("FEATURETRANSFORM")
    p_targetmmf = ui.get_str("TARGETMMF")
    p_script = ui.get_str("SCRIPT")
    ui.get_int("TRACE", 0)
    gpuselect = ui.get_int("GPUSELECT", -1)
    if ui.get_bool("PRINTCONFIG", False):
        ui.print_config()
    if ui.get_bool("PRINTVERSION", False):
        print(f"\n======= TNORM v{__version__} (nnet_asr_torch) =======\n")
    ui.check_command_line_param_use()

    if p_targetmmf is None:
        raise SystemExit("Target MMF file must be specified [--TARGETMMF]")
    transform = Network.read(p_transform) if p_transform else None

    entries = read_scp(p_script) if p_script else []
    for extra in argv[args_parsed:]:
        entries.append(parse_scp_entry(extra))

    dev = gpuselect_device(gpuselect) if device is None else resolve_device(device)
    pipe = TransformPipeline(transform, feaparams["start_frm_ext"],
                             feaparams["end_frm_ext"], device=dev)

    print("===== TNorm STARTED =====")
    t0 = time.time()
    first = None
    second = None
    frames_n = 0
    step = max(len(entries) // 100, 1)
    for cnt, e in enumerate(entries):
        feats = reader.read(e.physical, e.logical)
        out = pipe([feats])[0].to("cpu", torch.float64).numpy()
        if first is None:
            first = np.zeros(out.shape[1])
            second = np.zeros(out.shape[1])
        first += out.sum(axis=0)
        second += (out * out).sum(axis=0)
        if not (np.isfinite(first).all() and np.isfinite(second).all()):
            raise SystemExit(f"nan/inf in accumulators, utterance {e.logical}")
        # the reference counts the *extended* rows (TNorm.cc:260)
        frames_n += feats.shape[0]
        if cnt % step == 0:
            print(f"{100 * (cnt + 1) // len(entries)}%, ", end="", flush=True)

    mean = first / frames_n
    variance = second / frames_n - mean * mean
    bias = -mean
    window = 1.0 / np.sqrt(variance)

    dim = len(mean)
    with open(p_targetmmf, "w") as f:
        f.write(f"<bias> {dim} {dim}\n")
        write_vector(f, bias.astype(np.float32))
        f.write("\n")
        f.write(f"<window> {dim} {dim}\n")
        write_vector(f, window.astype(np.float32))
        f.write("\n")

    dt = time.time() - t0
    fps = frames_n / max(dt, 1e-9)
    print(f"\n\n===== TNorm FINISHED ( {dt:.2f}s ) "
          f"[FPS:{fps:.1f},RT:{1.0 / (fps / 100.0):.4f}] =====")
    print(f"frames: {frames_n}, max_bias: {bias.max():.6g}, "
          f"max_window: {window.max():.6g}, min_window: {window.min():.6g}")
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

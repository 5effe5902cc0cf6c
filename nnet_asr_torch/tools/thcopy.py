"""THCopy — native HCopy-equivalent feature extraction CLI.

The reference recipe's wav→features stage is delegated to HTK's HCopy
(examples/02train_MLP3_newbob_timit/prepare_timit/hcopy23mel_16k_0.sh and
RUN_IT_ALL.sh; SURVEY.md §2.8); HTK ships with neither repo, so this tool
makes the pipeline self-contained: it accepts the same config vocabulary
(SOURCEKIND/SOURCEFORMAT/SOURCERATE/BYTEORDER, TARGETKIND, NUMCHANS,
USEPOWER, USEHAMMING, PREEMCOEF, TARGETRATE, WINDOWSIZE, LOFREQ/HIFREQ,
NUMCEPS, CEPLIFTER, DELTAWINDOW/ACCWINDOW, ENORMALISE/ESCALE/SILFLOOR,
ZMEANSOURCE, SAVEWITHCRC) and the same 2-column ``src dst`` script files,
and writes HTK feature files (ops/mfcc.py front end, io/htk.py writer).

    python -m nnet_asr_torch.tools.thcopy -T 1 -C cfg -S pairs.scp
    python -m nnet_asr_torch.tools.thcopy -C cfg src.wav dst.fea

The port's copy of ``nnet_asr_tpu/tools/thcopy.py``, behaviour unchanged.
"""

from __future__ import annotations

import sys
import time

from ..io.htk import write_htk_file
from ..ops.mfcc import Frontend, FrontendConfig
from ..utils.config import UserInterface

OPTION_STRING = (
    " -D n   PRINTCONFIG=TRUE"
    " -S l   SCRIPT"
    " -T r   TRACE"
    " -V n   PRINTVERSION=TRUE"
)

SNAME = "THCOPY"


def read_pairs_scp(path):
    """2-column HCopy script: source target per line."""
    pairs = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split()
            if len(parts) != 2:
                raise ValueError(
                    f"HCopy script line needs 'src dst', got: {ln!r}")
            pairs.append((parts[0], parts[1]))
    return pairs


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    ui = UserInterface()
    args_parsed = ui.parse_options(argv, OPTION_STRING, SNAME)

    source_kind = ui.get_str("SOURCEKIND", "WAVEFORM").upper()
    source_format = ui.get_str("SOURCEFORMAT", "HTK").upper()
    byte_order = ui.get_str("BYTEORDER")
    natural = ui.get_bool("NATURALREADORDER", False)
    cfg = FrontendConfig(
        # (HTK's default is ANON = copy-through; an extraction tool needs
        # a real spectral target, so default to the recipe's alternative)
        target_kind=ui.get_str("TARGETKIND", "MFCC_0_D_A"),
        source_rate=ui.get_flt("SOURCERATE", 625.0),
        target_rate=ui.get_flt("TARGETRATE", 100000.0),
        window_size=ui.get_flt("WINDOWSIZE", 250000.0),
        use_hamming=ui.get_bool("USEHAMMING", True),
        preemcoef=ui.get_flt("PREEMCOEF", 0.97),
        zmean_source=ui.get_bool("ZMEANSOURCE", False),
        use_power=ui.get_bool("USEPOWER", False),
        numchans=ui.get_int("NUMCHANS", 20),
        lofreq=ui.get_flt("LOFREQ", -1.0),
        hifreq=ui.get_flt("HIFREQ", -1.0),
        numceps=ui.get_int("NUMCEPS", 12),
        ceplifter=ui.get_int("CEPLIFTER", 22),
        raw_energy=ui.get_bool("RAWENERGY", True),
        enormalise=ui.get_bool("ENORMALISE", True),
        escale=ui.get_flt("ESCALE", 0.1),
        silfloor=ui.get_flt("SILFLOOR", 50.0),
        deltawindow=ui.get_int("DELTAWINDOW", 2),
        accwindow=ui.get_int("ACCWINDOW", 2),
        thirdwindow=ui.get_int("THIRDWINDOW", 2),
    )
    ui.get_str("TARGETFORMAT", "HTK")      # only HTK output exists
    if ui.get_bool("SAVEWITHCRC", False):
        print("WARNING: SAVEWITHCRC has no effect: THCopy writes no CRC "
              "(the readers never verify one either — io/htk.py)",
              file=sys.stderr)
    p_script = ui.get_str("SCRIPT")
    trace = ui.get_int("TRACE", 0)
    if ui.get_bool("PRINTVERSION", False):
        from .. import __version__
        print(f"Version: {__version__} (nnet_asr_torch)")
    if ui.get_bool("PRINTCONFIG", False):
        ui.print_config()
    ui.check_command_line_param_use()

    if source_kind != "WAVEFORM":
        raise SystemExit(f"THCopy extracts from WAVEFORM sources only "
                         f"(SOURCEKIND={source_kind})")

    pairs = read_pairs_scp(p_script) if p_script else []
    extra = argv[args_parsed:]
    if extra:
        if len(extra) != 2:
            raise SystemExit("usage: thcopy [options] src dst")
        pairs.append((extra[0], extra[1]))
    if not pairs:
        raise SystemExit("No files to process (missing -S / src dst)")

    fe = Frontend(cfg)
    t0 = time.time()
    frames = 0
    for src, dst in pairs:
        if source_format == "NOHEAD":
            from ..io.wav import read_raw
            # Reference semantics (TFeaCat.cc:139): swap = !GetBool(
            # NATURALREADORDER, IsBigEndian()) — NATURALREADORDER=TRUE on
            # x86 means machine-natural little-endian; otherwise BYTEORDER
            # decides (VAX=little), defaulting to HTK's big-endian when
            # neither is set.
            if natural:
                order = "le"
            elif byte_order is not None:
                order = byte_order
            else:
                order = "be"
            samples = read_raw(src, order)
            period = cfg.source_rate
        elif source_format in ("WAV", "WAVE", "RIFF"):
            from ..io.wav import read_wav
            samples, rate = read_wav(src)
            period = 1.0e7 / rate
            if abs(period - cfg.source_rate) > 0.5:
                raise SystemExit(
                    f"{src}: WAV rate {rate}Hz does not match SOURCERATE="
                    f"{cfg.source_rate:g} ({1e7 / cfg.source_rate:.0f}Hz)")
        elif source_format in ("NIST", "SPHERE"):
            from ..io.wav import read_sphere
            samples, rate = read_sphere(src)
            period = 1.0e7 / rate
            if abs(period - cfg.source_rate) > 0.5:
                raise SystemExit(
                    f"{src}: SPHERE rate {rate}Hz does not match "
                    f"SOURCERATE={cfg.source_rate:g} "
                    f"({1e7 / cfg.source_rate:.0f}Hz)")
        elif source_format == "HTK":
            from ..io.wav import read_htk_waveform
            samples, period = read_htk_waveform(src, not natural)
            if abs(period - cfg.source_rate) > 0.5:
                raise SystemExit(
                    f"{src}: HTK sample period {period} != SOURCERATE="
                    f"{cfg.source_rate:g}")
        else:
            raise SystemExit(f"Unknown SOURCEFORMAT: {source_format}")
        feats = fe.extract(samples)
        write_htk_file(dst, feats, fe.kind, fe.sample_period)
        frames += feats.shape[0]
        if trace & 1:
            print(f"{src} -> {dst} [{feats.shape[0]} frames x "
                  f"{feats.shape[1]}]", flush=True)

    dt = time.time() - t0
    print(f"===== THCOPY FINISHED ( {dt:.1f}s ) ===== "
          f"{len(pairs)} files, {frames} frames "
          f"[FPS:{frames / max(dt, 1e-9):.1f}]")
    return 0


def _cli():
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

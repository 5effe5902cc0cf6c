"""TSegmenter — stage feature files to local scratch (TSegmenter.cc
equivalent).

Copies (ranges of) feature files listed in an SCP to a local directory and
rewrites the SCP to point at the copies — cluster staging for per-host
input pipelines (the SGE copy_local.sh workflow of the reference).

The port's copy of ``nnet_asr_tpu/tools/tsegmenter.py``, behaviour unchanged.
"""

from __future__ import annotations

import os
import shutil
import sys

from ..io import htk
from ..io.htk import FeatureReader
from ..io.scp import read_scp
from ..utils.config import UserInterface

OPTION_STRING = (
    " -S l   SCRIPT"
    " -T r   TRACE"
    " -A n   PRINTCONFIG=TRUE"
    " -D n   PRINTCONFIG=TRUE"
    " -V n   PRINTVERSION=TRUE"
)

SNAME = "TSEGMENTER"


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    ui = UserInterface()
    ui.parse_options(argv, OPTION_STRING, SNAME)

    p_script = ui.get_str("SCRIPT")
    p_outdir = ui.get_str("TARGETPARAMDIR")
    p_outscp = ui.get_str("TARGETSCRIPT")
    extract = ui.get_bool("EXTRACTSEGMENTS", True)
    ui.get_int("TRACE", 0)
    # NOSUBDIRS (TSegmenter.cc:154, 223-228): by default staged files
    # bucket into numbered 000000/ 000001/ ... subdirs per 1000 files so
    # scratch dirs stay listable; NOSUBDIRS=TRUE writes a flat directory
    subdirs = not ui.get_bool("NOSUBDIRS", False)
    big_endian = not ui.get_bool("NATURALREADORDER",
                                 sys.byteorder == "big")
    if ui.get_bool("PRINTCONFIG", False):
        print()
        ui.print_config()
        print()
    if ui.get_bool("PRINTVERSION", False):
        from .. import __version__
        print(f"\n======= TSEGMENTER v{__version__} (nnet_asr_torch) =======\n")
    ui.check_command_line_param_use()

    if p_script is None or p_outdir is None or p_outscp is None:
        raise SystemExit(
            "Need [-S script], [--TARGETPARAMDIR], [--TARGETSCRIPT]")
    os.makedirs(p_outdir, exist_ok=True)

    entries = read_scp(p_script)
    lines = []
    for cnt, e in enumerate(entries):
        base, s, t = FeatureReader.split_range(e.physical)
        out_dir = p_outdir
        if subdirs:
            out_dir = os.path.join(p_outdir, f"{cnt // 1000:06d}")
            os.makedirs(out_dir, exist_ok=True)
        dst = os.path.join(out_dir, os.path.basename(base))
        if s is not None and extract:
            # materialize just the segment as its own file
            data, hdr = htk.read_htk_file(base, big_endian)
            seg = data[s:t + 1]
            root, ext = os.path.splitext(dst)
            dst = f"{root}.{s}_{t}{ext}"
            htk.write_htk_file(dst, seg, hdr.sample_kind, hdr.sample_period,
                               big_endian)
            lines.append(f"{e.logical}={dst}")
        else:
            if not os.path.exists(dst):
                shutil.copy(base, dst)
            rng = f"[{s},{t}]" if s is not None else ""
            lines.append(f"{e.logical}={dst}{rng}")
    with open(p_outscp, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"TSegmenter: staged {len(entries)} entries to {p_outdir}")
    return 0


def _cli():
    """Reference-style top-level error handling (TNet.cc:371-376)."""
    import sys
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

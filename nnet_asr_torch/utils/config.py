"""HTK/STK-style option parsing compatible with the reference tools.

Re-implements KaldiLib/UserInterface.{h,cc} behavior so the reference's
shell drivers (tools/train/training_scheduler.sh etc.) can run this
framework's CLI tools unmodified:
  - short options declared per-tool in a descriptor string
    (``" -n r LEARNINGRATE"`` syntax; formats: n=flag, r=required arg,
    l=list arg appended on repeat, o=optional arg) — UserInterface.cc:148-346
  - ``--PARAM=VALUE`` long options namespaced as ``TOOL:PARAM``
  - ``-C file`` config files in HTK syntax (``TOOL:PARAM = value``,
    '#' comments) — UserInterface.cc:22-140
  - ``-A`` echoes argv, ``-D`` prints the resolved configuration
  - typed getters with defaults and an unused-parameter check that errors
    on typos (UserInterface.h:33-35)
  - GetFeatureParams: the standard feature-pipeline parameter bundle
    (UserInterface.cc:352-460)

The port's copy of ``nnet_asr_tpu/utils/config.py``, behaviour unchanged.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Dict, List, Optional


def _is_option(s: str) -> bool:
    return len(s) >= 2 and s[0] == "-" and (s[1].isalpha() or s[1] == "-")


class UserInterface:
    def __init__(self):
        self._cfg: Dict[str, str] = {}     # UPPERCASE key -> value
        self._origin: Dict[str, str] = {}  # key -> where it came from
        self._used: set = set()
        self.tool = ""

    # ------------------------------------------------------------------
    # insertion
    # ------------------------------------------------------------------

    def _insert(self, key: str, value: str, origin: str) -> None:
        key = key.upper().replace("_", "").replace("-", "").strip()
        # ParseHTKString: quoted values arrive with their quotes when the
        # shell passes them through unsplit (e.g. -L '*/')
        v = value.strip()
        if len(v) >= 2 and v[0] == v[-1] and v[0] in "'\"":
            value = v[1:-1]
        self._cfg[key] = value
        self._origin[key] = origin

    def read_config(self, path: str) -> None:
        with open(path) as f:
            for raw in f:
                line = raw.split("#", 1)[0].strip()
                if not line:
                    continue
                if "=" not in line:
                    raise ValueError(f"Character '=' expected ({path}): {line}")
                key, value = line.split("=", 1)
                self._insert(key.strip(), value.strip(), f"config:{path}")

    # ------------------------------------------------------------------
    # command line
    # ------------------------------------------------------------------

    def parse_options(self, argv: List[str], option_map: str, tool: str) -> int:
        """Returns the index of the first non-option argument."""
        self.tool = tool.upper()

        # pass 1: -A echo
        for a in argv[1:]:
            if a == "--":
                break
            if a == "-A":
                print(" ".join(f"'{x}'" if (" " in x or "*" in x) else x
                               for x in argv))
                break

        # pass 2: -C config files
        i = 1
        while i < len(argv):
            a = argv[i]
            if a == "--":
                break
            if a.startswith("-C"):
                if len(a) > 2:
                    self.read_config(a[2:])
                elif i + 1 < len(argv) and not _is_option(argv[i + 1]):
                    i += 1
                    self.read_config(argv[i])
                else:
                    raise ValueError("Config file name expected after option '-C'")
            i += 1

        # pass 3: long options --PARAM=VALUE
        for a in argv[1:]:
            if a == "--":
                break
            if a.startswith("--"):
                body = a[2:]
                if "=" not in body:
                    raise ValueError(f"Character '=' expected after option '{a}'")
                key, value = body.split("=", 1)
                self._insert(f"{self.tool}:{key}", value, "cmdline")

        # pass 4: short options
        list_seen: set = set()
        optind = 1
        while optind < len(argv) and _is_option(argv[optind]):
            a = argv[optind]
            opt = a[1]
            optarg: Optional[str] = a[2:] if len(a) > 2 else None
            if opt == "-" and optarg is None:
                return optind + 1
            if opt in ("C", "-"):
                if optarg is None:
                    optind += 1
                optind += 1
                continue
            if opt == "A":
                optind += 1
                continue
            m = re.search(rf" -{re.escape(opt)}\s+(\S+)((?:\s+\S+)+)", option_map)
            if not m:
                raise ValueError(f"Invalid command line option '-{opt}'")
            fmt = m.group(1)
            # one parameter name per format char (UserInterface.cc option
            # maps like " -t ror PRUNING PRUNINGINC PRUNINGMAX"); stop at
            # the next option's " -x" token
            names = []
            for tok in m.group(2).split():
                if tok.startswith("-") or len(names) >= len(fmt):
                    break
                names.append(tok)
            if len(names) < len(fmt):
                raise ValueError(
                    f"Option map entry for '-{opt}' lists {len(names)} "
                    f"parameter names for format '{fmt}'")
            for f, param in zip(fmt, names):
                if f == "n":
                    if "=" in param:
                        k, v = param.split("=", 1)
                    else:
                        k, v = param, "TRUE"
                    self._insert(f"{self.tool}:{k}", v, "cmdline")
                elif f in "rlo":
                    if optarg is None:
                        if optind + 1 >= len(argv) or _is_option(argv[optind + 1]):
                            if f in "rl":
                                raise ValueError(
                                    f"Argument of option '-{opt}' expected")
                            break
                        optind += 1
                        optarg = argv[optind]
                    if f == "l" and opt in list_seen:
                        prev = self.get_str(param, "")
                        optarg = f"{prev},{optarg}"
                    list_seen.add(opt)
                    self._insert(f"{self.tool}:{param}", optarg, "cmdline")
                    optarg = None
                else:
                    raise ValueError(f"Invalid format char '{f}' in option map")
            optind += 1

        for j in range(optind, len(argv)):
            if _is_option(argv[j]):
                raise ValueError(
                    f"No option expected after first non-option argument "
                    f"'{argv[optind]}'")
        return optind

    # ------------------------------------------------------------------
    # getters
    # ------------------------------------------------------------------

    def _lookup(self, param: str) -> Optional[str]:
        p = param.upper().replace("_", "").replace("-", "")
        candidates = [p] if ":" in p else [f"{self.tool}:{p}", p]
        for key in candidates:
            if key in self._cfg:
                self._used.add(key)
                return self._cfg[key]
        return None

    def get_str(self, param: str, default=None):
        v = self._lookup(param)
        return default if v is None else v

    def get_int(self, param: str, default: int = 0) -> int:
        v = self._lookup(param)
        if v is None:
            return default
        # C strtol(str, 0) semantics: 0x.. hex, 0.. octal (e.g. -T 021)
        s = v.strip()
        neg = s.startswith("-")
        if neg:
            s = s[1:]
        if s.lower().startswith("0x"):
            val = int(s, 16)
        elif len(s) > 1 and s.startswith("0"):
            val = int(s, 8)
        else:
            val = int(s, 10)
        return -val if neg else val

    def get_flt(self, param: str, default: float = 0.0) -> float:
        v = self._lookup(param)
        return default if v is None else float(v)

    def get_bool(self, param: str, default: bool = False) -> bool:
        v = self._lookup(param)
        if v is None:
            return default
        u = v.strip().upper()
        if u in ("TRUE", "T", "1", "YES"):
            return True
        if u in ("FALSE", "F", "0", "NO"):
            return False
        raise ValueError(f"TRUE or FALSE expected for parameter {param} (got {v})")

    def get_enum(self, param: str, default: str, choices) -> str:
        v = self._lookup(param)
        if v is None:
            return default
        u = v.strip().lower()
        for c in choices:
            if u == c.lower():
                return c
        raise ValueError(f"Invalid value '{v}' for {param}; expected one of {choices}")

    # ------------------------------------------------------------------

    def print_config(self) -> None:
        print("Configuration Parameters[%d]" % len(self._cfg))
        for k in sorted(self._cfg):
            print(f"{'#' if k not in self._used else ' '} {k} = {self._cfg[k]}")

    def check_command_line_param_use(self) -> None:
        unseen = [k for k, o in self._origin.items()
                  if o == "cmdline" and k not in self._used]
        if unseen:
            raise ValueError(
                "Unexpected command-line parameter(s): " + ", ".join(unseen))

    # ------------------------------------------------------------------
    # feature-pipeline parameter bundle (UserInterface.cc:352-460)
    # ------------------------------------------------------------------

    def get_feature_params(self) -> dict:
        from ..io import htk as H

        out: dict = {}
        out["start_frm_ext"] = self.get_int("STARTFRMEXT", 0)
        out["end_frm_ext"] = self.get_int("ENDFRMEXT", 0)

        cmn_dir = self.get_str("CMEANDIR", None)
        cmn_mask = self.get_str("CMEANMASK", None)
        out["cmn_path"] = cmn_dir if cmn_mask is not None else None
        out["cmn_mask"] = cmn_mask
        cvn_dir = self.get_str("VARSCALEDIR", None)
        cvn_mask = self.get_str("VARSCALEMASK", None)
        out["cvn_path"] = cvn_dir if cvn_mask is not None else None
        out["cvn_mask"] = cvn_mask
        out["cvg_file"] = self.get_str("VARSCALEFN", None)

        target_kind = H.parse_parmkind(self.get_str("TARGETKIND", "ANON"))
        out["target_kind"] = target_kind

        dw = self.get_str("DERIVWINDOWS", None)
        if dw is not None:
            lens = [int(t, 0) for t in re.split(r"[ \t_]+", dw.strip()) if t]
            out["deriv_order"] = len(lens)
            out["deriv_win_lengths"] = lens
        else:
            deriv_order = (3 if target_kind & H.PARMKIND_T else
                           2 if target_kind & H.PARMKIND_A else
                           1 if target_kind & H.PARMKIND_D else 0)
            if deriv_order or target_kind != H.PARMKIND_ANON:
                out["deriv_order"] = deriv_order
                out["deriv_win_lengths"] = [
                    self.get_int("DELTAWINDOW", 2),
                    self.get_int("ACCWINDOW", 2),
                    self.get_int("THIRDWINDOW", 2)]
            else:
                out["deriv_order"] = -1
                out["deriv_win_lengths"] = None
        out["big_endian"] = not self.get_bool("NATURALREADORDER",
                                              sys.byteorder == "big")
        return out

    def make_feature_reader(self):
        from ..io.htk import FeatureReader

        p = self.get_feature_params()
        return FeatureReader(
            target_kind=p["target_kind"], deriv_order=p["deriv_order"],
            deriv_win_lengths=p["deriv_win_lengths"],
            start_frm_ext=p["start_frm_ext"], end_frm_ext=p["end_frm_ext"],
            cmn_path=p["cmn_path"], cmn_mask=p["cmn_mask"],
            cvn_path=p["cvn_path"], cvn_mask=p["cvn_mask"],
            cvg_file=p["cvg_file"], big_endian=p["big_endian"]), p

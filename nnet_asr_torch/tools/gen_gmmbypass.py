"""Generate a GMM-bypass HTK MMF for decoding posterior features.

Port of tools/decode/gen_HTK_gmmbypass.sh: each tied state gets a Gaussian
with 1e30 variances except unit variance at "its" posterior dimension and
zero mean, so HVite scores ``-0.5 * x_i^2`` = ``-0.5 * (-2 log p_i)`` =
``log p_i`` on TFeaCat's --GMMBYPASS features — NN posteriors drive the
HMM decode. The ``--state-sep`` option controls the state-tag convention
(the script used ``phone__N``; the bundled example label maps use
``phone_sN``).

The port's copy of ``nnet_asr_tpu/tools/gen_gmmbypass.py``, behaviour unchanged.
"""

from __future__ import annotations

import argparse
import re
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dict", help="state-tag list (the output label map)")
    ap.add_argument("out", help="output hmmdefs file")
    ap.add_argument("--variance", type=float, default=1.0,
                    help="variance at the own dimension (C)")
    ap.add_argument("--state-sep", default="__",
                    help="separator between phone and state number "
                         "('__' for phone__2, '_s' for phone_s2)")
    args = ap.parse_args(argv)

    with open(args.dict) as f:
        tags = f.read().split()
    n = len(tags)

    sep_re = re.compile(re.escape(args.state_sep) + r"(\d+)$")

    with open(args.out, "w") as f:
        f.write(f" ~o <VecSize> {n} <USER> \n")
        for i, tag in enumerate(tags):
            var = " ".join(str(args.variance) if j == i else "1e30"
                           for j in range(n))
            zeros = " ".join("0" for _ in range(n))
            f.write(f'~s "{tag}"\n    <Mean> {n}\n      {zeros}\n'
                    f'    <Variance> {n}\n      {var} \n    <GConst> 0\n')

        phones = []
        phone_states = {}
        for tag in tags:
            m = sep_re.search(tag)
            phone = tag[:m.start()] if m else tag
            if phone not in phone_states:
                phones.append(phone)
                phone_states[phone] = []
            phone_states[phone].append(tag)

        for phone in phones:
            states = phone_states[phone]
            ns = len(states) + 2
            f.write(f'~h "{phone}"\n <BeginHMM>\n   <NumStates> {ns}\n')
            for i, tag in enumerate(states):
                f.write(f'   <State> {i + 2} ~s "{tag}"\n')
            f.write(f"   <TransP> {ns}\n")
            for r in range(ns):
                row = ["0"] * ns
                if r == 0:
                    row[1] = "1"
                elif r < ns - 1:
                    row[r] = "0.5"
                    row[r + 1] = "0.5"
                f.write("      " + "   ".join(row) + "\n")
            f.write("   <EndHMM>\n")
    print(f"Wrote {args.out}: {n} states, {len(phones)} HMMs")
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

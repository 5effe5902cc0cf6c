"""Generate an HBuild-style phone-loop recognition network (SLF).

Replaces HTK's ``HBuild phonelist net`` in the decode recipe
(examples/01/decode.sh:38): a word-loop lattice — start !NULL fans out to
every phone, every phone joins an end !NULL that loops back — decodable by
STK SVite / HTK HVite.

The port's copy of ``nnet_asr_tpu/tools/gen_phone_loop.py``, behaviour unchanged.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("phonelist")
    ap.add_argument("out")
    args = ap.parse_args(argv)

    with open(args.phonelist) as f:
        phones = f.read().split()

    # unique start/end nodes (no in/out arcs) + inner loop nulls, like HBuild
    start = 0
    loop_in = 1
    first_phone = 2
    loop_out = first_phone + len(phones)
    end = loop_out + 1
    n = end + 1
    arcs = [(start, loop_in)]
    for i in range(len(phones)):
        arcs.append((loop_in, first_phone + i))
        arcs.append((first_phone + i, loop_out))
    arcs.append((loop_out, loop_in))   # loop back
    arcs.append((loop_out, end))

    with open(args.out, "w") as f:
        f.write("VERSION=1.0\n")
        f.write(f"N={n}\tL={len(arcs)}\n")
        f.write(f"I={start}\tW=!NULL\n")
        f.write(f"I={loop_in}\tW=!NULL\n")
        for i, p in enumerate(phones):
            f.write(f"I={first_phone + i}\tW={p}\n")
        f.write(f"I={loop_out}\tW=!NULL\n")
        f.write(f"I={end}\tW=!NULL\n")
        for j, (s, e) in enumerate(arcs):
            f.write(f"J={j}\tS={s}\tE={e}\n")
    print(f"Wrote {args.out}: {len(phones)} phones, {len(arcs)} arcs")
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

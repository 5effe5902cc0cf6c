"""Feature-transform generator: the ``hamm_dct`` subcommand.

The port's copy of the one subcommand of ``nnet_asr_tpu/tools/generators.py``
that it uses (``tools/synth_corpus.py`` builds example-01's transform with
it), with identical output: splice + transpose + per-band Hamming + DCT, as
the reference's tools/transform/gen_hamm_dct.py. The other generators stay
in the JAX package.

Usage: python -m nnet_asr_torch.tools.generators hamm_dct [options]
"""

from __future__ import annotations

import argparse
import math
import sys


def hamm_dct(args, out):
    din = args.dimIn
    ctx = 1 + args.startFrmExt + args.endFrmExt
    out.write(f"<expand> {din * ctx} {din}\n")
    out.write(f"v {ctx}\n")
    out.write(" ".join(str(i) for i in range(-args.startFrmExt,
                                             args.endFrmExt + 1)) + "\n\n")
    out.write(f"<transpose> {din * ctx} {din * ctx}\n{ctx}\n\n")
    out.write(f"<window> {din * ctx} {din * ctx}\n")
    out.write(f"v {din * ctx}\n")
    ham = [0.54 - 0.46 * math.cos(2 * math.pi * i / (ctx - 1))
           for i in range(ctx)]
    for _ in range(din):
        out.write(" ".join(repr(h) for h in ham) + "\n")
    out.write("\n")
    k = args.dctBaseCnt
    out.write(f"<blocklinearity> {din * k} {din * ctx}\n")
    out.write(f"m {k} {ctx}\n")
    for kk in range(k):
        out.write(" ".join(
            repr(math.sqrt(2.0 / ctx)
                 * math.cos(math.pi / ctx * kk * (n + 0.5)))
            for n in range(ctx)) + "\n")
    out.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="generators")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("hamm_dct")
    p.add_argument("--dimIn", type=int, required=True)
    p.add_argument("--startFrmExt", type=int, required=True)
    p.add_argument("--endFrmExt", type=int, required=True)
    p.add_argument("--dctBaseCnt", type=int, required=True)

    args = ap.parse_args(argv)
    hamm_dct(args, sys.stdout)
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

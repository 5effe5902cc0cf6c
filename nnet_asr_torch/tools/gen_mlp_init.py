"""Generate a random MLP initialization MMF (tools/init/gen_mlp_init.py port).

Python-3 re-implementation of the reference init generator
(the reference's tools/init/gen_mlp_init.py:35-70): emits
``<biasedlinearity>`` blocks with <sigmoid> between and <softmax> on top.
Adds ``--seed`` for reproducibility (the reference was unseeded).

The port's copy of ``nnet_asr_tpu/tools/gen_mlp_init.py``, behaviour unchanged.
"""

from __future__ import annotations

import argparse
import math
import random
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", required=True, help="d1:d2:d3 layer dimensions")
    ap.add_argument("--gauss", action="store_true",
                    help="use gaussian noise for weights")
    ap.add_argument("--negbias", action="store_true",
                    help="use uniform [-4.1,-3.9] for hidden bias")
    ap.add_argument("--inputscale", action="store_true",
                    help="scale weights by 3/sqrt(Ninputs)")
    ap.add_argument("--linBNdim", type=int, default=0,
                    help="dim of linear bottleneck")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)

    if args.seed is not None:
        random.seed(args.seed)

    dims = [int(d) for d in args.dim.split(":")]
    out = sys.stdout
    for layer in range(len(dims) - 1):
        di, do = dims[layer], dims[layer + 1]
        out.write(f"<biasedlinearity> {do} {di}\n")
        out.write(f"m {do} {di}\n")
        for _ in range(do):
            row = []
            for _ in range(di):
                if args.gauss:
                    if args.inputscale:
                        row.append(3 / math.sqrt(di) * random.gauss(0.0, 1.0))
                    else:
                        row.append(0.1 * random.gauss(0.0, 1.0))
                else:
                    if args.inputscale:
                        row.append((random.random() - 0.5) * 2 * 3 / math.sqrt(di))
                    else:
                        row.append(random.random() / 5.0 - 0.1)
            out.write(" ".join(repr(v) for v in row) + "\n")
        out.write(f"v {do}\n")
        vals = []
        for _ in range(do):
            if args.linBNdim == do or layer == len(dims) - 2:
                vals.append("0.0")
            elif args.negbias:
                vals.append(repr(random.random() / 5.0 - 4.1))
            else:
                vals.append("0.0")
        out.write(" ".join(vals) + "\n")
        if args.linBNdim != do:
            if layer == len(dims) - 2:
                out.write(f"<softmax> {do} {do}\n")
            else:
                out.write(f"<sigmoid> {do} {do}\n")
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

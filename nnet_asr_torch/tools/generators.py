"""Net-init and feature-transform generators (tools/init + tools/transform).

Python-3 re-implementations of the reference emitters with identical
output formats, plus ``--seed`` everywhere (the reference was unseeded):
  - rbm_init          (tools/init/gen_rbm_init.py)
  - recurrent_init    (tools/init/gen_recurrent_init.py)
  - sharedlinearity_init / discretelinearity_init
  - hamm_dct          (tools/transform/gen_hamm_dct.py: splice + transpose
                       + per-band Hamming + DCT)
  - splice            (tools/transform/gen_splice_frames_transf.py)
  - empty             (tools/transform/gen_empty_transf.py)
  - rbm2mlplayer      (tools/rbm2mlplayer/rbm2mlplayer.py)
  - lcrc_hamm_dct, rasta, netjoin

The port's copy of ``nnet_asr_tpu/tools/generators.py``: every subcommand
writes the same bytes for the same arguments and ``--seed``; ``netjoin``
and ``rbm2mlplayer`` read and write through the port's ``models/``.

Usage: python -m nnet_asr_torch.tools.generators <subcommand> [options]
"""

from __future__ import annotations

import argparse
import math
import random
import sys


def _dims(s):
    return [int(d) for d in s.split(":")]


def _w(args, din):
    if args.gauss:
        return 0.1 * random.gauss(0.0, 1.0)
    return random.random() / 5.0 - 0.1


def _bias(args):
    if args.negbias:
        return repr(random.random() / 5.0 - 4.1)
    return "0.0"


def rbm_init(args, out):
    d = _dims(args.dim)
    vis, hid = d[0], d[1]
    tag = "<rbm>" if float(args.sparsitycost) == 0.0 else "<rbmsparse>"
    out.write(f"{tag} {hid} {vis}\n")
    out.write(f"{'gauss' if args.vistype == 'gauss' else 'bern'} "
              f"{'gauss' if args.hidtype == 'gauss' else 'bern'}\n")
    out.write(f"m {hid} {vis}\n")
    for _ in range(hid):
        out.write(" ".join(repr(_w(args, vis)) for _ in range(vis)) + "\n")
    out.write(f"v {vis}\n")
    out.write(" ".join("0.0" if args.vistype == "gauss" else _bias(args)
                       for _ in range(vis)) + "\n")
    out.write(f"v {hid}\n")
    out.write(" ".join("0.0" if args.hidtype == "gauss" else _bias(args)
                       for _ in range(hid)) + "\n")


def recurrent_init(args, out):
    d = _dims(args.dim)
    for layer in range(len(d) - 1):
        di, do = d[layer], d[layer + 1]
        out.write(f"<recurrent> {do} {di}\n")
        out.write(f"m {do} {di + do}\n")
        for _ in range(do):
            out.write(" ".join(repr(_w(args, di)) for _ in range(di + do)) + "\n")
        out.write(f"v {do}\n")
        out.write(" ".join(_bias(args) for _ in range(do)) + "\n")


def sharedlinearity_init(args, out):
    d = _dims(args.dim)
    inst = _dims(args.inst)
    assert len(d) == len(inst) + 1
    for layer in range(len(d) - 1):
        di, do, k = d[layer], d[layer + 1], inst[layer]
        assert di % k == 0 and do % k == 0
        out.write(f"<sharedlinearity> {do} {di}\n{k}\n")
        out.write(f"m {do // k} {di // k}\n")
        for _ in range(do // k):
            out.write(" ".join(repr(_w(args, di)) for _ in range(di // k)) + "\n")
        out.write(f"v {do // k}\n")
        out.write(" ".join("0.0" if args.linBNdim == do else _bias(args)
                           for _ in range(do // k)) + "\n")
        if args.linBNdim != do:
            out.write(f"<sigmoid> {do} {do}\n")


def discretelinearity_init(args, out):
    d = _dims(args.dim)
    nb = args.blocks
    for layer in range(len(d) - 1):
        di, do = d[layer], d[layer + 1]
        assert di % nb == 0 and do % nb == 0
        out.write(f"<discretelinearity> {do} {di}\n{nb}\n")
        for _ in range(nb):
            out.write(f"m {do // nb} {di // nb}\n")
            for _ in range(do // nb):
                out.write(" ".join(repr(_w(args, di))
                                   for _ in range(di // nb)) + "\n")
        out.write(f"v {do}\n")
        out.write(" ".join(_bias(args) for _ in range(do)) + "\n")
        if layer == len(d) - 2:
            out.write(f"<softmax> {do} {do}\n")
        else:
            out.write(f"<sigmoid> {do} {do}\n")


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


def splice(args, out):
    din = args.dimIn
    ctx = 1 + args.startFrmExt + args.endFrmExt
    out.write(f"<expand> {din * ctx} {din}\n")
    out.write(f"v {ctx}\n")
    out.write(" ".join(str(i) for i in range(-args.startFrmExt,
                                             args.endFrmExt + 1)) + "\n\n")


def empty(args, out):
    out.write(f"<expand> {args.dimIn} {args.dimIn}\nv 1 0\n")


def lcrc_hamm_dct(args, out):
    """Left/right-context split DCT transform
    (tools/transform/gen_lcrc_hamm_dct.py)."""
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
    # LC to first half, RC to second half, middle frame copied twice
    out.write(f"<copy> {din * (ctx + 1)} {din * ctx}\n")
    out.write(f"v {din * (ctx + 1)}\n")
    for i in range(din):
        beg = 1 + i * ctx
        out.write(" ".join(str(v) for v in
                           range(beg, beg + args.startFrmExt + 1)) + "\n")
    for i in range(din):
        beg = args.startFrmExt + 1 + i * ctx
        out.write(" ".join(str(v) for v in
                           range(beg, beg + args.endFrmExt + 1)) + "\n")
    lc = args.startFrmExt + 1
    k = args.dctBaseCnt
    out.write(f"<blocklinearity> {din * 2 * k} {din * 2 * lc}\n")
    out.write(f"m {k} {lc}\n")
    for kk in range(k):
        out.write(" ".join(
            repr(math.sqrt(2.0 / lc) * math.cos(math.pi / lc * kk * (n + 0.5)))
            for n in range(lc)) + "\n")
    out.write("\n")


# FIR RASTA filter weights (tools/transform/gen_rasta.py:33)
_RASTA_COEF = [
    -0.00159062, -0.00169215, -0.00180016, -0.00191506, -0.0020373,
    -0.00216734, -0.00230568, -0.00245286, -0.00260942, -0.00277598,
    -0.00295317, -0.00314167, -0.0033422, -0.00355553, -0.00378248,
    -0.00402392, -0.00428076, -0.004554, -0.00484469, -0.00515392,
    -0.00548289, -0.00583287, -0.00620518, -0.00660125, -0.00702261,
    -0.00747086, -0.00794772, -0.00845502, -0.00899471, -0.00956884,
    -0.0101796, -0.0108294, -0.0115206, -0.012256, -0.0130383, -0.0138705,
    -0.0147558, -0.0156977, -0.0166997, -0.0177656, -0.0188996, -0.020106,
    -0.0213893, -0.0227546, -0.024207, -0.0257521, -0.0273959, 0.0772384,
    0.13536, 0.144, 0.1]


def rasta(args, out):
    """FIR RASTA filtering transform (tools/transform/gen_rasta.py)."""
    din = args.dimIn
    n = len(_RASTA_COEF)
    ctx = n          # history-only context
    out.write(f"<expand> {din * ctx} {din}\n")
    out.write(f"v {ctx}\n")
    out.write(" ".join(str(i) for i in range(-(n - 1), 1)) + "\n\n")
    out.write(f"<transpose> {din * ctx} {din * ctx}\n{ctx}\n\n")
    out.write(f"<sharedlinearity> {din} {din * ctx}\n{din}\n")
    out.write(f"m 1 {n}\n")
    out.write(" ".join(repr(c) for c in _RASTA_COEF) + "\n")
    out.write("v 1\n0.0 \n")


def netjoin(args, out):
    """Concatenate MMF networks; optionally trim after the bottleneck
    (tools/tnet2snet/tnet2snet.py's --bndim trimming, TNet output format)."""
    from ..models.network import Network, write_component

    layers = [layer for fn in args.infiles for layer in Network.read(fn).layers]
    if args.bndim > 0:
        cut = None
        for i, layer in enumerate(layers):
            if layer.n_outputs == args.bndim and layer.updatable:
                cut = i + 1
                break
        if cut is None:
            raise SystemExit(f"No updatable layer with output dim {args.bndim}")
        layers = layers[:cut]
    for layer in layers:
        write_component(out, layer)


def rbm2mlplayer(args, out):
    """Convert a trained <rbm> into a <biasedlinearity>(+<sigmoid>) layer."""
    from ..io.mmf import TokenStream
    from ..models.components import TAG_TO_TYPE, BiasedLinearity
    from ..models.network import write_component

    src = sys.stdin if args.infile == "-" else open(args.infile)
    ts = TokenStream(src)
    tag = ts.next().lower()
    if tag not in ("<rbm>", "<rbmsparse>"):
        raise SystemExit("missing <rbm> tag in header")
    hid, vis = int(ts.next()), int(ts.next())
    rbm = TAG_TO_TYPE[tag].read(vis, hid, ts)
    bl = BiasedLinearity(vis, hid).load_params(
        {"weight": rbm.weight.detach().numpy(), "bias": rbm.hid_bias.detach().numpy()})
    write_component(out, bl)
    if rbm.hid_type == "bern":
        out.write(f"<sigmoid> {hid} {hid}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="generators")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--gauss", action="store_true")
        p.add_argument("--negbias", action="store_true")
        p.add_argument("--seed", type=int, default=None)

    p = sub.add_parser("rbm_init"); common(p)
    p.add_argument("--dim", required=True)
    p.add_argument("--hidtype", default="bern")
    p.add_argument("--vistype", default="bern")
    p.add_argument("--sparsitycost", default=0.0)

    p = sub.add_parser("recurrent_init"); common(p)
    p.add_argument("--dim", required=True)

    p = sub.add_parser("sharedlinearity_init"); common(p)
    p.add_argument("--dim", required=True)
    p.add_argument("--inst", required=True)
    p.add_argument("--linBNdim", type=int, default=0)

    p = sub.add_parser("discretelinearity_init"); common(p)
    p.add_argument("--dim", required=True)
    p.add_argument("--blocks", type=int, default=1)

    p = sub.add_parser("hamm_dct")
    p.add_argument("--dimIn", type=int, required=True)
    p.add_argument("--startFrmExt", type=int, required=True)
    p.add_argument("--endFrmExt", type=int, required=True)
    p.add_argument("--dctBaseCnt", type=int, required=True)

    p = sub.add_parser("splice")
    p.add_argument("--dimIn", type=int, required=True)
    p.add_argument("--startFrmExt", type=int, required=True)
    p.add_argument("--endFrmExt", type=int, required=True)

    p = sub.add_parser("empty")
    p.add_argument("--dimIn", type=int, required=True)

    p = sub.add_parser("lcrc_hamm_dct")
    p.add_argument("--dimIn", type=int, required=True)
    p.add_argument("--startFrmExt", type=int, required=True)
    p.add_argument("--endFrmExt", type=int, required=True)
    p.add_argument("--dctBaseCnt", type=int, required=True)

    p = sub.add_parser("rasta")
    p.add_argument("--dimIn", type=int, required=True)

    p = sub.add_parser("netjoin")
    p.add_argument("--bndim", type=int, default=0)
    p.add_argument("infiles", nargs="+")

    p = sub.add_parser("rbm2mlplayer")
    p.add_argument("infile")
    p.add_argument("outfile")

    args = ap.parse_args(argv)
    if getattr(args, "seed", None) is not None:
        random.seed(args.seed)

    out = sys.stdout
    close = False
    if args.cmd == "rbm2mlplayer" and args.outfile != "-":
        out = open(args.outfile, "w")
        close = True
    globals()[args.cmd](args, out)
    if close:
        out.close()
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

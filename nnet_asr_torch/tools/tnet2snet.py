"""tnet2snet — convert TNet MMF networks to the SNet/STK
``~x "NNetsFwdComplete"`` macro format.

Python-3 re-implementation of the reference converter
(tools/tnet2snet/tnet2snet.py) over the parsed Network: same layer
mapping — <biasedlinearity> → <Xform>+<Bias> (weights in the stored
transposed (out, in) orientation), <expand> → <Stacking>+<Copy> with
1-based column ranges, <sharedlinearity>/<blocklinearity>/<blocksoftmax>
→ <NumBlocks> blocks, activations/<window>/<bias>/<log> pass through —
plus the ``--bndim`` bottleneck trim (conversion stops after the first
layer whose output dim matches).

Usage: tnet2snet [--bndim=N] infile [infile2 ...] outfile
       ('-' is stdio on either end)

The port's version of ``nnet_asr_tpu/tools/tnet2snet.py``: the same
conversion over the port's ``models/`` (layers and their host float32
parameters from ``Network.to_numpy_params``).
"""

from __future__ import annotations

import sys

import numpy as np

from ..models import components as C
from ..models.network import Network


def _fmt(arr) -> str:
    a = np.asarray(arr, dtype=np.float32).ravel()
    return " ".join(f"{v:.9g}" for v in a)


def convert(nets, bndim: int = 0):
    """Returns [(header_line, data_block_or_'')] SNet layer list."""
    layers = []

    def emit(header, data=""):
        layers.append((header, data))

    done = False
    for net in nets:
        if done:
            break
        for spec, params in zip(net.layers, net.to_numpy_params()):
            if isinstance(spec, C.BiasedLinearity):
                w = np.asarray(params["weight"])        # (in, out) in memory
                emit(f"<Xform> {w.shape[1]} {w.shape[0]}", _fmt(w.T))
                b = np.asarray(params["bias"])
                emit(f"<Bias> {b.shape[0]}", _fmt(b))
            elif isinstance(spec, C.SharedLinearity):
                w = np.asarray(params["weight"])        # (in_b, out_b)
                b = np.asarray(params["bias"])
                k = spec.n_instances
                blocks = []
                for bl in range(k):
                    blocks.append(
                        f"<Block> {bl + 1}\n<NumLayers> 2\n"
                        f"<Layer> 1\n<XForm> {w.shape[1]} {w.shape[0]}\n"
                        f"{_fmt(w.T)}\n"
                        f"<Layer> 2\n<Bias> {b.shape[0]}\n{_fmt(b)}")
                emit(f"<NumBlocks> {k}", "\n".join(blocks) + "\n")
            elif isinstance(spec, C.BlockLinearity):
                blk = np.asarray(params["block"])       # (in_b, out_b)
                k = spec.n_inputs // spec.block_in
                blocks = []
                for bl in range(k):
                    blocks.append(
                        f"<Block> {bl + 1}\n"
                        f"<XForm> {blk.shape[1]} {blk.shape[0]}\n"
                        f"{_fmt(blk.T)}")
                emit(f"<NumBlocks> {k}", "\n".join(blocks) + "\n")
            elif isinstance(spec, C.Sigmoid):
                emit(f"<Sigmoid> {spec.n_outputs}")
            elif isinstance(spec, C.Softmax):
                emit(f"<Softmax> {spec.n_outputs}")
            elif isinstance(spec, C.BlockSoftmax):
                blocks = [f"<Block> {i + 1}\n<Softmax> {d}"
                          for i, d in enumerate(spec.dims)]
                emit(f"<NumBlocks> {len(spec.dims)}", "\n".join(blocks) + "\n")
            elif isinstance(spec, C.Expand):
                dim_in = spec.n_inputs
                ctx = spec.offsets
                lo, hi = min(ctx), max(ctx)
                depth = hi - lo + 1
                emit(f"<Stacking> {depth} {dim_in}")
                sel = " ".join(
                    f"{1 + (o - lo) * dim_in}:{(o - lo + 1) * dim_in}"
                    for o in ctx)
                emit(f"<Copy> {dim_in * len(ctx)} {dim_in * depth}",
                     sel + " ")
            elif isinstance(spec, C.Transpose):
                emit(f"<Transpose> {spec.context} "
                     f"{spec.n_inputs // spec.context}")
            elif isinstance(spec, C.Window):
                emit(f"<Window> {spec.n_outputs}",
                     _fmt(params["window"]))
            elif isinstance(spec, C.Bias):
                emit(f"<Bias> {spec.n_outputs}", _fmt(params["bias"]))
            elif isinstance(spec, C.Log):
                emit(f"<Log> {spec.n_outputs}")
            else:
                raise SystemExit(
                    f"tnet2snet: cannot convert component {spec.tag}")
            if bndim and spec.n_outputs == bndim:
                done = True
                break
    return layers


def write_snet(layers, out) -> None:
    out.write('~x "NNetsFwdComplete"\n')
    out.write(f"<NumLayers> {len(layers)}\n")
    for i, (header, data) in enumerate(layers):
        out.write(f"<Layer> {i + 1}\n")
        out.write(header + "\n")
        if data:
            out.write(data + "\n")


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)[1:]
    bndim = 0
    pos = []
    for a in argv:
        if a.startswith("--bndim"):
            bndim = int(a.split("=", 1)[1] if "=" in a else a[7:] or 0)
        else:
            pos.append(a)
    if len(pos) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    nets = [Network.read(p) for p in pos[:-1]]
    layers = convert(nets, bndim)
    if not layers:
        raise SystemExit("tnet2snet: no convertible layers found")
    if pos[-1] == "-":
        write_snet(layers, sys.stdout)
    else:
        with open(pos[-1], "w") as f:
            write_snet(layers, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

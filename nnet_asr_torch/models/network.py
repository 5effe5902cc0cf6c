"""Network = an ordered stack of components (port of nnet_asr_tpu/models/network.py).

Reads and writes the reference's ASCII MMF (TNetLib/Nnet.cc:162-354) through
the port's copy of the MMF reader (``io/mmf.py``), so either package reads the other's
files, and carries parameters across from and back to the JAX package's
layout (a list of dicts of numpy arrays).
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..io.mmf import TokenStream

from .components import TAG_TO_TYPE, Component, Params, Recurrent


def _to_numpy(v):
    """Tensors → host float32 numpy copies, keeping the list/dict nesting."""
    if isinstance(v, dict):
        return {k: _to_numpy(t) for k, t in v.items()}
    if isinstance(v, list):
        return [_to_numpy(t) for t in v]
    return v.detach().to("cpu", torch.float32).numpy().copy()


def read_components(ts: TokenStream, stop_tag: Optional[str] = None) -> List[Component]:
    """Parse ``<tag> nOutputs nInputs`` + params until EOF, ``stop_tag``
    (consumed) or an ``<endblock>`` (left for the caller)
    (Network::ComponentFactory, Nnet.cc:199-288)."""
    layers: List[Component] = []
    while True:
        tok = ts.peek()
        if tok is None:
            break
        tag = tok.lower()
        if stop_tag is not None and tag == stop_tag:
            ts.next()
            break
        if tag == "<endblock>":
            break
        if not (tag.startswith("<") and tag.endswith(">")):
            raise ValueError(f"Invalid component tag: {tok}")
        if tag not in TAG_TO_TYPE:
            raise ValueError(f"Unknown Component tag: {tok}")
        ts.next()
        n_outputs = int(ts.next())
        n_inputs = int(ts.next())
        if n_inputs <= 0 or n_outputs <= 0:
            raise ValueError(f"Bad dimensions for {tag}: {n_outputs} {n_inputs}")
        layers.append(TAG_TO_TYPE[tag].read(n_inputs, n_outputs, ts))
    return layers


def write_component(out, layer: Component) -> None:
    """``<tag> nOutputs nInputs`` + params (Nnet.cc:296-354)."""
    out.write(f"{layer.tag} {layer.n_outputs} {layer.n_inputs}\n")
    layer.write(out)


class Network(nn.Module):
    """An ordered feed-forward stack of components."""

    def __init__(self, layers: Sequence[Component]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    # -- constructors ------------------------------------------------------

    @classmethod
    def read(cls, source) -> "Network":
        """Read from a path, file object, or MMF text (parameters on the CPU)."""
        if isinstance(source, str) and "\n" not in source and "<" not in source:
            with open(source) as f:
                ts = TokenStream(f)
        else:
            ts = TokenStream(source)
        return cls(read_components(ts))

    def write(self, dest) -> None:
        if hasattr(dest, "write"):
            for layer in self.layers:
                write_component(dest, layer)
        else:
            with open(dest, "w") as f:
                self.write(f)

    def to_text(self) -> str:
        buf = io.StringIO()
        self.write(buf)
        return buf.getvalue()

    # -- parameters across packages ----------------------------------------

    def from_numpy_params(self, params: Sequence[Dict[str, np.ndarray]]) -> "Network":
        """Load the JAX package's params (a list of dicts of numpy arrays,
        one per layer) into this network's tensors, in place; returns self."""
        if len(params) != len(self.layers):
            raise ValueError(f"{len(params)} param dicts for {len(self.layers)} layers")
        for layer, p in zip(self.layers, params):
            layer.load_params(p)
        return self

    def to_numpy_params(self) -> List[Dict[str, object]]:
        """The parameters as the JAX package holds them (host float32
        arrays, in lists where it keeps lists)."""
        return [_to_numpy(layer.param_dict()) for layer in self.layers]

    # -- shape info --------------------------------------------------------

    @property
    def params(self) -> List[Params]:
        return [layer.param_dict() for layer in self.layers]

    @property
    def n_inputs(self) -> int:
        return self.layers[0].n_inputs if len(self.layers) else 0

    @property
    def n_outputs(self) -> int:
        return self.layers[-1].n_outputs if len(self.layers) else 0

    def check_dims(self) -> None:
        for a, b in zip(self.layers[:-1], self.layers[1:]):
            if a.n_outputs != b.n_inputs:
                raise ValueError(
                    f"Component dimension mismatch: {a.tag}({a.n_outputs}) "
                    f"→ {b.tag}({b.n_inputs})")

    # -- compute -----------------------------------------------------------
    # (overrides nn.Module.apply(fn): the JAX package's functional forward)
    def apply(self, params: Sequence[Params], x: torch.Tensor) -> torch.Tensor:
        """Forward over the whole stack with the given params (Nnet.cc:65-91)."""
        for layer, p in zip(self.layers, params):
            x = layer.apply(p, x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.params, x)

    def apply_upto(self, params: Sequence[Params], x: torch.Tensor,
                   n_layers: int) -> torch.Tensor:
        """Forward through the first ``n_layers`` layers."""
        return self.apply(params[:n_layers], x)

    def has_recurrent(self) -> bool:
        return any(isinstance(layer, Recurrent) for layer in self.layers)

    # -- streaming inference ----------------------------------------------

    def feedforward(self, x: torch.Tensor, start_frm_ext: int = 0, end_frm_ext: int = 0,
                    max_frames: int = 5000, block: int = 1024) -> torch.Tensor:
        """Blockwise forward for long utterances (Network::Feedforward,
        Nnet.cc:15-62): over ``max_frames`` rows, ``block``-row chunks run
        with ``start/end_frm_ext`` rows of halo on each side, so splicing
        stays exact, and the outputs are stitched with the halos trimmed."""
        T = x.shape[0]
        if T <= max_frames:
            return self(x)
        out = []
        for pos in range(0, T, block):
            end = min(pos + block, T)
            lo, hi = max(pos - start_frm_ext, 0), min(end + end_frm_ext, T)
            y = self(x[lo:hi])
            out.append(y[pos - lo:y.shape[0] - (hi - end)])
        return torch.cat(out, dim=0)

"""Network = an ordered stack of components (port of nnet_asr_tpu/models/network.py).

Reads and writes the reference's ASCII MMF (TNetLib/Nnet.cc:162-354) through
the port's copy of the MMF reader (``io/mmf.py``), so either package reads the other's
files, and carries parameters across from and back to the JAX package's
layout (a list of dicts of numpy arrays).
"""

from __future__ import annotations

import io
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from ..io.mmf import TokenStream

from .components import TAG_TO_TYPE, UNPORTED_TAGS, Component, Params


def read_components(ts: TokenStream) -> List[Component]:
    """Parse ``<tag> nOutputs nInputs`` + params until EOF
    (Network::ComponentFactory, Nnet.cc:199-288)."""
    layers: List[Component] = []
    while True:
        tok = ts.peek()
        if tok is None:
            break
        tag = tok.lower()
        if not (tag.startswith("<") and tag.endswith(">")):
            raise ValueError(f"Invalid component tag: {tok}")
        if tag in UNPORTED_TAGS:
            raise NotImplementedError(
                f"Component {tag} is not ported to nnet_asr_torch yet "
                f"(ROADMAP.md {UNPORTED_TAGS[tag]})")
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

    def to_numpy_params(self) -> List[Dict[str, np.ndarray]]:
        """The parameters as the JAX package holds them (host float32)."""
        return [{k: v.detach().to("cpu", torch.float32).numpy().copy()
                 for k, v in layer.param_dict().items()} for layer in self.layers]

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

"""Network components as ``nn.Module``s (port of nnet_asr_tpu/models/components.py).

Each component keeps the JAX package's parameter names and layouts, so
parameters cross between the packages as numpy arrays unchanged: an affine
``weight`` is (in, out) and the MMF file stores its transpose
(TNetLib/BiasedLinearity.cc:37-58). Trainable entries are ``nn.Parameter``s,
the constant vectors of the feature-transform tags are buffers.

``apply(params, x)`` is the functional forward over a dict of tensors, as
in JAX; ``forward(x)`` applies the module's own parameters. MMF text is
read and written through the port's copy of the MMF reader, ``io/mmf.py``.

Ported tags: the trained MLP (<biasedlinearity>, <sigmoid>, <softmax>) and
the linear transform tags that ``ops.fold_affine`` folds (<expand>,
<copy>, <transpose>, <blocklinearity>, <bias>, <window>,
<sharedlinearity>). The other tags of the JAX package raise
NotImplementedError when read.
"""

from __future__ import annotations

from typing import Dict, TextIO, Tuple

import numpy as np
import torch
from torch import nn

from ..io import mmf
from ..io.mmf import TokenStream

Params = Dict[str, torch.Tensor]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


class Component(nn.Module):
    """One layer: static dims + its parameter tensors."""

    tag = ""
    updatable = False                          # participates in SGD
    trainable_keys: Tuple[str, ...] = ()       # entries that get gradients
    param_keys: Tuple[str, ...] = ()           # all entries, in JAX order

    def __init__(self, n_inputs: int, n_outputs: int):
        super().__init__()
        self.n_inputs = n_inputs
        self.n_outputs = n_outputs

    def _init_params(self, shapes: Dict[str, Tuple[int, ...]]) -> None:
        """Zero tensors of the given shapes: trainable keys as Parameters,
        the rest as buffers."""
        for k, shape in shapes.items():
            t = torch.zeros(shape, dtype=torch.float32)
            if k in self.trainable_keys:
                self.register_parameter(k, nn.Parameter(t))
            else:
                self.register_buffer(k, t)

    def param_dict(self) -> Params:
        return {k: getattr(self, k) for k in self.param_keys}

    @torch.no_grad()
    def load_params(self, params: Dict[str, np.ndarray]) -> "Component":
        """Copy numpy arrays (JAX layout) into this layer's tensors."""
        for k in self.param_keys:
            t = getattr(self, k)
            src = torch.as_tensor(np.asarray(params[k], dtype=np.float32))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{self.tag} param {k!r}: shape "
                                 f"{tuple(src.shape)} != {tuple(t.shape)}")
            t.copy_(src)
        return self

    # -- compute ---------------------------------------------------------
    # (overrides nn.Module.apply(fn): the JAX package's functional forward)
    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.param_dict(), x)

    # -- serialization ---------------------------------------------------
    @classmethod
    def read(cls, n_inputs: int, n_outputs: int, ts: TokenStream) -> "Component":
        """Parse params following the ``<tag> out in`` header."""
        return cls(n_inputs, n_outputs)

    def write(self, out: TextIO) -> None:
        """Write params (the header is written by the network)."""


# ---------------------------------------------------------------------------
# Updatable affine layers
# ---------------------------------------------------------------------------

class BiasedLinearity(Component):
    """y = x @ W + b, W (in, out); MMF stores W transposed as (out, in)."""

    tag = "<biasedlinearity>"
    updatable = True
    trainable_keys = ("weight", "bias")
    param_keys = ("weight", "bias")

    def __init__(self, n_inputs, n_outputs):
        super().__init__(n_inputs, n_outputs)
        self._init_params({"weight": (n_inputs, n_outputs), "bias": (n_outputs,)})

    def apply(self, params, x):
        return x @ params["weight"] + params["bias"]

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        wt = mmf.read_matrix(ts)          # stored (out, in)
        b = mmf.read_vector(ts)
        if wt.shape != (n_outputs, n_inputs) or b.shape != (n_outputs,):
            raise ValueError(
                f"Wrong dimensionalities in network file: inputs {n_inputs} "
                f"outputs {n_outputs} matrix {wt.shape} bias {b.shape}")
        return cls(n_inputs, n_outputs).load_params({"weight": wt.T, "bias": b})

    def write(self, out):
        mmf.write_matrix(out, _np(self.weight).T)
        mmf.write_vector(out, _np(self.bias))
        out.write("\n")


class SharedLinearity(Component):
    """One (in/k, out/k) weight applied to k column blocks
    (TNetLib/SharedLinearity.cc:8-37)."""

    tag = "<sharedlinearity>"
    updatable = True
    trainable_keys = ("weight", "bias")
    param_keys = ("weight", "bias")

    def __init__(self, n_inputs, n_outputs, n_instances: int = 1):
        super().__init__(n_inputs, n_outputs)
        if n_instances < 1 or n_inputs % n_instances or n_outputs % n_instances:
            raise ValueError(f"Bad number of instances: {n_instances}")
        self.n_instances = n_instances
        k = n_instances
        self._init_params({"weight": (n_inputs // k, n_outputs // k),
                           "bias": (n_outputs // k,)})

    def apply(self, params, x):
        k = self.n_instances
        xs = x.reshape(x.shape[0], k, self.n_inputs // k)
        ys = xs @ params["weight"] + params["bias"]
        return ys.reshape(x.shape[0], self.n_outputs)

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        k = int(ts.next())
        if k < 1 or n_inputs % k or n_outputs % k:
            raise ValueError(f"Bad number of instances: {k}")
        wt = mmf.read_matrix(ts)
        b = mmf.read_vector(ts)
        if wt.shape != (n_outputs // k, n_inputs // k) or b.shape != (n_outputs // k,):
            raise ValueError("Wrong shared-linearity dimensions in network file")
        return cls(n_inputs, n_outputs, n_instances=k).load_params(
            {"weight": wt.T, "bias": b})

    def write(self, out):
        out.write(f"{self.n_instances}\n")
        mmf.write_matrix(out, _np(self.weight).T)
        mmf.write_vector(out, _np(self.bias))
        out.write("\n")


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

class Sigmoid(Component):
    """TNetLib/Activation.cc:7-25."""

    tag = "<sigmoid>"

    def apply(self, params, x):
        return torch.sigmoid(x)


class Softmax(Component):
    """Row-wise softmax (TNetLib/Activation.cc:29-52). In training the
    trainer pairs it with CE through the fused softmax-xent kernel."""

    tag = "<softmax>"

    def apply(self, params, x):
        return torch.softmax(x, dim=-1)


# ---------------------------------------------------------------------------
# Feature-transform components (non-trainable)
# ---------------------------------------------------------------------------

class Expand(Component):
    """Frame splicing: out row r = concat of rows r+o for o in offsets,
    edge-clamped (TNetLib/CRBEDctFeat.h:18-69)."""

    tag = "<expand>"

    def __init__(self, n_inputs, n_outputs, offsets: Tuple[int, ...] = ()):
        super().__init__(n_inputs, n_outputs)
        self.offsets = tuple(int(o) for o in offsets)
        self.register_buffer(
            "_offsets", torch.tensor(self.offsets, dtype=torch.int64),
            persistent=False)

    def apply(self, params, x):
        # one gather: row t of block j reads x[clamp(t + offsets[j])]
        T = x.shape[0]
        rows = torch.arange(T, device=x.device)[:, None] + self._offsets[None, :]
        idx = rows.clamp_(0, max(T - 1, 0))
        return x[idx].reshape(T, len(self.offsets) * x.shape[1])

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        offs = tuple(int(v) for v in mmf.read_vector(ts, dtype=np.int32))
        return cls(n_inputs, n_outputs, offsets=offs)

    def write(self, out):
        mmf.write_vector(out, np.asarray(self.offsets, dtype=np.int64))


class _ColumnGather(Component):
    """Shared body of Copy and Transpose: ``x[:, index]``."""

    def _set_index(self, index) -> None:
        self.register_buffer("_index", torch.tensor(index, dtype=torch.int64),
                             persistent=False)

    def apply(self, params, x):
        return x[:, self._index]


class Copy(_ColumnGather):
    """Column gather by explicit indices, 1-based on disk
    (TNetLib/CRBEDctFeat.h:76-132)."""

    tag = "<copy>"

    def __init__(self, n_inputs, n_outputs, indices: Tuple[int, ...] = ()):
        super().__init__(n_inputs, n_outputs)
        self.indices = tuple(int(i) for i in indices)     # 0-based
        self._set_index(self.indices)

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        idx = tuple(int(v) - 1 for v in mmf.read_vector(ts, dtype=np.int32))
        return cls(n_inputs, n_outputs, indices=idx)

    def write(self, out):
        mmf.write_vector(out, np.asarray(self.indices, dtype=np.int64) + 1)


class Transpose(_ColumnGather):
    """Band/time interleave (TNetLib/CRBEDctFeat.h:134-203): with context c
    and channels = N/c, output ch*c + t gathers input t*channels + ch."""

    tag = "<transpose>"

    def __init__(self, n_inputs, n_outputs, context: int = 1):
        super().__init__(n_inputs, n_outputs)
        if n_inputs != n_outputs:
            raise ValueError("Input dim must be same as output dim")
        self.context = int(context)
        self._set_index(self._perm())

    def _perm(self):
        n = self.n_inputs
        channels = n // self.context
        perm = []
        for ch in range(channels):
            perm.extend(range(ch, n, channels))
        return perm

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        if n_inputs != n_outputs:
            raise ValueError("Input dim must be same as output dim")
        return cls(n_inputs, n_outputs, context=int(ts.next()))

    def write(self, out):
        out.write(f" {self.context}\n")


class BlockLinearity(Component):
    """Block-diagonal matmul by one shared (block_in, block_out) block
    (TNetLib/CRBEDctFeat.h:210-288). MMF stores the block transposed."""

    tag = "<blocklinearity>"
    param_keys = ("block",)

    def __init__(self, n_inputs, n_outputs, block_in: int = 1, block_out: int = 1):
        super().__init__(n_inputs, n_outputs)
        if (n_outputs % block_out or n_inputs % block_in
                or n_outputs // block_out != n_inputs // block_in):
            raise ValueError("BlockLinearity matrix dimensions must divide IO dims")
        self.block_in, self.block_out = block_in, block_out
        self._init_params({"block": (block_in, block_out)})

    def apply(self, params, x):
        k = self.n_inputs // self.block_in
        xs = x.reshape(x.shape[0], k, self.block_in)
        return (xs @ params["block"]).reshape(x.shape[0], self.n_outputs)

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        bt = mmf.read_matrix(ts)          # stored (out_b, in_b)
        bo, bi = bt.shape
        return cls(n_inputs, n_outputs, block_in=bi, block_out=bo).load_params(
            {"block": bt.T})

    def write(self, out):
        mmf.write_matrix(out, _np(self.block).T)


class Bias(Component):
    """Add a constant vector (TNetLib/CRBEDctFeat.h:292-339)."""

    tag = "<bias>"
    param_keys = ("bias",)

    def __init__(self, n_inputs, n_outputs):
        super().__init__(n_inputs, n_outputs)
        self._init_params({"bias": (n_outputs,)})

    def apply(self, params, x):
        return x + params["bias"]

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        b = mmf.read_vector(ts)
        if b.shape != (n_outputs,):
            raise ValueError(f"<bias> vector {b.shape} != ({n_outputs},)")
        return cls(n_inputs, n_outputs).load_params({"bias": b})

    def write(self, out):
        mmf.write_vector(out, _np(self.bias))


class Window(Component):
    """Multiply by a constant vector (TNetLib/CRBEDctFeat.h:343-390)."""

    tag = "<window>"
    param_keys = ("window",)

    def __init__(self, n_inputs, n_outputs):
        super().__init__(n_inputs, n_outputs)
        self._init_params({"window": (n_outputs,)})

    def apply(self, params, x):
        return x * params["window"]

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        w = mmf.read_vector(ts)
        if w.shape != (n_outputs,):
            raise ValueError(f"<window> vector {w.shape} != ({n_outputs},)")
        return cls(n_inputs, n_outputs).load_params({"window": w})

    def write(self, out):
        mmf.write_vector(out, _np(self.window))


# ---------------------------------------------------------------------------
# Tag registry
# ---------------------------------------------------------------------------

COMPONENT_TYPES = [
    BiasedLinearity, SharedLinearity, Sigmoid, Softmax,
    Expand, Copy, Transpose, BlockLinearity, Bias, Window,
]

TAG_TO_TYPE = {c.tag: c for c in COMPONENT_TYPES}

# tags the JAX package reads that this port does not yet (ROADMAP.md queue 1)
UNPORTED_TAGS = {
    "<discretelinearity>": "queue 1 item 2 (models)",
    "<sparselinearity>": "queue 1 items 2 and 4 (models, L1/mask SGD)",
    "<clusterlinearity>": "queue 1 item 2 (models)",
    "<blocksoftmax>": "queue 1 items 2 and 3 (models, BlockSoftmax CE)",
    "<log>": "queue 1 item 2 (models)",
    "<rbm>": "queue 1 item 11 (RBM)",
    "<rbmsparse>": "queue 1 item 11 (RBM)",
    "<recurrent>": "queue 1 item 12 (recurrent)",
    "<blockarray>": "queue 1 item 2 (models)",
}

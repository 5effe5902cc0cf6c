"""Network components as ``nn.Module``s (port of nnet_asr_tpu/models/components.py).

Each component keeps the JAX package's parameter names and layouts, so
parameters cross between the packages as numpy arrays unchanged: an affine
``weight`` is (in, out) and the MMF file stores its transpose
(TNetLib/BiasedLinearity.cc:37-58). Trainable entries are ``nn.Parameter``s,
the constant vectors of the feature-transform tags are buffers.

``apply(params, x)`` is the functional forward over a dict of tensors, as
in JAX; ``forward(x)`` applies the module's own parameters. MMF text is
read and written through the port's copy of the MMF reader, ``io/mmf.py``.

Parameters that the JAX package keeps as Python lists (DiscreteLinearity's
``weights``, ClusterLinearity's ``cluster_weights``/``cluster_biases``) are
``_TensorList`` submodules inside, and plain lists in ``param_dict()``;
BlockArray's ``blocks`` is a list (one per block) of lists of its
sub-layers' dicts, as in JAX.

Every tag of the JAX package is ported. <recurrent>'s forward is a Python
loop over time (the rows of its input) after one GEMM of every frame's
input half.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, TextIO, Tuple

import numpy as np
import torch
from torch import nn

from ..io import mmf
from ..io.mmf import TokenStream

Params = Dict[str, torch.Tensor]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


class _TensorList(nn.Module):
    """Zero float32 tensors of the given shapes, registered as Parameters
    (trainable) or buffers named "0", "1", ...; iterates like a list."""

    def __init__(self, shapes: Sequence[Tuple[int, ...]], trainable: bool):
        super().__init__()
        self.n = len(shapes)
        for i, shape in enumerate(shapes):
            t = torch.zeros(shape, dtype=torch.float32)
            if trainable:
                self.register_parameter(str(i), nn.Parameter(t))
            else:
                self.register_buffer(str(i), t)

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        return (getattr(self, str(i)) for i in range(self.n))


@torch.no_grad()
def _copy_into(dst, src, what: str) -> None:
    """Copy ``src`` (numpy arrays in the JAX nesting of lists and dicts)
    into the tensors of ``dst`` (the same nesting), checking every shape."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k], f"{what}[{k!r}]")
        return
    if isinstance(dst, list):
        if len(src) != len(dst):
            raise ValueError(f"{what}: {len(src)} entries, want {len(dst)}")
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy_into(d, s, f"{what}[{i}]")
        return
    t = torch.as_tensor(np.asarray(src, dtype=np.float32))
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)} != {tuple(dst.shape)}")
    dst.copy_(t)


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

    def _init_params(self, shapes: Dict[str, object]) -> None:
        """Zero tensors of the given shapes: trainable keys as Parameters,
        the rest as buffers; a list of shapes makes a ``_TensorList``."""
        for k, shape in shapes.items():
            trainable = k in self.trainable_keys
            if isinstance(shape, list):
                self.add_module(k, _TensorList(shape, trainable))
                continue
            t = torch.zeros(shape, dtype=torch.float32)
            if trainable:
                self.register_parameter(k, nn.Parameter(t))
            else:
                self.register_buffer(k, t)

    def param_dict(self) -> Params:
        """The parameters in the JAX package's names and nesting."""
        out = {}
        for k in self.param_keys:
            v = getattr(self, k)
            out[k] = list(v) if isinstance(v, _TensorList) else v
        return out

    def load_params(self, params: Dict[str, object]) -> "Component":
        """Copy numpy arrays (JAX layout and nesting) into this layer's tensors."""
        mine = self.param_dict()
        for k in self.param_keys:
            _copy_into(mine[k], params[k], f"{self.tag} param {k!r}")
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


class DiscreteLinearity(Component):
    """Block-diagonal affine with independent per-block weights
    (CuTNetLib/cuDiscreteLinearity.cc): ``n_blocks``, then each block's
    transposed matrix, then one bias vector."""

    tag = "<discretelinearity>"
    updatable = True
    trainable_keys = ("weights", "bias")
    param_keys = ("weights", "bias")

    def __init__(self, n_inputs, n_outputs, block_dims: Sequence[Tuple[int, int]] = ()):
        super().__init__(n_inputs, n_outputs)
        self.block_dims = tuple((int(di), int(do)) for di, do in block_dims)
        if (not self.block_dims or sum(d[0] for d in self.block_dims) != n_inputs
                or sum(d[1] for d in self.block_dims) != n_outputs):
            raise ValueError("Wrong discrete-linearity dimensions in network file")
        self._init_params({"weights": list(self.block_dims), "bias": (n_outputs,)})

    def apply(self, params, x):
        outs = []
        in_off = 0
        for w, (di, _) in zip(params["weights"], self.block_dims):
            outs.append(x[:, in_off:in_off + di] @ w)
            in_off += di
        return torch.cat(outs, dim=1) + params["bias"]

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        nb = int(ts.next())
        if nb < 1:
            raise ValueError(f"Bad number of blocks: {nb}")
        wts = [mmf.read_matrix(ts) for _ in range(nb)]     # each stored (out_i, in_i)
        b = mmf.read_vector(ts)
        if b.shape != (n_outputs,):
            raise ValueError("Wrong discrete-linearity dimensions in network file")
        dims = [(wt.shape[1], wt.shape[0]) for wt in wts]
        return cls(n_inputs, n_outputs, block_dims=dims).load_params(
            {"weights": [wt.T for wt in wts], "bias": b})

    def write(self, out):
        out.write(f"{len(self.block_dims)}\n")
        for w in self.weights:
            mmf.write_matrix(out, _np(w).T)
        mmf.write_vector(out, _np(self.bias))
        out.write("\n")


class SparseLinearity(Component):
    """``x @ (W * mask) + b`` with a 0/1 mask buffer (CuTNetLib/
    cuSparseLinearity.cc). On read a missing mask is all ones and the
    accumulator matrix that may follow is skipped; ``write`` prunes the
    mask at |w| < 1e-3 (the reference's UpdateMask from WriteToStream), and
    nothing else does, so a pruned weight is never re-activated."""

    tag = "<sparselinearity>"
    updatable = True
    trainable_keys = ("weight", "bias")
    param_keys = ("weight", "bias", "mask")

    def __init__(self, n_inputs, n_outputs):
        super().__init__(n_inputs, n_outputs)
        self._init_params({"weight": (n_inputs, n_outputs), "bias": (n_outputs,),
                           "mask": (n_inputs, n_outputs)})
        self.mask.fill_(1.0)          # a buffer: no mask on file means all ones

    def apply(self, params, x):
        return x @ (params["weight"] * params["mask"]) + params["bias"]

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        wt = mmf.read_matrix(ts)
        b = mmf.read_vector(ts)
        mask = mmf.read_matrix(ts).T if ts.peek() == "m" else np.ones(
            (n_inputs, n_outputs), np.float32)
        if ts.peek() == "m":
            mmf.read_matrix(ts)          # the accumulated-gradient matrix: not kept
        if wt.shape != (n_outputs, n_inputs) or b.shape != (n_outputs,):
            raise ValueError("Wrong sparse-linearity dimensions in network file")
        return cls(n_inputs, n_outputs).load_params({"weight": wt.T, "bias": b, "mask": mask})

    def write(self, out):
        w = _np(self.weight)
        mask = np.where(np.abs(w) < 1e-3, 0.0, _np(self.mask))
        mmf.write_matrix(out, w.T)
        mmf.write_vector(out, _np(self.bias))
        mmf.write_matrix(out, mask.astype(np.float32).T)
        out.write("\n")

    @staticmethod
    def update_mask(params: Params, threshold: float = 1e-3) -> Params:
        """The params with |weight| < threshold pruned from the mask
        (cuSparseLinearity.cc:66-95)."""
        mask = torch.where(params["weight"].abs() < threshold,
                           torch.zeros_like(params["mask"]), params["mask"])
        return {**params, "mask": mask}


class ClusterLinearity(Component):
    """Cluster-adaptive affine: the forward pass is BiasedLinearity's on
    the combined ``weight``/``bias``, the only trainable entries
    (cuClusterLinearity.cc:9-21); the per-cluster transforms, the constant
    weight and ``cluster_map`` are carried through read and write. Format
    (cuClusterLinearity.cc:95-253): n_instances; per cluster ``c n ids...``
    + square xform^T + bias(in); const weight^T + bias(out); combined
    weight^T + bias(out)."""

    tag = "<clusterlinearity>"
    updatable = True
    trainable_keys = ("weight", "bias")
    param_keys = ("cluster_weights", "cluster_biases", "const_weight", "const_bias",
                  "weight", "bias")

    def __init__(self, n_inputs, n_outputs, cluster_map: Sequence[Sequence[int]]):
        super().__init__(n_inputs, n_outputs)
        self.cluster_map = tuple(tuple(int(i) for i in ids) for ids in cluster_map)
        self.n_instances = len(self.cluster_map)
        if self.n_instances < 1:
            raise ValueError(f"Bad number of instances: {self.n_instances}")
        k = self.n_instances
        self._init_params({"cluster_weights": [(n_inputs, n_inputs)] * k,
                           "cluster_biases": [(n_inputs,)] * k,
                           "const_weight": (n_inputs, n_outputs), "const_bias": (n_outputs,),
                           "weight": (n_inputs, n_outputs), "bias": (n_outputs,)})

    def apply(self, params, x):
        return x @ params["weight"] + params["bias"]

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        k = int(ts.next())
        if k < 1:
            raise ValueError(f"Bad number of instances: {k}")
        cmap, cw, cb = [], [], []
        for _ in range(k):
            tag = ts.next()
            n = int(ts.next())
            if tag != "c" or n < 1:
                raise ValueError(f"Bad cluster xform header: {tag} {n}")
            cmap.append(tuple(int(ts.next()) for _ in range(n)))
            xt = mmf.read_matrix(ts)
            xb = mmf.read_vector(ts)
            if xt.shape != (n_inputs, n_inputs) or xb.shape != (n_inputs,):
                raise ValueError("Wrong cluster-xform dimensions in network file")
            cw.append(xt.T)
            cb.append(xb)
        ct = mmf.read_matrix(ts)
        const_b = mmf.read_vector(ts)
        wt = mmf.read_matrix(ts)
        b = mmf.read_vector(ts)
        if wt.shape != (n_outputs, n_inputs) or ct.shape != (n_outputs, n_inputs):
            raise ValueError("Wrong cluster-linearity dimensions in network file")
        return cls(n_inputs, n_outputs, cluster_map=cmap).load_params({
            "cluster_weights": cw, "cluster_biases": cb, "const_weight": ct.T,
            "const_bias": const_b, "weight": wt.T, "bias": b})

    def write(self, out):
        out.write(f"{self.n_instances}\n")
        for ids, w, b in zip(self.cluster_map, self.cluster_weights, self.cluster_biases):
            out.write("c " + " ".join(str(i) for i in (len(ids),) + ids) + "\n")
            mmf.write_matrix(out, _np(w).T)
            mmf.write_vector(out, _np(b))
        mmf.write_matrix(out, _np(self.const_weight).T)
        mmf.write_vector(out, _np(self.const_bias))
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


class BlockSoftmax(Component):
    """Softmaxes over disjoint output spans (TNetLib/Activation.cc:55-133);
    the file holds the span widths as a vector."""

    tag = "<blocksoftmax>"

    def __init__(self, n_inputs, n_outputs, dims: Sequence[int] = ()):
        super().__init__(n_inputs, n_outputs)
        self.dims = tuple(int(d) for d in dims)
        if sum(self.dims) != n_outputs:
            raise ValueError(f"Non-matching dimension of sum of softmaxes: "
                             f"{sum(self.dims)} vs {n_outputs}")

    def apply(self, params, x):
        return torch.cat([torch.softmax(s, dim=-1) for s in x.split(self.dims, dim=1)], dim=1)

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        return cls(n_inputs, n_outputs, dims=mmf.read_vector(ts, dtype=np.int32))

    def write(self, out):
        mmf.write_vector(out, np.asarray(self.dims, dtype=np.int64))


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


class Log(Component):
    """Elementwise natural log (TNetLib/CRBEDctFeat.h:392-426)."""

    tag = "<log>"

    def apply(self, params, x):
        return torch.log(x)


# ---------------------------------------------------------------------------
# RBM layers (as MLP layers; CD-1 pretraining is train/rbm.py)
# ---------------------------------------------------------------------------

BERNOULLI = "bern"
GAUSSIAN = "gauss"


class Rbm(Component):
    """As an MLP layer: ``sigmoid(x @ W + hid_bias)`` for Bernoulli hidden
    units, linear for Gaussian (cuRbm.cc:13-23). Serialized as ``vis_type
    hid_type``, then W^T (hid, vis), vis bias, hid bias (cuRbm.cc:177-209)."""

    tag = "<rbm>"
    updatable = True
    trainable_keys = ("weight", "hid_bias")
    param_keys = ("weight", "vis_bias", "hid_bias")

    def __init__(self, n_inputs, n_outputs, vis_type: str = BERNOULLI,
                 hid_type: str = BERNOULLI):
        super().__init__(n_inputs, n_outputs)
        for t in (vis_type, hid_type):
            if t not in (BERNOULLI, GAUSSIAN):
                raise ValueError(f"Invalid unit type: {t}")
        self.vis_type, self.hid_type = vis_type, hid_type
        self._init_params({"weight": (n_inputs, n_outputs), "vis_bias": (n_inputs,),
                           "hid_bias": (n_outputs,)})

    def apply(self, params, x):
        pre = x @ params["weight"] + params["hid_bias"]
        return torch.sigmoid(pre) if self.hid_type == BERNOULLI else pre

    def reconstruct(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        """hid → vis: sigmoid for Bernoulli visible units, linear for
        Gaussian (cuRbm.cc:117-128)."""
        pre = h @ params["weight"].T + params["vis_bias"]
        return torch.sigmoid(pre) if self.vis_type == BERNOULLI else pre

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        vt, ht = ts.next(), ts.next()
        layer = cls(n_inputs, n_outputs, vis_type=vt, hid_type=ht)
        wt = mmf.read_matrix(ts)          # (hid, vis)
        vb = mmf.read_vector(ts)
        hb = mmf.read_vector(ts)
        if wt.shape != (n_outputs, n_inputs):
            raise ValueError("Wrong RBM weight dimensions in network file")
        return layer.load_params({"weight": wt.T, "vis_bias": vb, "hid_bias": hb})

    def write(self, out):
        out.write(f"{self.vis_type} {self.hid_type}\n")
        mmf.write_matrix(out, _np(self.weight).T)
        mmf.write_vector(out, _np(self.vis_bias))
        mmf.write_vector(out, _np(self.hid_bias))
        out.write("\n")


class RbmSparse(Rbm):
    """RBM with a hidden-sparsity target (cuRbmSparse.cc:143-160): the
    same file format; the sparsity state is training state, not a parameter."""

    tag = "<rbmsparse>"


# ---------------------------------------------------------------------------
# Recurrent layer
# ---------------------------------------------------------------------------

class Recurrent(Component):
    """``y_t = sigmoid(x_t @ W[:in] + y_{t-1} @ W[in:] + b)`` over the rows
    of the input taken as time, W (in+out, out) (CuTNetLib/cuRecurrent.cc);
    MMF stores W transposed as (out, in+out)."""

    tag = "<recurrent>"
    updatable = True
    trainable_keys = ("weight", "bias")
    param_keys = ("weight", "bias")

    def __init__(self, n_inputs, n_outputs):
        super().__init__(n_inputs, n_outputs)
        self._init_params({"weight": (n_inputs + n_outputs, n_outputs), "bias": (n_outputs,)})

    def apply(self, params, x):
        return self.apply_with_state(params, x, None)[0]

    def apply_with_state(self, params: Params, x: torch.Tensor,
                         h0) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ys, h_last) over x (..., T, in) from the state h0 (..., out),
        zeros when None; leading dimensions are independent sequences. The
        input half of every frame is one GEMM before the loop; each step
        adds ``x_t @ W[:in] + h @ W[in:]``, then ``b``, in JAX's order."""
        w, b = params["weight"], params["bias"]
        if h0 is None:
            h0 = x.new_zeros(x.shape[:-2] + (self.n_outputs,))
        xw = x @ w[:self.n_inputs]
        w_h = w[self.n_inputs:]
        h, ys = h0, []
        for t in range(x.shape[-2]):
            h = torch.sigmoid(xw[..., t, :] + h @ w_h + b)
            ys.append(h)
        if not ys:
            return xw, h
        return torch.stack(ys, dim=-2), h

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        wt = mmf.read_matrix(ts)          # (out, in+out)
        b = mmf.read_vector(ts)
        if wt.shape != (n_outputs, n_inputs + n_outputs) or b.shape != (n_outputs,):
            raise ValueError("Wrong recurrent dimensions in network file")
        return cls(n_inputs, n_outputs).load_params({"weight": wt.T, "bias": b})

    def write(self, out):
        mmf.write_matrix(out, _np(self.weight).T)
        mmf.write_vector(out, _np(self.bias))
        out.write("\n")


# ---------------------------------------------------------------------------
# BlockArray: sub-networks over consecutive input column blocks
# ---------------------------------------------------------------------------

class BlockArray(Component):
    """N sub-networks applied to consecutive input column blocks, outputs
    concatenated (TNetLib/BlockArray.cc, forward only), serialized as
    ``n_blocks`` then ``<block> i ... <endblock>`` per sub-network. Its
    ``blocks`` parameter is a list of each sub-network's param dicts."""

    tag = "<blockarray>"
    param_keys = ("blocks",)

    def __init__(self, n_inputs, n_outputs, subnets: Sequence[Sequence[Component]]):
        super().__init__(n_inputs, n_outputs)
        self.subnets = nn.ModuleList(nn.ModuleList(layers) for layers in subnets)

    def param_dict(self) -> Params:
        return {"blocks": [[layer.param_dict() for layer in layers]
                           for layers in self.subnets]}

    def apply(self, params, x):
        bi = self.n_inputs // len(self.subnets)
        outs = []
        for i, layers in enumerate(self.subnets):
            h = x[:, i * bi:(i + 1) * bi]
            for layer, p in zip(layers, params["blocks"][i]):
                h = layer.apply(p, h)
            outs.append(h)
        return torch.cat(outs, dim=1)

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        from .network import read_components       # network imports this module
        subnets: List[List[Component]] = []
        for i in range(int(ts.next())):
            tag = ts.next()
            idx = int(ts.next())
            if tag != "<block>" or idx != i + 1:
                raise ValueError(f"Expected '<block> {i + 1}', got '{tag} {idx}'")
            subnets.append(read_components(ts, stop_tag="<endblock>"))
        return cls(n_inputs, n_outputs, subnets)

    def write(self, out):
        from .network import write_component
        out.write(f"{len(self.subnets)}\n")
        for i, layers in enumerate(self.subnets):
            out.write(f"<block> {i + 1}\n")
            for layer in layers:
                write_component(out, layer)
            out.write("<endblock>\n")


# ---------------------------------------------------------------------------
# Tag registry
# ---------------------------------------------------------------------------

COMPONENT_TYPES = [
    BiasedLinearity, DiscreteLinearity, SharedLinearity, SparseLinearity,
    Rbm, RbmSparse, Recurrent,
    Softmax, Sigmoid, BlockSoftmax,
    Expand, Copy, Transpose, BlockLinearity, Bias, Window, Log,
    BlockArray, ClusterLinearity,
]

TAG_TO_TYPE = {c.tag: c for c in COMPONENT_TYPES}

"""Batched device-side feature-transform pipeline
(port of nnet_asr_tpu/train/pipeline.py).

The reference transforms one utterance at a time and trims the splice halo
afterwards (Platform.h:274-286, TNetCu.cc:385-393). Here, as in the JAX
package, a batch of halo-extended utterances is concatenated into one
frame stream, run through the transform in CHUNK-row tiles with
(start_ext + end_ext) rows of overlap (the halo exchange of
Network::Feedforward, Nnet.cc:15-62), and the valid (halo-trimmed) rows
are gathered back out. A kept row only splices rows of its own utterance's
extended block, so its value equals per-utterance transformation.

Linear transforms fold to one splice + matmul (``ops.fold_affine``);
others run layer by layer. The JAX package's shape buckets existed to bound
XLA compiles and are gone: blocks here hold exactly the valid rows.

``compute_dtype`` selects the inference modes of JAX ``pipeline.py:45-134``
(tfeacat ``--BF16``/``--INT8``; training keeps f32):

- ``'bf16'``: the affine GEMMs take bf16 operands with f32 accumulation
  (``bf16_matmul``). Folded: the spliced input and the folded matrix in
  bf16, the product rounded to bf16, plus the f32 bias, giving f32. Layer
  by layer: each BiasedLinearity as ``(x.bf16 @ W.bf16).float() + b``.
- ``'int8'``: each affine GEMM on int8 operands with int32 accumulation:
  W quantized per output channel once, x per tensor at each call, the
  product scaled back by both scales (``int8_matmul``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.components import BiasedLinearity
from ..models.network import Network
from ..ops.fold_affine import fold_transform
from ..ops.int8_train import scale
from ..ops.kernels.matmul_act import bf16_matmul

COMPUTE_DTYPES = (None, "bf16", "int8")


def _quantize(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(t / s), -127, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 W, its f32 scales): symmetric, per output channel (column)."""
    s = scale(w, 0)[0]
    return _quantize(w, s), s


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> int32 by ``torch._int_mm``. Its CUDA
    path wants more than 16 rows and K and N multiples of 8 (MLP3's 598
    and 135 are not): the operands are zero-padded to that and the product
    cut back, which is exact in int32."""
    M, K = a.shape
    N = b.shape[1]
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
    if (Mp, Kp, Np) != (M, K, N):
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M))
        b = torch.nn.functional.pad(b, (0, Np - N, 0, Kp - K))
    return torch._int_mm(a.contiguous(), b.contiguous())[:M, :N]


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """x @ W on the int8 path: x quantized with one scale, int32
    accumulation, then scaled by x's scale times W's per-column scales."""
    sx = scale(x)
    return int_mm(_quantize(x, sx), wq).float() * (sx * ws)


class TransformPipeline:
    def __init__(self, transform: Optional[Network], start_ext: int = 0,
                 end_ext: int = 0, chunk: int = 2048, device: DeviceLike = "cpu",
                 compute_dtype: Optional[str] = None):
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                             f"got {compute_dtype!r}")
        self.device = resolve_device(device)
        self.start_ext = start_ext
        self.end_ext = end_ext
        self.chunk = chunk
        self.transform = transform
        self.compute_dtype = compute_dtype
        self._folded = None
        self._qweights = {}       # int8, layer by layer: layer index -> (Wq, scales)
        if transform is not None:
            transform.to(self.device)
            folded = fold_transform(transform, self.device)
            if folded is not None:
                sa, M, c = folded
                if compute_dtype == "bf16":
                    M = M.to(torch.bfloat16)
                elif compute_dtype == "int8":
                    M = quantize_weight(M)
                self._folded = (sa.expand().to(self.device), M, c)
            elif compute_dtype == "int8":
                self._qweights = {i: quantize_weight(spec.weight)
                                  for i, spec in enumerate(transform.layers)
                                  if isinstance(spec, BiasedLinearity)}

    @torch.no_grad()
    def _apply_chunk(self, x: torch.Tensor) -> torch.Tensor:
        mode = self.compute_dtype
        if self._folded is not None:
            expand, M, c = self._folded
            x = expand(x)
            if mode == "int8":
                return int8_matmul(x, *M) + c
            if mode == "bf16":
                return bf16_matmul(x.to(torch.bfloat16), M) + c   # bf16 + f32 -> f32
            return x @ M + c
        for i, spec in enumerate(self.transform.layers):
            if isinstance(spec, BiasedLinearity) and mode == "int8":
                x = int8_matmul(x, *self._qweights[i]) + spec.bias
            elif isinstance(spec, BiasedLinearity) and mode == "bf16":
                x = bf16_matmul(x.to(torch.bfloat16), spec.weight.to(torch.bfloat16)
                                ).float() + spec.bias
            else:
                x = spec(x)
        return x

    def _valid_row_indices(self, ext_feats) -> np.ndarray:
        ext_l, ext_r = self.start_ext, self.end_ext
        idx = []
        off = 0
        for f in ext_feats:
            idx.append(np.arange(off + ext_l, off + f.shape[0] - ext_r))
            off += f.shape[0]
        return np.concatenate(idx) if idx else np.zeros((0,), np.int64)

    def _transform_stream(self, ext_feats: Sequence[np.ndarray]) -> torch.Tensor:
        """The chunked transform over the concatenated extended utterances:
        the full (S, D_out) stream on the device."""
        ext_l, ext_r = self.start_ext, self.end_ext
        stream = np.concatenate(ext_feats, axis=0) if len(ext_feats) > 1 else ext_feats[0]
        S = stream.shape[0]
        CH = self.chunk
        n_chunks = max(1, -(-S // CH))
        halo = ext_l + ext_r
        # ext_l zeros in front (context for row 0 of chunk 0 — only trimmed
        # rows read it) and tail zeros so every tile is full-size
        padded = torch.zeros((ext_l + n_chunks * CH + ext_r, stream.shape[1]),
                             dtype=torch.float32, device=self.device)
        padded[ext_l:ext_l + S] = torch.from_numpy(
            np.ascontiguousarray(stream, dtype=np.float32)).to(self.device)
        out = [self._apply_chunk(padded[i * CH:i * CH + CH + halo])[ext_l:ext_l + CH]
               for i in range(n_chunks)]
        return torch.cat(out, dim=0)[:S]

    def transform_rows(self, ext_feats: Sequence[np.ndarray]
                       ) -> Tuple[torch.Tensor, List[int]]:
        """The valid rows of all utterances, concatenated, as ONE device
        tensor, plus the per-utterance lengths."""
        ext_l, ext_r = self.start_ext, self.end_ext
        lens = [f.shape[0] - ext_l - ext_r for f in ext_feats]
        if self.transform is None:
            rows = np.concatenate([f[ext_l:f.shape[0] - ext_r] for f in ext_feats], axis=0)
            return torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(self.device), lens
        stream_out = self._transform_stream(ext_feats)
        idx = torch.from_numpy(self._valid_row_indices(ext_feats)).to(self.device)
        return stream_out.index_select(0, idx), lens

    def transform_block(self, ext_feats: Sequence[np.ndarray]) -> Tuple[torch.Tensor, int]:
        """(rows, valid): the training intake block. Unlike the JAX
        package's bucket-padded block, ``rows`` holds exactly the ``valid``
        halo-trimmed rows of all utterances in arrival order."""
        rows, lens = self.transform_rows(ext_feats)
        return rows, int(sum(lens))

    def transform_to_host(self, ext_feats: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Per-utterance HOST arrays (T_i, D_out) with ONE device-to-host
        copy for the batch (the posterior-dump path: tfeacat)."""
        rows, lens = self.transform_rows(ext_feats)
        return np.split(rows.cpu().numpy(), np.cumsum(lens)[:-1])

    def __call__(self, ext_feats: Sequence[np.ndarray]) -> List[torch.Tensor]:
        """Per-utterance device tensors (T_i, D_out), halo trimmed."""
        rows, lens = self.transform_rows(ext_feats)
        return list(rows.split(lens))

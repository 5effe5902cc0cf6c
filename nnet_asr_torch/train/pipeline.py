"""Batched device-side feature-transform pipeline, f32
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
XLA compiles and are gone: blocks here hold exactly the valid rows. The
bf16 and int8 inference modes are still to come (ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.network import Network
from ..ops.fold_affine import fold_transform


class TransformPipeline:
    def __init__(self, transform: Optional[Network], start_ext: int = 0,
                 end_ext: int = 0, chunk: int = 2048, device: DeviceLike = "cpu"):
        self.device = resolve_device(device)
        self.start_ext = start_ext
        self.end_ext = end_ext
        self.chunk = chunk
        self.transform = transform
        self._folded = None
        if transform is not None:
            transform.to(self.device)
            folded = fold_transform(transform, self.device)
            if folded is not None:
                sa, M, c = folded
                self._folded = (sa.expand().to(self.device), M, c)

    @torch.no_grad()
    def _apply_chunk(self, x: torch.Tensor) -> torch.Tensor:
        if self._folded is not None:
            expand, M, c = self._folded
            return expand(x) @ M + c
        return self.transform(x)

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

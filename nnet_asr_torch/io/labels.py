"""Label repository: MLF transcriptions → per-frame training targets.

The port's copy of ``nnet_asr_tpu/io/labels.py``, behaviour unchanged.

Re-implements LabelRepository (KaldiLib/Labels.{h,cc}) with a device-friendly
twist: targets are produced as *integer* state indices per frame (fused with
cross-entropy on device, avoiding dense one-hot materialization at senone
scale), with an optional dense one-hot export for parity tests against the
reference's GenDesiredMatrix (Labels.cc:42-187).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from .htk import make_htk_filename
from .mlf import MlfReader


class LabelRepository:
    def __init__(self, mlf_file: str, output_label_map_file: str,
                 label_dir: Optional[str] = None, label_ext: Optional[str] = None):
        self.mlf = MlfReader(mlf_file)
        self.label_map = self._read_output_label_map(output_label_map_file)
        self.n_outputs = len(self.label_map)
        # '*/' label dir means wildcard directory, keep as-is for lookup
        self.label_dir = label_dir
        self.label_ext = label_ext
        self.trunc_warnings = 0

    @staticmethod
    def _read_output_label_map(path: str) -> Dict[str, int]:
        # ReadOutputLabelMap (Labels.cc:191-212): whitespace-separated tags,
        # ordinal position = output index, duplicates are an error.
        m: Dict[str, int] = {}
        with open(path) as f:
            for tok in f.read().split():
                if tok in m:
                    raise ValueError(f"Duplicate state tag in label map: {tok}")
                m[tok] = len(m)
        if not m:
            raise ValueError(f"Empty output label map: {path}")
        return m

    def _label_file(self, feature_logical: str) -> str:
        name = feature_logical
        if self.label_dir:
            if self.label_dir.endswith("/") and ("*" in self.label_dir or "?" in self.label_dir):
                # wildcard dir: '*/' + basename, matching MakeHtkFileName
                name = self.label_dir + name.split("/")[-1]
            else:
                name = make_htk_filename(name, self.label_dir, None)
        if self.label_ext:
            root, _ = os.path.splitext(name)
            name = root + "." + self.label_ext
        return name

    def get_frame_labels(self, n_frames: int, source_rate: int,
                         feature_logical: str) -> np.ndarray:
        """Return int32 (n_frames,) state indices.

        Reproduces GenDesiredMatrix semantics: frame interval
        [(beg+rate/2)/rate, (end+rate/2)/rate), truncation past n_frames,
        error on double assignment, and the every-frame-assigned check
        (row sums to exactly 1).
        """
        if n_frames < 1:
            raise ValueError(f"Number of frames {n_frames} < 1: {feature_logical}")
        label_file = self._label_file(feature_logical)
        intervals = self.mlf.read_intervals(label_file)

        labels = np.full(n_frames, -1, dtype=np.int32)
        trunc = 0
        for beg, end, tag in intervals:
            if beg < 0:
                raise ValueError(f"Label line without times in {label_file}")
            b = (beg + source_rate // 2) // source_rate
            e = (end + source_rate // 2) // source_rate
            if tag not in self.label_map:
                raise ValueError(f"Unknown state tag: '{tag}' file:'{label_file}'")
            idx = self.label_map[tag]
            for frame in range(b, e):
                if frame >= n_frames:
                    trunc += 1
                    continue
                if labels[frame] != -1:
                    raise ValueError(
                        f"Frame already assigned to other state, file: {label_file} "
                        f"frame: {frame} previously: {labels[frame]} now: {idx}")
                labels[frame] = idx

        if (labels == -1).any():
            bad = int(np.argmax(labels == -1))
            raise ValueError(
                f"Desired vector sum isn't 1.0, file: {label_file} row: {bad}")
        if trunc > 10:
            self.trunc_warnings += 1
        return labels

    def get_onehot(self, n_frames: int, source_rate: int,
                   feature_logical: str) -> np.ndarray:
        """Dense one-hot targets, for parity tests with the reference."""
        labels = self.get_frame_labels(n_frames, source_rate, feature_logical)
        out = np.zeros((n_frames, self.n_outputs), dtype=np.float32)
        out[np.arange(n_frames), labels] = 1.0
        return out

"""Dataset encoding pipeline (counterpart of
``mpstime_tpu/encodings/pipeline.py``): sort samples by class, run the
encoding's host-side ``init`` on training data, then encode the whole
dataset ``[N, T] -> [N, T, d]`` at float64 on the host and cast once to the
model dtype on the fit's device."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..options import MPSOptions, torch_dtype
from .registry import EncodingSpec, get_encoding


@dataclass
class EncodedDataset:
    """Encoded time-series set, class-sorted (reference
    ``EncodedTimeSeriesSet``, src/Structs/structs.jl:29-40).

    X_enc: [N, T, d] encoded product states (tensor on the fit's device);
    y_idx: [N] 0-based class indices, ascending; labels: [C] sorted labels;
    X_orig / X_scaled: [N, T] in the same sorted order;
    class_distribution: [C] sample counts; enc_args: encoding init outputs."""
    X_enc: torch.Tensor
    y_idx: np.ndarray
    labels: np.ndarray
    X_orig: np.ndarray
    X_scaled: np.ndarray
    class_distribution: np.ndarray
    enc_args: Any = None
    encode_separately: bool = False

    def __len__(self):
        return int(self.y_idx.shape[0])

    @property
    def num_classes(self) -> int:
        return int(self.labels.shape[0])


def validate_range(X_scaled: np.ndarray, spec: EncodingSpec) -> None:
    a, b = spec.range
    if X_scaled.size and not ((X_scaled >= a) & (X_scaled <= b)).all():
        raise ValueError(
            f"Data must be rescaled between {a} and {b} before a {spec.name} encoding.")


def encode_dataset(X_orig: np.ndarray, X_scaled: np.ndarray, y: np.ndarray,
                   opts: MPSOptions, spec: Optional[EncodingSpec] = None,
                   labels: Optional[np.ndarray] = None,
                   training_enc_args: Any = None,
                   dtype=None, device="cpu") -> EncodedDataset:
    """Encode a dataset of scaled series (rows) into product states on
    ``device``.  ``training_enc_args`` is passed for test sets of
    data-driven encodings (reference encodings.jl:130-138)."""
    if spec is None:
        spec = get_encoding(opts.encoding, project=opts.projected_basis)
    X_orig = np.asarray(X_orig)
    X_scaled = np.asarray(X_scaled, dtype=np.float64)
    y = np.asarray(y)
    tdt = torch_dtype(opts.resolved_dtype() if dtype is None else dtype)

    if labels is None:
        labels = np.unique(y)
    labels = np.asarray(labels)
    N, T = X_scaled.shape if X_scaled.ndim == 2 else (0, 0)

    if N == 0:
        return EncodedDataset(
            torch.zeros((0, 0, opts.d), dtype=tdt, device=device),
            np.zeros(0, np.int64), labels, X_orig, X_scaled,
            np.zeros(len(labels), np.int64), training_enc_args, False)

    # class-sorted order (stable, matches reference sortperm)
    label_to_idx = {l: i for i, l in enumerate(labels.tolist())}
    y_idx = np.asarray([label_to_idx[l] for l in y.tolist()], dtype=np.int64)
    order = np.argsort(y_idx, kind="stable")
    X_orig_s, X_scaled_s, y_idx_s = X_orig[order], X_scaled[order], y_idx[order]
    class_distribution = np.bincount(y_idx_s, minlength=len(labels)).astype(np.int64)

    validate_range(X_scaled_s, spec)

    if training_enc_args is None:
        enc_args = spec.init(X_scaled_s, y_idx_s, opts.d, opts) \
            if spec.init is not None else None
    else:
        enc_args = training_enc_args

    X_enc = spec.encode_batch(torch.from_numpy(X_scaled_s), opts.d, enc_args)
    return EncodedDataset(X_enc.to(device=device, dtype=tdt), y_idx_s, labels,
                          X_orig_s, X_scaled_s, class_distribution, enc_args,
                          False)

"""Dataset encoding pipeline (counterpart of
``mpstime_tpu/encodings/pipeline.py``): sort samples by class, run the
encoding's host-side ``init`` on training data (per class for a data-driven
basis under ``encode_classes_separately``), then encode the whole dataset
``[N, T] -> [N, T, d]`` at float64 on the host and cast once to the model
dtype on the fit's device."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

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


def _pad_enc(X_enc: torch.Tensor, opts: MPSOptions) -> torch.Tensor:
    """Zero-pad the feature axis from opts.d to opts.pad_to[1]
    (pipeline.py:63-70): the padded trials' basis directions carry exactly
    zero."""
    if opts.pad_to is None or opts.pad_to[1] == X_enc.shape[-1]:
        return X_enc
    return torch.nn.functional.pad(X_enc, (0, opts.pad_to[1] - X_enc.shape[-1]))


def encode_dataset(X_orig: np.ndarray, X_scaled: np.ndarray, y: np.ndarray,
                   opts: MPSOptions, spec: Optional[EncodingSpec] = None,
                   labels: Optional[np.ndarray] = None,
                   training_enc_args: Any = None,
                   dtype=None, device="cuda") -> EncodedDataset:
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
        d_out = opts.d if opts.pad_to is None else opts.pad_to[1]
        return EncodedDataset(
            torch.zeros((0, 0, d_out), dtype=tdt, device=device),
            np.zeros(0, np.int64), labels, X_orig, X_scaled,
            np.zeros(len(labels), np.int64), training_enc_args,
            opts.encode_classes_separately)

    # class-sorted order (stable, matches reference sortperm)
    label_to_idx = {l: i for i, l in enumerate(labels.tolist())}
    y_idx = np.asarray([label_to_idx[l] for l in y.tolist()], dtype=np.int64)
    order = np.argsort(y_idx, kind="stable")
    X_orig_s, X_scaled_s, y_idx_s = X_orig[order], X_scaled[order], y_idx[order]
    class_distribution = np.bincount(y_idx_s, minlength=len(labels)).astype(np.int64)

    validate_range(X_scaled_s, spec)

    is_train = training_enc_args is None

    if opts.encode_classes_separately and spec.is_data_driven:
        # per-class encoding args (reference encodings.jl:50-76)
        enc_args: List[Any] = [] if is_train else training_enc_args
        parts = []
        start = 0
        for ci, cnt in enumerate(class_distribution.tolist()):
            Xc = X_scaled_s[start:start + cnt]
            if is_train:
                args_c = spec.init(Xc, y_idx_s[start:start + cnt], opts.d,
                                   opts) if spec.init is not None else None
                enc_args.append(args_c)
            else:
                args_c = enc_args[ci]
            if cnt:
                parts.append(spec.encode_batch(torch.from_numpy(Xc), opts.d,
                                               args_c))
            start += cnt
        X_enc = torch.cat(parts, dim=0)
        return EncodedDataset(_pad_enc(X_enc.to(device=device, dtype=tdt),
                                       opts), y_idx_s,
                              labels, X_orig_s, X_scaled_s,
                              class_distribution, enc_args, True)

    if is_train:
        enc_args = spec.init(X_scaled_s, y_idx_s, opts.d, opts) \
            if spec.init is not None else None
    else:
        enc_args = training_enc_args

    X_enc = spec.encode_batch(torch.from_numpy(X_scaled_s), opts.d, enc_args)
    return EncodedDataset(_pad_enc(X_enc.to(device=device, dtype=tdt), opts),
                          y_idx_s, labels, X_orig_s, X_scaled_s,
                          class_distribution, enc_args, False)


def encode_series(x_scaled: np.ndarray, opts: MPSOptions, enc_args: Any,
                  spec: Optional[EncodingSpec] = None, class_idx: int = 0,
                  dtype=None, device="cuda") -> torch.Tensor:
    """Encode a single scaled series [T] -> [T, d] on ``device`` using the
    stored training args (float64 on the host, then cast once)."""
    return encode_rows(np.asarray(x_scaled)[None], opts, enc_args, spec,
                       class_idx, dtype, device)[0]


def encode_rows(X_scaled: np.ndarray, opts: MPSOptions, enc_args: Any,
                spec: Optional[EncodingSpec] = None, class_idx: int = 0,
                dtype=None, device="cuda") -> torch.Tensor:
    """Encode scaled series [N, T] -> [N, T, d] on ``device`` with the
    stored training args (one class's under encode_classes_separately), in
    their given order; under ``opts.pad_to`` d is the padded width."""
    if spec is None:
        spec = get_encoding(opts.encoding, project=opts.projected_basis)
    tdt = torch_dtype(opts.resolved_dtype() if dtype is None else dtype)
    args = enc_args[class_idx] if (opts.encode_classes_separately and
                                   isinstance(enc_args, list)) else enc_args
    X = torch.from_numpy(np.asarray(X_scaled, dtype=np.float64))
    return _pad_enc(spec.encode_batch(X, opts.d, args).to(device=device,
                                                           dtype=tdt), opts)

"""Data preprocessing transforms with exact inverses (numpy only; a copy of
``mpstime_tpu.utils.preprocessing``).

Re-implements the reference pipeline (MPSTime.jl src/utils.jl:161-334):
robust-sigmoid transform -> min-max to [0,1] -> affine map to ``data_bounds``
-> per-series out-of-bounds rescue rescaling (test only) -> affine map to the
encoding's domain.  All statistics are computed over the *whole* training
matrix (scalar median/IQR/min/max), matching Normalization.jl's default.

Convention: series are ROWS, ``X: [N, T]`` (the reference uses columns; this
module is host-side numpy at float64 — the transforms are O(N*T) and run once).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..options import MPSOptions
from ..encodings import encoding_range


def _enc_range(opts) -> "tuple[float, float]":
    """Encoding domain: a custom spec's stamped range wins over the
    name-derived default (fit_mps records it in custom_encoding_range)."""
    if opts.encoding == "custom" and opts.custom_encoding_range is not None:
        return opts.custom_encoding_range
    return encoding_range(opts.encoding)


@dataclass
class TransformNorms:
    """Fitted normalisation statistics (the reference's ``norms`` vector of
    Normalization.jl objects, utils.jl:199)."""
    sigmoid_median: Optional[float] = None
    sigmoid_iqr: Optional[float] = None
    minmax_min: Optional[float] = None
    minmax_max: Optional[float] = None

    def to_dict(self) -> dict:
        return {k: (None if v is None else float(v)) for k, v in self.__dict__.items()}

    @classmethod
    def from_dict(cls, d: dict) -> "TransformNorms":
        return cls(**d)


def _robust_sigmoid(X: np.ndarray, med: float, iqr: float) -> np.ndarray:
    # X' = (1 + exp(-(X - median)/(iqr/1.35)))^-1     (options.jl docstring :72-77)
    scale = iqr / 1.35
    if scale == 0:
        scale = 1.0
    return 1.0 / (1.0 + np.exp(-(X - med) / scale))


def _robust_sigmoid_inv(Y: np.ndarray, med: float, iqr: float) -> np.ndarray:
    scale = iqr / 1.35
    if scale == 0:
        scale = 1.0
    Yc = np.clip(Y, np.finfo(np.float64).tiny, 1.0 - 1e-16)
    return med - scale * np.log(1.0 / Yc - 1.0)


def transform_train_data(X_train: np.ndarray, opts: MPSOptions
                         ) -> Tuple[np.ndarray, TransformNorms]:
    """Fit + apply the train transform (reference utils.jl:161-200)."""
    X = np.asarray(X_train, dtype=np.float64).copy()
    norms = TransformNorms()

    if opts.sigmoid_transform and X.size:
        norms.sigmoid_median = float(np.median(X))
        norms.sigmoid_iqr = float(np.quantile(X, 0.75) - np.quantile(X, 0.25))
        X = _robust_sigmoid(X, norms.sigmoid_median, norms.sigmoid_iqr)

    if opts.minmax and X.size:
        norms.minmax_min = float(X.min())
        norms.minmax_max = float(X.max())
        rng = norms.minmax_max - norms.minmax_min
        if rng == 0:
            rng = 1.0
        X = (X - norms.minmax_min) / rng
        lb, ub = opts.data_bounds
        X = X * (ub - lb) + lb

    a, b = _enc_range(opts)
    X = (b - a) * X + a
    return X, norms


def transform_test_data(X_test: np.ndarray, norms: TransformNorms, opts: MPSOptions,
                        rescale_out_of_bounds: bool = True
                        ) -> Tuple[np.ndarray, List[Tuple[int, float, float]]]:
    """Apply the train-fitted transform to test data, with the per-series
    out-of-bounds rescue (reference utils.jl:202-278).

    Returns the scaled data and ``oob_rescales``: a list of
    ``(series_index, lb_shift, ub_scale)`` records needed for exact inversion.
    """
    X = np.asarray(X_test, dtype=np.float64)
    if X.size == 0:
        return X.copy(), []
    squeeze = X.ndim == 1
    if squeeze:
        X = X[None, :]
    X = X.copy()

    if norms.sigmoid_median is not None:
        X = _robust_sigmoid(X, norms.sigmoid_median, norms.sigmoid_iqr)
    if norms.minmax_min is not None:
        rng = norms.minmax_max - norms.minmax_min
        if rng == 0:
            rng = 1.0
        X = (X - norms.minmax_min) / rng
        lb, ub = opts.data_bounds
        X = X * (ub - lb) + lb

    oob_rescales: List[Tuple[int, float, float]] = []
    if rescale_out_of_bounds:
        num_scaled = 0
        for i in range(X.shape[0]):
            ts = X[i]
            finite = np.isfinite(ts)
            if not finite.any():
                continue
            lb_i = float(ts[finite].min())
            ub_i = float(ts[finite].max())
            shift, scale = 0.0, 1.0
            if lb_i < 0:
                ts -= lb_i
                shift = lb_i
                ub_i = float(ts[finite].max())
            if ub_i > 1:
                ts /= ub_i
                scale = ub_i
            if shift != 0.0 or scale != 1.0:
                num_scaled += 1
                oob_rescales.append((i, shift, scale))
            X[i] = ts
        if opts.verbosity > -1 and num_scaled > 0:
            print(f"The test set couldn't be perfectly rescaled by the training set "
                  f"normalization, {num_scaled} additional rescaling operations had "
                  f"to be performed!")

    a, b = _enc_range(opts)
    X = (b - a) * X + a
    if squeeze:
        X = X[0]
    return X, oob_rescales


def transform_data(X_train: np.ndarray, X_test: np.ndarray, opts: MPSOptions):
    """Fit on train, apply to both (reference utils.jl:287-295)."""
    X_train_s, norms = transform_train_data(X_train, opts)
    X_test_s, oob = transform_test_data(X_test, norms, opts)
    return X_train_s, X_test_s, norms, oob


def invert_test_transform(X_scaled: np.ndarray,
                          oob_rescales: List[Tuple[int, float, float]],
                          norms: TransformNorms, opts: MPSOptions) -> np.ndarray:
    """Exact inverse of :func:`transform_test_data` (reference utils.jl:299-334)."""
    X = np.asarray(X_scaled, dtype=np.float64)
    squeeze = X.ndim == 1
    if squeeze:
        X = X[None, :]
    X = X.copy()

    a, b = _enc_range(opts)
    X = (X - a) / (b - a)

    for (i, shift, scale) in oob_rescales:
        X[i] = X[i] * scale + shift

    if opts.minmax and norms.minmax_min is not None:
        lb, ub = opts.data_bounds
        X = (X - lb) / (ub - lb)
        rng = norms.minmax_max - norms.minmax_min
        if rng == 0:
            rng = 1.0
        X = X * rng + norms.minmax_min

    if opts.sigmoid_transform and norms.sigmoid_median is not None:
        X = _robust_sigmoid_inv(X, norms.sigmoid_median, norms.sigmoid_iqr)

    if squeeze:
        X = X[0]
    return X

"""Classification (counterpart of ``mpstime_tpu/summary.py``; reference
src/summary.jl)."""

from __future__ import annotations

import numpy as np
import torch

from .encodings import EncodedDataset, encode_dataset
from .models.mps import contract_batch_scaled
from .training.fit import TrainedMPS
from .utils.preprocessing import transform_test_data


def _encode_test(mps: TrainedMPS, X_test: np.ndarray) -> EncodedDataset:
    opts = mps.opts.replace(verbosity=-10)
    X_test = np.asarray(X_test, dtype=np.float64)
    X_test_s, _ = transform_test_data(X_test, mps.norms, opts)
    y = np.zeros(X_test.shape[0], dtype=np.int64)
    return encode_dataset(X_test, X_test_s, y, opts, spec=mps.encoding_spec(),
                          labels=np.unique(y),
                          training_enc_args=mps.train_data.enc_args,
                          dtype=mps.opts.resolved_dtype(),
                          device=mps.mps.device)


def classify(mps: TrainedMPS, X_test: np.ndarray) -> np.ndarray:
    """Predict class labels for the rows of X_test by maximum overlap
    (reference classify, summary.jl:116-177)."""
    return classify_encoded(mps, _encode_test(mps, X_test).X_enc)


def classify_encoded(mps: TrainedMPS, X_enc: torch.Tensor) -> np.ndarray:
    """Predict labels for already-encoded states [N, T, d]."""
    yhat_s, _ = contract_batch_scaled(mps.mps, X_enc)
    preds_idx = torch.argmax(yhat_s.abs() ** 2, dim=1).cpu().numpy()
    return mps.labels[preds_idx]

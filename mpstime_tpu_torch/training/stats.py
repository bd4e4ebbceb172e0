"""Per-sweep loss/accuracy statistics (counterpart of
``mpstime_tpu/training/stats.py``; reference summary.jl:33-114)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.mps import MPS, contract_batch_scaled


def loss_acc_conf(mps: MPS, X_enc: torch.Tensor, y_idx: np.ndarray
                  ) -> Tuple[float, float, float, np.ndarray]:
    """(mse_loss, kld_loss, accuracy, confusion[true, pred]) over a dataset
    of encoded states [N, T, d] (reference MSE_loss_acc_conf,
    summary.jl:102-114)."""
    C = mps.num_classes
    yhat_s, ls = contract_batch_scaled(mps, X_enc)
    y = torch.as_tensor(np.asarray(y_idx), dtype=torch.long,
                        device=yhat_s.device)
    onehot = torch.nn.functional.one_hot(y, C).to(yhat_s.dtype)
    yhat = yhat_s * torch.exp(ls)[:, None].to(yhat_s.dtype)
    mse = 0.5 * torch.mean(torch.sum((yhat - onehot).abs() ** 2, dim=1))
    y_true_s = torch.sum(yhat_s * onehot, dim=1)
    kld = torch.mean(-torch.log(y_true_s.abs() ** 2) - 2.0 * ls)
    preds = torch.argmax(yhat_s.abs(), dim=1)
    acc = torch.mean((preds == y).to(torch.float32))
    conf = torch.zeros((C, C), dtype=torch.long, device=y.device)
    conf.index_put_((y, preds), torch.ones_like(y), accumulate=True)
    return float(mse), float(kld), float(acc), conf.cpu().numpy()


def predict_class_indices(mps: MPS, X_enc: torch.Tensor) -> np.ndarray:
    """argmax_c |yhat_c| predictions as 0-based class indices
    (scale-invariant: uses the scaled contraction)."""
    yhat_s, _ = contract_batch_scaled(mps, X_enc)
    return torch.argmax(yhat_s.abs(), dim=1).cpu().numpy()

"""Classification, evaluation summaries and sweep tables (counterpart of
``mpstime_tpu/summary.py``; reference src/summary.jl)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .encodings import EncodedDataset, encode_dataset
from .models.mps import (contract_batch_scaled, expand_label_index,
                         single_contract_batch_scaled)
from .training.fit import TrainedMPS
from .utils import profiling
from .utils.preprocessing import transform_test_data


def _encode_test(mps: TrainedMPS, X_test: np.ndarray) -> EncodedDataset:
    with profiling.annotate("mps/classify/encode"):
        opts = mps.opts.replace(verbosity=-10)
        X_test = np.asarray(X_test, dtype=np.float64)
        X_test_s, _ = transform_test_data(X_test, mps.norms, opts)
        y = np.zeros(X_test.shape[0], dtype=np.int64)
        return encode_dataset(X_test, X_test_s, y, opts,
                              spec=mps.encoding_spec(), labels=np.unique(y),
                              training_enc_args=mps.train_data.enc_args,
                              dtype=mps.opts.resolved_dtype(),
                              device=mps.mps.device)


@profiling.traced("mps/classify")
def classify(mps: TrainedMPS, X_test: np.ndarray) -> np.ndarray:
    """Predict class labels for the rows of X_test by maximum overlap
    (reference classify, summary.jl:116-177)."""
    return classify_encoded(mps, _encode_test(mps, X_test).X_enc)


def classify_encoded(mps: TrainedMPS, X_enc: torch.Tensor) -> np.ndarray:
    """Predict labels for already-encoded states [N, T, d]."""
    with profiling.annotate("mps/classify/contract"):
        yhat_s, _ = contract_batch_scaled(mps.mps, X_enc)
        preds_idx = torch.argmax(yhat_s.abs() ** 2, dim=1).cpu().numpy()
    return mps.labels[preds_idx]


def classify_overlap(Ws: list, X_enc: torch.Tensor
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class-MPS overlaps (reference classify_overlap, summary.jl:
    182-202).  Returns (pred class indices, log-overlaps log|<psi_c|phi_n>|
    [N, C]); the log domain, as the JAX package's, keeps long series from
    underflowing."""
    parts = [single_contract_batch_scaled(w, X_enc) for w in Ws]
    log_ovl = torch.stack(
        [torch.log(torch.clamp(y.abs(), min=torch.finfo(ls.dtype).tiny)) + ls
         for (y, ls) in parts], dim=1)                        # [N, C]
    return (torch.argmax(log_ovl, dim=1).cpu().numpy(),
            log_ovl.cpu().numpy())


def confusion_matrix(y_true_idx: np.ndarray, y_pred_idx: np.ndarray,
                     num_classes: int) -> np.ndarray:
    conf = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(conf, (y_true_idx, y_pred_idx), 1)
    return conf


def _per_class_prf(conf: np.ndarray):
    """Multiclass macro-averaged precision/recall/F1/specificity from a
    confusion matrix conf[true, pred] (reference summary.jl:316-323 via
    MLBase)."""
    tp = np.diag(conf).astype(np.float64)
    fp = conf.sum(axis=0) - tp
    fn = conf.sum(axis=1) - tp
    tn = conf.sum() - tp - fp - fn
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        rec = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        spec = np.where(tn + fp > 0, tn / (tn + fp), 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
    return prec.mean(), rec.mean(), spec.mean(), f1.mean()


def get_training_summary(mps: TrainedMPS, test_states: EncodedDataset,
                         print_stats: bool = False) -> Dict[str, object]:
    """Overlap matrix, confusion matrix, and summary statistics
    (reference get_training_summary, summary.jl:225-355)."""
    Ws = expand_label_index(mps.mps)
    C = len(Ws)
    tr = mps.train_data
    preds_tr, _ = classify_overlap(Ws, tr.X_enc)
    acc_train = float(np.mean(preds_tr == tr.y_idx))

    preds_te, _ = classify_overlap(Ws, test_states.X_enc)
    true_te = test_states.y_idx
    acc_test = float(np.mean(preds_te == true_te))

    centers = torch.stack([w.center for w in Ws])
    ov = _overlap_matrix(Ws[0].cores, centers, center_pos=Ws[0].center_pos)
    overlapmat = ov.abs().cpu().numpy()

    conf = confusion_matrix(true_te, preds_te, C)
    prec, rec, spec, f1 = _per_class_prf(conf)
    # balanced accuracy: the mean recall per class
    with np.errstate(invalid="ignore"):
        per_class_rec = np.where(conf.sum(1) > 0, np.diag(conf) / conf.sum(1),
                                 0.0)
    stats = {
        "train_acc": acc_train,
        "test_acc": acc_test,
        "test_balanced_acc": float(per_class_rec.mean()),
        "precision": float(prec),
        "recall": float(rec),
        "specificity": float(spec),
        "f1_score": float(f1),
        "confmat": conf,
        "overlapmat": overlapmat,
    }
    if print_stats:
        print("Overlap matrix:\n", np.array2string(overlapmat, precision=4))
        print("Confusion matrix (rows=true, cols=pred):\n", conf)
        for k in ("test_balanced_acc", "train_acc", "test_acc", "f1_score",
                  "specificity", "recall", "precision"):
            print(f"  {k}: {stats[k]:.6f}")
    return stats


def _overlap_matrix(cores: torch.Tensor, centers: torch.Tensor, *,
                    center_pos: int) -> torch.Tensor:
    """Gram matrix O[i, j] = <psi_i | psi_j> of per-class MPSs that share
    the core chain ``cores`` [T, chi, d, chi] and differ only in the center
    ``centers`` [C, chi, d, chi] at site ``center_pos``: the chain's
    transfer environments are built once (left of and right of the center)
    and only the center contraction is pairwise."""
    chi = cores.shape[1]
    E0 = torch.zeros((chi, chi), dtype=cores.dtype, device=cores.device)
    E0[0, 0] = 1.0
    L = E0
    for a in cores[:center_pos]:
        # E[p, q] -> E'[r, s] = conj(a[p,i,r]) E[p,q] a[q,i,s]
        L = torch.einsum("pir,pis->rs", a.conj(),
                         torch.einsum("pq,qis->pis", L, a))
    R = E0
    for a in torch.flip(cores[center_pos + 1:], (0,)):
        # R[r, s] -> R'[p, q] = conj(a[p,i,r]) a[q,i,s] R[r,s]
        R = torch.einsum("pir,qir->pq", a.conj(),
                         torch.einsum("qis,rs->qir", a, R))
    right = torch.einsum("jqks,rs->jqkr", centers, R)
    left = torch.einsum("pq,jqkr->jpkr", L, right)
    return torch.einsum("ipkr,jpkr->ij", centers.conj(), left)


def sweep_summary(info: Dict[str, list], out=None) -> None:
    """Pretty per-sweep summary table (reference sweep_summary,
    summary.jl:380-430)."""
    keys = [("Train Accuracy", "train_acc"), ("Test Accuracy", "test_acc"),
            ("Train KL Div.", "train_KL_div"), ("Test KL Div.", "test_KL_div"),
            ("Time taken", "time_taken")]
    n = len(info.get("time_taken", []))
    if n == 0:
        print("(no logged sweeps)", file=out)
        return
    header = ["Initial"] + [f"After Sweep {i+1}" for i in range(n - 2)] + \
             ["After Norm", "Mean"]
    print("  " + " | ".join(f"{h:>14}" for h in [""] + header), file=out)
    for (label, key) in keys:
        vals = info.get(key, [])
        if not vals:
            continue
        mean = float(np.nanmean(vals[1:-1])) if len(vals) > 2 else float("nan")
        row = [label] + [f"{v:.6g}" for v in vals] + [f"{mean:.6g}"]
        print("  " + " | ".join(f"{c:>14}" for c in row), file=out)


def KL_div(mps: TrainedMPS, test_states: EncodedDataset) -> float:
    """Mean -log|<psi_y|phi>|^2 over a dataset (reference summary.jl:
    459-471), reduced on the device; only the scalar reaches the host."""
    yhat_s, ls = contract_batch_scaled(mps.mps, test_states.X_enc)
    onehot = torch.as_tensor(np.eye(mps.mps.num_classes)[test_states.y_idx],
                             dtype=yhat_s.dtype, device=yhat_s.device)
    y_true = torch.sum(yhat_s * onehot, dim=1)
    return float(torch.mean(-torch.log(y_true.abs() ** 2) - 2.0 * ls))

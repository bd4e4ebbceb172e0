"""Tuning losses, CV folds, and imputation windows
(reference src/Training/hyperparameters/hyperopt_utils.jl; a NumPy copy of
``mpstime_tpu/hyperopt/losses.py``, which the port does not import)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from ..simulation import mar
from ..summary import classify
from ..training.fit import TrainedMPS


class TuningLoss:
    def __repr__(self):
        return type(self).__name__ + "()"


class MisclassificationRate(TuningLoss):
    pass


class BalancedMisclassificationRate(TuningLoss):
    pass


class ImputationLoss(TuningLoss):
    pass


def is_omp_threading() -> bool:
    """Whether OMP threading is pinned to one thread (reference
    is_omp_threading, hyperopt_utils.jl:44-46; here informational only —
    PyTorch owns threading)."""
    import os
    return os.environ.get("OMP_NUM_THREADS") == "1"


def make_stratified_cvfolds(Xs: np.ndarray, ys: np.ndarray, nfolds: int, *,
                            rng=None, shuffle: bool = True) -> List[tuple]:
    """Stratified k-fold train/validation index pairs (reference
    make_stratified_cvfolds, hyperopt_utils.jl:101-105, via MLJ StratifiedCV):
    within each class, (optionally shuffled) indices are dealt round-robin to
    the folds; fold i's members are its validation set."""
    ys = np.asarray(ys)
    n = len(ys)
    g = np.random.default_rng(rng)
    fold_of = np.empty(n, dtype=np.int64)
    for cls in np.unique(ys):
        idx = np.where(ys == cls)[0]
        if shuffle:
            idx = g.permutation(idx)
        fold_of[idx] = np.arange(len(idx)) % nfolds
    folds = []
    for f in range(nfolds):
        val = np.where(fold_of == f)[0]
        train = np.where(fold_of != f)[0]
        if len(val) == 0:
            raise ValueError(f"stratified CV fold {f} is empty; reduce nfolds")
        folds.append((train, val))
    return folds


def make_windows(windows, pms, X: np.ndarray, rng=None) -> List[np.ndarray]:
    """Resolve manual windows or percentage-missing specs into site-index
    windows (reference make_windows, hyperopt_utils.jl:107-131)."""
    if windows is not None:
        if pms is not None:
            raise ValueError("Cannot specify both windows and pms!")
        if isinstance(windows, dict):
            return [np.asarray(windows[k], dtype=int)
                    for k in sorted(windows.keys())]
        return [np.asarray(w, dtype=int) for w in windows]
    if pms is not None:
        T = X.shape[1]
        g = np.random.default_rng(rng)
        pms = [p / 100 if isinstance(p, (int, np.integer)) and p > 1 else p
               for p in pms]
        return [mar(np.arange(T, dtype=float), float(p), rng=g)[1] for p in pms]
    raise ValueError("Must specify either windows or pms when measuring "
                     "Imputation Loss!")


def eval_loss(objective: TuningLoss, mps: TrainedMPS, X_val: np.ndarray,
              y_val: np.ndarray, windows=None, *, method: str = "median",
              verbosity: int = 0) -> np.ndarray:
    """Evaluate a tuning loss on a validation set (reference eval_loss,
    hyperopt_utils.jl:152-231).  Returns a vector (per window for
    ImputationLoss; length 1 otherwise)."""
    y_val = np.asarray(y_val)

    if isinstance(objective, MisclassificationRate):
        preds = classify(mps, X_val)
        return np.array([1.0 - np.mean(preds == y_val)])

    if isinstance(objective, BalancedMisclassificationRate):
        preds = classify(mps, X_val)
        classes = np.unique(np.concatenate([y_val, preds]))
        recall_sum = 0.0
        for cls in classes:
            tp = np.sum((y_val == cls) & (preds == cls))
            fn = np.sum((y_val == cls) & (preds != cls))
            recall_sum += tp / (tp + fn + np.finfo(float).eps)
        return np.array([1.0 - recall_sum / len(classes)])

    if isinstance(objective, ImputationLoss):
        from ..imputation import init_imputation_problem
        from ..imputation.problem import impute_windows
        if windows is None:
            raise ValueError("ImputationLoss requires windows")
        imp = init_imputation_problem(mps, X_val, y_val, verbosity=-5,
                                      test_encoding=False)
        # all (instance, window) pairs of a class run as one impute_windows
        # call: the instances on the batch axis, one scan per window (the
        # reference loops MPS_impute per (instance, window),
        # hyperopt_utils.jl:201-227)
        total = np.zeros(len(windows))
        for cls in np.unique(y_val):
            n_c = int(np.sum(y_val == cls))
            rel = np.arange(n_c)
            # pad_b_to buckets the instance axis as the JAX package does (its
            # folds then share one compiled program), so both see the same
            # batches
            ts, targets = impute_windows(imp, cls, rel, windows, method,
                                         pad_b_to=8)
            for iw, sites in enumerate(windows):
                sites = np.asarray(sites, dtype=int)
                mae_per = np.mean(np.abs(ts[iw][:, sites] -
                                         targets[:, sites]), axis=1)
                total[iw] += mae_per.sum()
        return total / len(y_val)

    raise TypeError(f"unknown objective {objective!r}")

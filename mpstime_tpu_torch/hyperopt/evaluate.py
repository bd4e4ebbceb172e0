"""Nested-resampling benchmark, ``evaluate`` (counterpart of
``mpstime_tpu/hyperopt/evaluate.py``; reference
src/Training/hyperparameters/evaluate.jl).

Outer resampled folds -> inner ``tune`` -> refit on the fold's training set
-> test loss, with per-fold checkpoint files for resume.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from ..options import MPSOptions
from ..training.fit import fit_mps
from .losses import (ImputationLoss, MisclassificationRate, TuningLoss,
                     BalancedMisclassificationRate, eval_loss,
                     make_stratified_cvfolds, make_windows)
from .random_search import MPSRandomSearch
from .tuning import _padded_caps, tune


def evaluate(Xs: np.ndarray, ys: Optional[np.ndarray] = None,
             nfolds: int = 5, tuning_parameters: Optional[Dict] = None,
             tuning_optimiser: Optional[MPSRandomSearch] = None, *,
             objective: TuningLoss = None,
             verbosity: int = 1,
             opts0: Optional[MPSOptions] = None,
             tuning_opts0: Optional[MPSOptions] = None,
             n_cvfolds: int = 5,
             fold_inds: Optional[Sequence[int]] = None,
             logspace_eta: bool = False,
             rng: Union[int, np.random.Generator] = 1,
             tuning_rng: Optional[Sequence[int]] = None,
             foldmethod: Union[Callable, list] = make_stratified_cvfolds,
             tuning_foldmethod: Union[Callable, list] = make_stratified_cvfolds,
             eval_pms=None, eval_windows=None,
             tuning_pms=None, tuning_windows=None,
             tuning_maxiters: int = 250,
             impute_method: str = "median",
             n_workers: int = 0,
             devices=None,
             padded_trials: bool = True,
             fold_batch: bool = False,
             write: bool = False,
             writedir: str = "evals",
             simname: Optional[str] = None,
             overwrite: bool = False,
             delete_tmps: Optional[bool] = None,
             device="cuda") -> List[Dict[str, Any]]:
    """Evaluate tuned-MPS performance over resampled folds (reference
    evaluate, evaluate.jl:136-306).  Returns one result dict per fold with
    the reference's keys (evaluate.jl:247-261).

    ``device``: where the unfarmed route tunes, refits and evaluates, the
    card ("cuda", the default) or "cpu".

    ``devices``: farm outer folds across local devices (the Distributed.jl
    ``distribute_folds``/``pmap(_eval_fold, ...)`` analog, evaluate.jl:281).
    True/"all" uses every local card; a list of torch devices may repeat
    one; ``"processes[:N]"`` (workers on ``device``) or a ProcessFarm (on
    its ``platform``) ships whole folds to worker processes, each fold on
    its worker's device.  When there are more
    devices than outer folds, the device list is partitioned between the
    folds (the
    ``divide_procs`` analog, hyperopt_utils.jl:49-60) and each fold's inner
    ``tune`` farms its CV folds over its sublist; otherwise inner tunes run
    sequentially within each fold's device.

    ``fold_batch``: passed through to the inner ``tune`` — each trial's CV
    folds train through ``fit_mps_batch`` (see tune's docstring)."""
    if ys is None:
        ys = np.zeros(Xs.shape[0], dtype=np.int64)
    Xs = np.asarray(Xs, dtype=np.float64)
    ys = np.asarray(ys)
    if objective is None:
        objective = ImputationLoss()
    if tuning_optimiser is None:
        tuning_optimiser = MPSRandomSearch()
    if tuning_parameters is None:
        tuning_parameters = {}
    if opts0 is None:
        opts0 = MPSOptions(
            verbosity=-5, log_level=-1,
            sigmoid_transform=isinstance(objective, (MisclassificationRate,
                                                     BalancedMisclassificationRate)))
    if tuning_opts0 is None:
        tuning_opts0 = opts0
    if fold_inds is None:
        fold_inds = list(range(nfolds))
    if tuning_rng is None:
        tuning_rng = list(range(1, nfolds + 1))
    if tuning_pms is None and tuning_windows is None:
        tuning_pms, tuning_windows = eval_pms, eval_windows
    if delete_tmps is None:
        delete_tmps = len(fold_inds) == nfolds

    from ..parallel.farm import (DeviceFarm, resolve_devices,
                                 resolve_process_farm)

    # process backend: outer folds ship whole to spawned worker processes
    # (the reference's evaluate worker-pool partitioning, evaluate.jl:270-297,
    # with one process per fold job); each worker's inner tune runs in its
    # own process and may still thread via n_workers
    proc_farm = resolve_process_farm(devices, device)
    farm_devs = None if proc_farm is not None else resolve_devices(devices)
    farming = bool(farm_devs) and len(farm_devs) > 1
    if farm_devs and len(farm_devs) == 1:
        device = farm_devs[0]               # one device: no farm, run there
    if farming and n_workers > 0:
        # as the JAX package: a farmed fold's inner tune runs sequentially
        # on the fold's device (a thread pool inside each farmed fold would
        # oversubscribe the devices the farm already keeps busy)
        import warnings
        warnings.warn("evaluate(devices=...): inner tune runs sequentially "
                      "within each fold's device; n_workers is ignored.")
        n_workers = 0

    g = rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)

    resolved_eval_windows = None
    if isinstance(objective, ImputationLoss):
        resolved_eval_windows = make_windows(eval_windows, eval_pms, Xs, g)

    folds = foldmethod(Xs, ys, nfolds, rng=g) if callable(foldmethod) else foldmethod

    if simname is None:
        simname = (f"{objective}_{tuning_optimiser}_f={nfolds}_cv={n_cvfolds}"
                   f"_iters={tuning_maxiters}")
    outfile = os.path.join(writedir.rstrip("/"), simname.strip("/") + ".pkl")
    tmpdir = os.path.join(writedir.rstrip("/"), simname.strip("/") + "_tmp")
    if write:
        os.makedirs(tmpdir, exist_ok=True)

    tstart = time.time()

    def _eval_fold(fold: int, dev, inner_devices=None) -> Dict[str, Any]:
        fname = os.path.join(tmpdir, f"f{fold}.pkl")
        if write and os.path.isfile(fname):
            if overwrite:
                print(f"Fold {fold} already exists, overwriting...")
            else:
                print(f"Fold {fold} already exists, skipping...")
                with open(fname, "rb") as f:
                    return pickle.load(f)

        if verbosity > -1:
            print(f"Beginning fold {fold}:")
        tbeg = time.time()
        train_inds, test_inds = folds[fold]
        X_tr, y_tr = Xs[train_inds], ys[train_inds]
        X_te, y_te = Xs[test_inds], ys[test_inds]

        g_inner = np.random.default_rng(tuning_rng[fold])
        tuning_windows_inner = None
        if isinstance(objective, ImputationLoss):
            tuning_windows_inner = make_windows(tuning_windows, tuning_pms,
                                                Xs, g_inner)

        best_params, cache = tune(
            X_tr, y_tr, n_cvfolds, tuning_parameters, tuning_optimiser,
            objective=objective, opts0=tuning_opts0,
            logspace_eta=logspace_eta, windows=tuning_windows_inner,
            maxiters=tuning_maxiters, verbosity=verbosity, rng=g_inner,
            foldmethod=tuning_foldmethod, impute_method=impute_method,
            n_workers=n_workers, devices=inner_devices,
            padded_trials=padded_trials, fold_batch=fold_batch,
            pre_string=f"Fold {fold}: ", device=dev)

        opts = opts0.replace(**best_params)
        if padded_trials:
            # the final refit reuses the tune caps, as the JAX package's
            # (where every fold's refit + test eval then share one program)
            caps = _padded_caps(dict(tuning_parameters), tuning_opts0)
            if caps is not None and caps[0] >= opts.chi_max \
                    and caps[1] >= opts.d:
                opts = opts.replace(pad_to=caps)
        if verbosity >= 1:
            print(f"fold {fold}: t={time.time() - tstart:.2f}s: training MPS "
                  f"with {best_params}... ")
        mps, _, _ = fit_mps(X_tr, y_tr, opts=opts, device=dev)
        loss = eval_loss(objective, mps, X_te, y_te, resolved_eval_windows,
                         method=impute_method)
        res = {
            "fold": fold,
            "objective": str(objective),
            "train_inds": np.asarray(train_inds),
            "test_inds": np.asarray(test_inds),
            "optimiser": str(tuning_optimiser),
            "tuning_windows": tuning_windows_inner,
            "tuning_pms": tuning_pms,
            "eval_windows": resolved_eval_windows,
            "eval_pms": eval_pms,
            "time": time.time() - tbeg,
            "opts": opts,
            "cache": cache,
            "loss": loss if len(loss) > 1 else float(loss[0]),
        }
        if write:
            with open(fname, "wb") as f:
                pickle.dump(res, f)
            print(f"saved fold at {fname}")
        return res

    if proc_farm is not None:
        try:
            results = proc_farm.map(_eval_fold, list(fold_inds))
        finally:
            # close a farm built implicitly from a string spelling; a
            # caller-provided ProcessFarm instance stays open (CachingPool)
            if isinstance(devices, str):
                proc_farm.close()
    elif farming:
        from ..parallel.farm import divide_devices
        sublists = divide_devices(farm_devs, len(fold_inds))
        # each fold's job runs on the first device of its sublist; when a
        # sublist has >1 device the fold's inner tune farms its CV folds
        # over the sublist (every job is handed its device, so the nesting
        # is safe)
        jobs = [(f, sub if len(sub) > 1 else None)
                for f, sub in zip(fold_inds, sublists)]
        results = DeviceFarm([s[0] for s in sublists]).map(
            lambda job, dev: _eval_fold(job[0], dev, job[1]), jobs)
    else:
        results = [_eval_fold(f, device) for f in fold_inds]

    if write:
        os.makedirs(os.path.dirname(outfile) or ".", exist_ok=True)
        with open(outfile, "wb") as f:
            pickle.dump(results, f)
        print(f"Results saved to {outfile}")
        if delete_tmps:
            import shutil
            shutil.rmtree(tmpdir, ignore_errors=True)
    return results

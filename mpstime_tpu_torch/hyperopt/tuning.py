"""Hyperparameter tuning, ``tune`` (counterpart of
``mpstime_tpu/hyperopt/tuning.py``; reference
src/Training/hyperparameters/tuning.jl).

Parallelism: the reference farms CV folds / trials to Distributed.jl worker
processes (tuning.jl:112, random_search.jl:115).  Here ``devices=...``
farms each CV fold onto a device of its own (a thread per device, each
job handed its device, parallel/farm.py) or onto worker processes
(parallel/procfarm.py), and ``n_workers>0`` overlaps folds with plain
threads on ``device`` (PyTorch releases the GIL in its operations, so host
work overlaps while the device serialises compute).

Errors: a fold whose fit fails numerically (``FloatingPointError``, NumPy's
or PyTorch's ``LinAlgError``) is retried with ``svd_alg="svd"`` as the
reference does (tuning.jl:73-84).  Nothing else is caught: a failed kernel
build or launch (a ``RuntimeError``) ends the search.
"""

from __future__ import annotations

import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..options import MPSOptions
from ..training.fit import fit_mps
from .losses import (BalancedMisclassificationRate, ImputationLoss,
                     MisclassificationRate, TuningLoss, eval_loss,
                     make_stratified_cvfolds, make_windows)
from .random_search import MPSRandomSearch, grid_search
from .solvers import ScipySolver

#: The numerical failures of a fit that ``tune`` retries or routes around:
#: never a bare RuntimeError (a kernel that fails to build or launch).
NUMERICAL_ERRORS = (FloatingPointError, np.linalg.LinAlgError,
                    torch.linalg.LinAlgError)


def _parse_parameters(parameters: Dict[str, Any], opts0: MPSOptions,
                      logspace_eta: bool):
    """Parse the search-space spec into bounds/value-maps (reference
    tune() parameter parsing, tuning.jl:403-478).

    Formats per key: [values] | (lb, ub) | (lb, step, ub) | ().
    Returns (fields, x0, lb, ub, is_disc, types, value_map) sorted by field."""
    fields, x0, lb, ub, is_disc, types, value_map = [], [], [], [], [], [], []
    for key, val in parameters.items():
        if not hasattr(opts0, key):
            raise ValueError(f"MPSOptions has no hyperparameter {key!r}")
        startx = getattr(opts0, key)
        if not isinstance(startx, (int, float, np.integer, np.floating)) or \
                isinstance(startx, bool):
            raise ValueError(f"Cannot tune {key!r}, only numeric types can be "
                             "hyperoptimised.")
        ptype = int if isinstance(startx, (int, np.integer)) else float

        if logspace_eta and key == "eta":
            # any 2-element bounds container is accepted (tuple/list/array)
            if len(val) != 2:
                raise ValueError("logspace_eta requires eta bounds "
                                 "eta=(lb, ub)")
            if val[0] <= 0:
                raise ValueError("Lower and upper bounds on eta must be "
                                 "positive!")
            val = (np.log10(val[0]), np.log10(val[1]))

        if isinstance(val, (list, np.ndarray)):
            vm = sorted(float(v) for v in val)
            value_map.append(vm)
            is_disc.append(True)
            lo, hi = 1.0, float(len(vm))
        elif isinstance(val, tuple):
            if len(val) == 3:
                vm = list(np.arange(val[0], val[2] + val[1] / 2, val[1],
                                    dtype=np.float64))
                value_map.append(vm)
                is_disc.append(True)
                lo, hi = 1.0, float(len(vm))
            elif len(val) == 2:
                value_map.append([])
                is_disc.append(ptype is int)
                lo, hi = float(val[0]), float(val[1])
            elif len(val) == 0:
                value_map.append([])
                is_disc.append(ptype is int)
                lo = 1.0 if ptype is int else np.finfo(np.float64).eps
                hi = float(2 ** 30) if ptype is int else np.finfo(np.float64).max
            else:
                raise ValueError("Unknown parameter format. Options are "
                                 "key=[vals], key=(), key=(lb,ub), "
                                 "key=(lb,step,ub)")
        else:
            raise ValueError("Unknown parameter format. Options are "
                             "key=[vals], key=(), key=(lb,ub), key=(lb,step,ub)")

        sx = float(startx)
        if logspace_eta and key == "eta" and not value_map[-1]:
            sx = np.log10(max(sx, 1e-300))
        if sx < lo or sx > hi:
            sx = lo
        fields.append(key)
        x0.append(sx)
        lb.append(lo)
        ub.append(hi)
        types.append(ptype)

    order = np.argsort(fields, kind="stable")
    pick = lambda v: [v[i] for i in order]
    return (pick(fields), np.array(pick(x0)), np.array(pick(lb)),
            np.array(pick(ub)), np.array(pick(is_disc)), pick(types),
            pick(value_map))


def _padded_caps(parameters: Dict[str, Any], opts0: MPSOptions):
    """Upper bounds of the (chi_max, d) search space, for shape-polymorphic
    trials (MPSOptions.pad_to).  None when a bound cannot be derived
    (unbounded spec) or when neither shape parameter is tuned."""
    if not ("chi_max" in parameters or "d" in parameters):
        return None
    caps = {}
    for key in ("chi_max", "d"):
        if key in parameters:
            val = parameters[key]
            if isinstance(val, (list, np.ndarray)) and len(val):
                caps[key] = int(max(val))
            elif isinstance(val, tuple) and len(val) == 3:
                # (lb, step, ub): the value map is arange(lb, ub + step/2,
                # step), whose last value can EXCEED ub — cap on the actual
                # reachable maximum, not the nominal bound
                vm = np.arange(val[0], val[2] + val[1] / 2, val[1],
                               dtype=np.float64)
                caps[key] = int(round(vm.max())) if vm.size else int(val[2])
            elif isinstance(val, tuple) and len(val) == 2:
                # solver proposals are ROUNDED (_safe_paramlist), so a
                # non-integer ub can round up past int(ub) — cap on the
                # maximum reachable rounded value
                caps[key] = int(round(val[-1]))
            else:
                return None
        else:
            caps[key] = int(getattr(opts0, key))
    return caps["chi_max"], caps["d"]


def _safe_paramlist(optslist, fields, types, value_map, logspace_eta,
                    verbose=False):
    """Map raw optimiser values to legal hyperparameter values (reference
    safe_paramlist, tuning.jl:25-56): value-map lookup, integer rounding,
    logspace eta exponentiation."""
    out = {}
    for i, field in enumerate(fields):
        v = float(optslist[i])
        if value_map[i]:
            v = value_map[i][int(round(v)) - 1]
        t = types[i]
        if t is int:
            r = int(round(v))
            if verbose and not np.isclose(v, r):
                print(f"Integer parameter {field}={v} rounded to {r}!")
            out[field] = r
        elif logspace_eta and field == "eta" and not value_map[i]:
            out[field] = float(10.0 ** v)
        else:
            out[field] = float(v)
    return out


def tune(Xs: np.ndarray, ys: Optional[np.ndarray] = None, nfolds: int = 5,
         parameters: Optional[Dict[str, Any]] = None,
         method: Optional[MPSRandomSearch] = None, *,
         objective: TuningLoss = None,
         opts0: Optional[MPSOptions] = None,
         rng: Union[int, np.random.Generator] = 1,
         foldmethod: Union[Callable, list] = make_stratified_cvfolds,
         pms: Optional[Sequence[float]] = None,
         windows=None,
         verbosity: int = 1,
         logspace_eta: bool = False,
         maxiters: int = 250,
         max_cache_hits: int = 100,
         n_workers: int = 0,
         devices=None,
         impute_method: str = "median",
         padded_trials: bool = True,
         fold_batch: bool = False,
         pre_string: str = "", device="cuda") -> Tuple[Dict[str, Any], Dict]:
    """nfolds-fold hyperparameter tuning (reference tune, tuning.jl:354-512).

    ``device``: where the unfarmed route trains and evaluates, the card
    ("cuda", the default) or "cpu".

    ``devices``: farm CV folds across local devices — True/"all" for every
    local card, an explicit list of torch devices, which may repeat (the
    Distributed.jl ``distribute_folds`` analog, tuning.jl:112), or
    OS-process workers via ``"processes[:N]"`` (whose jobs run on
    ``device``) / a :class:`~mpstime_tpu_torch.parallel.ProcessFarm` (whose
    jobs run on its ``platform``).
    When the pool outnumbers the CV folds, the TRIAL axis farms instead —
    each distinct hyperparameter point runs its folds sequentially as one
    job (the reference's ``distribute_iters``, random_search.jl:114-116).

    ``padded_trials``: run every trial at the search space's
    (chi_max, d) upper bounds via zero-padding, with the trial's chi_max as
    a runtime truncation cap (MPSOptions.pad_to), as the JAX package does
    (there every trial then shares one compiled program); on the card the
    padded trials run the bond kernels K1 -> QR -> K2 with the cap.
    Ignored when the bounds cannot be derived.

    ``fold_batch``: train a trial's CV folds through
    :func:`~mpstime_tpu_torch.fit_mps_batch` (one ``fit_mps`` per fold at
    the trial's caps, with no per-sweep logging and no early exit).
    Without ``exit_early`` the losses equal the sequential route's; a
    numerical error anywhere in the batch retries the whole trial
    sequentially, with the per-fold svd retry.  Ignored where something
    else owns the fold axis: fold-farming device pools and ``n_workers``
    thread pools.  It DOES
    compose with trial farming (``devices="processes:N"`` with more
    workers than folds): each farmed trial then runs its folds as one
    call of fit_mps_batch inside its worker.

    Returns (best_params dict, cache dict mapping hyperparameter tuples to
    mean CV loss)."""
    if parameters is None:
        parameters = {}
    if ys is None:
        ys = np.zeros(Xs.shape[0], dtype=np.int64)
    Xs = np.asarray(Xs, dtype=np.float64)
    ys = np.asarray(ys)
    if objective is None:
        objective = ImputationLoss()
    if method is None:
        method = MPSRandomSearch()
    if opts0 is None:
        opts0 = MPSOptions(
            verbosity=-5, log_level=-1,
            sigmoid_transform=isinstance(objective, (MisclassificationRate,
                                                     BalancedMisclassificationRate)))
    if not parameters or nfolds == 0 or maxiters == 0:
        return {}, {}

    if isinstance(objective, ImputationLoss) and opts0.sigmoid_transform:
        warnings.warn(pre_string + "Using sigmoid_transform preprocessing on "
                      "an imputation-style problem generally leads to worse "
                      "performance.")
    g = rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)

    if isinstance(objective, ImputationLoss):
        windows = make_windows(windows, pms, Xs, g)

    fields, x0, lb, ub, is_disc, types, value_map = _parse_parameters(
        dict(parameters), opts0, logspace_eta)

    if nfolds <= 1:
        warnings.warn(pre_string + f"tune(nfolds={nfolds}) performs no "
                      "cross-validation: returning the starting parameters "
                      "unchanged with an empty cache. Use nfolds >= 2 to "
                      "actually search.")
        return _safe_paramlist(x0, fields, types, value_map, logspace_eta), {}

    folds = foldmethod(Xs, ys, nfolds, rng=g) if callable(foldmethod) \
        else foldmethod

    pad_caps = _padded_caps(dict(parameters), opts0) if padded_trials else None
    # every padded-trial fold trains at the LARGEST fold's (8-rounded)
    # sample count, with zero-weight copies, as in the JAX package (where
    # fold sizes that differ by +-1 then share one compiled program)
    pad_samples = None
    if pad_caps is not None:
        n_max = max(len(tr) for tr, _ in folds)
        pad_samples = n_max + (-n_max) % 8
    if pad_caps is not None:
        # sanity: every trial pays cap-sized compute, which for very wide
        # chi ranges costs more than fitting each trial at its own shape
        chi_spec = parameters.get("chi_max")
        if isinstance(chi_spec, tuple) and len(chi_spec) == 3:
            chi_lo = chi_spec[0]        # (lb, step, ub): step is NOT a value
        elif chi_spec is not None and hasattr(chi_spec, "__len__") \
                and len(chi_spec):
            chi_lo = min(chi_spec)
        else:
            chi_lo = pad_caps[0]
        if pad_caps[0] >= 8 * max(int(chi_lo), 1):
            warnings.warn(pre_string + f"padded_trials: chi cap "
                          f"{pad_caps[0]} is >=8x the smallest trial "
                          f"({chi_lo}); small trials pay cap-sized compute. "
                          "Pass padded_trials=False to fit each trial at "
                          "its own shape.")

    cache: Dict[tuple, float] = {}
    state = {"iters": 0, "hits": 0}
    tstart = time.time()

    def cvloss(fold_i: int, hparams: Dict[str, Any], opts: MPSOptions,
               dev) -> float:
        train_inds, val_inds = folds[fold_i]
        X_tr, y_tr = Xs[train_inds], ys[train_inds]
        X_val, y_val = Xs[val_inds], ys[val_inds]
        t0 = time.time()
        if verbosity >= 1:
            print(f"{pre_string}iter {state['iters']}, cvfold {fold_i}: "
                  f"training MPS with {hparams}...")
        try:
            mps, _, _ = fit_mps(X_tr, y_tr, opts=opts,
                                pad_samples_to=pad_samples, device=dev)
            loss = float(np.mean(eval_loss(objective, mps, X_val, y_val,
                                           windows, method=impute_method)))
        except NUMERICAL_ERRORS:
            # reference retries with a slower SVD algorithm then gives up
            # (tuning.jl:73-84)
            if opts.svd_alg == "svd":
                loss = float("inf")
            else:
                if verbosity >= 1:
                    print(f"{pre_string}iter {state['iters']}, cvfold {fold_i}: "
                          f"diverged, retrying with svd_alg='svd'")
                return cvloss(fold_i, hparams, opts.replace(svd_alg="svd"),
                              dev)
        if verbosity >= 1:
            print(f"{pre_string}iter {state['iters']}, cvfold {fold_i}: "
                  f"finished in {time.time() - t0:.2f}s (loss={loss:.6g})")
        return loss

    def sequential_folds_loss(hparams, opts, dev) -> float:
        return float(np.mean([cvloss(f, hparams, opts, dev)
                              for f in range(len(folds))]))

    def folds_loss(hparams, opts, dev) -> float:
        """Mean CV loss of one trial on ``dev``.  With ``fold_batch``, the
        folds train through fit_mps_batch; a numerical
        divergence anywhere in the batch falls back to the sequential
        route, which keeps the reference's per-fold svd retry semantics
        (tuning.jl:73-84)."""
        if not fold_batch or len(folds) == 1:
            return sequential_folds_loss(hparams, opts, dev)
        from ..training.fit import fit_mps_batch
        t0 = time.time()
        try:
            models = fit_mps_batch([(Xs[tr], ys[tr]) for tr, _ in folds],
                                   opts=opts, device=dev)
            losses = [float(np.mean(eval_loss(objective, m, Xs[val], ys[val],
                                              windows, method=impute_method)))
                      for m, (_, val) in zip(models, folds)]
        except NUMERICAL_ERRORS + (ValueError,):
            # ValueError: a fold's training split can miss a rare class
            # (fit_mps_batch requires a shared label set); the sequential
            # route trains that fold on its own labels and continues.
            if verbosity >= 1:
                print(f"{pre_string}iter {state['iters']}: batched folds "
                      "unavailable/diverged, retrying sequentially")
            return sequential_folds_loss(hparams, opts, dev)
        if not np.all(np.isfinite(losses)):
            # a divergence on the device raises nothing: a NaN trial loss would
            # poison the search; route through the sequential path, which
            # carries the reference's per-fold svd retry (tuning.jl:73-84)
            if verbosity >= 1:
                print(f"{pre_string}iter {state['iters']}: batched folds "
                      "produced non-finite losses, retrying sequentially")
            return sequential_folds_loss(hparams, opts, dev)
        if verbosity >= 1:
            print(f"{pre_string}iter {state['iters']}: {len(folds)} folds "
                  f"batched in {time.time() - t0:.2f}s")
        return float(np.mean(losses))

    from ..parallel.farm import (DeviceFarm, resolve_devices,
                                 resolve_process_farm)

    # process backend (the reference's actual Distributed.jl model): fold
    # jobs ship to spawned worker processes; with more workers than CV
    # folds the TRIAL axis farms instead (see farmed_trials_map below).
    # A farm built implicitly from a string spelling is OWNED here and
    # closed on exit (a caller-provided ProcessFarm instance is not).
    farm = resolve_process_farm(devices, device)
    proc_farm = farm is not None
    owned_farm = farm if (proc_farm and isinstance(devices, str)) else None
    if farm is None:
        farm_devs = resolve_devices(devices)
        farm = DeviceFarm(farm_devs) if farm_devs and len(farm_devs) > 1 \
            else None
        if farm_devs and len(farm_devs) == 1:
            device = farm_devs[0]           # one device: no farm, run there
    solver_route = not isinstance(method, MPSRandomSearch)
    # a solver that can evaluate its population concurrently (ScipySolver
    # differential_evolution) farms the TRIAL axis: each energy job runs
    # its folds sequentially on its device/process, the generation drains
    # across the pool (fold farming inside would nest two farms on it)
    solver_workers = (solver_route and farm is not None
                      and getattr(method, "supports_workers", False))
    # with more devices/workers than CV folds, farm the TRIAL axis instead
    # (the reference's distribute_iters pmap over hyperparameter trials,
    # random_search.jl:114-116): each trial runs its folds sequentially,
    # pinned to one device/process, and the whole grid drains across them
    farm_trials = solver_workers or (farm is not None and not solver_route
                                     and len(folds) < len(farm.devices))
    if farm is not None and n_workers > 0:
        axis = "trials farm one-per-device" if farm_trials \
            else "folds farm one-per-device"
        warnings.warn(pre_string + "devices=... and n_workers>0 are mutually "
                      f"exclusive; {axis} and n_workers is ignored.")
    executor = ThreadPoolExecutor(n_workers) \
        if n_workers > 0 and farm is None else None

    class _SearchExhausted(Exception):
        """Raised to stop the search early: after max_cache_hits consecutive
        cache hits, or (solver route) after maxiters distinct evaluations —
        the reference's stop callback, tuning.jl:126-138, 184-199."""

    # under trial farming, several workers can reach the same ROUNDED key
    # concurrently (value-map duplicates in the raw grid); an in-flight
    # registry makes later arrivals wait for the first computation instead
    # of redundantly training nfolds models per duplicate
    import threading
    _ilock = threading.Lock()
    _inflight: Dict[tuple, threading.Event] = {}

    def tr_objective(optslist, dev=device) -> float:
        hparams = _safe_paramlist(optslist, fields, types, value_map,
                                  logspace_eta, verbose=verbosity >= 3)
        key = tuple(hparams[f] for f in fields)
        while True:
            with _ilock:
                if key in cache:
                    state["hits"] += 1
                    hits = state["hits"]
                    if verbosity >= 1 and hits <= 3:
                        print(f"{pre_string}iter {state['iters']}: cache hit "
                              f"at {hparams}")
                    if hits > max_cache_hits:
                        raise _SearchExhausted("max_cache_hits")
                    return cache[key]
                if solver_route and state["iters"] >= maxiters:
                    # grid search enumerates exactly maxiters trials; a
                    # continuous solver needs the explicit evaluation cap
                    raise _SearchExhausted("maxiters")
                ev = _inflight.get(key)
                if ev is None:
                    _inflight[key] = threading.Event()
                    state["hits"] = 0
                    state["iters"] += 1
                    break
            ev.wait()
        try:
            opts = opts0.replace(**hparams)
            if pad_caps is not None:
                opts = opts.replace(pad_to=pad_caps)
            if farm is not None and not farm_trials:
                losses = farm.map(lambda f, fdev: cvloss(f, hparams, opts,
                                                         fdev),
                                  range(len(folds)))
                loss = float(np.mean(losses))
            elif executor is not None:
                losses = list(executor.map(
                    lambda f: cvloss(f, hparams, opts, dev),
                    range(len(folds))))
                loss = float(np.mean(losses))
            else:
                loss = folds_loss(hparams, opts, dev)
            with _ilock:
                cache[key] = loss
        finally:
            with _ilock:
                _inflight.pop(key).set()
        if verbosity >= 1:
            print(f"{pre_string}iter {state['iters']}, "
                  f"t={time.time() - tstart:.2f}s: Mean CV Loss: {loss:.6g}")
        return loss

    def trial_mean_loss(optslist, dev) -> float:
        """One whole trial as a self-contained job on ``dev`` (ships to a
        ProcessFarm worker via cloudpickle): round the raw point, train the
        CV folds via folds_loss (sequential, or one fit_mps_batch call per
        trial when ``fold_batch`` — the knob composes with trial farming),
        return the mean loss.  No shared state — the cache / stop
        bookkeeping happens in farmed_trials_map on the parent."""
        hparams = _safe_paramlist(optslist, fields, types, value_map,
                                  logspace_eta)
        opts = opts0.replace(**hparams)
        if pad_caps is not None:
            opts = opts.replace(pad_to=pad_caps)
        return folds_loss(hparams, opts, dev)

    def farmed_trials_map(xs) -> list:
        """Process-farmed twin of tr_objective for a BATCH of trial points
        (a grid, or one DE generation): memoization + stop bookkeeping stay
        in this process, each distinct un-cached point ships to a worker as
        one sequential-folds job.  The reference instead disables its memo
        cache when farming trials to workers (random_search.jl:114-116,
        tuning.jl:170); keeping it parent-side is strictly better — rounded
        duplicates are deduped before any job ships and later generations
        still hit earlier results."""
        xs = list(xs)
        keys = []
        for x in xs:
            hp = _safe_paramlist(x, fields, types, value_map, logspace_eta,
                                 verbose=verbosity >= 3)
            keys.append(tuple(hp[f] for f in fields))
        stop = None
        fresh: Dict[tuple, Any] = {}       # key -> representative raw point
        for i, key in enumerate(keys):
            if key in cache or key in fresh:
                state["hits"] += 1
                if state["hits"] > max_cache_hits:
                    stop = _SearchExhausted("max_cache_hits")
                    break
                continue
            if solver_route and state["iters"] >= maxiters:
                stop = _SearchExhausted("maxiters")
                break
            state["hits"] = 0
            state["iters"] += 1
            fresh[key] = xs[i]
        if fresh:
            t0 = time.time()
            losses = farm.map(trial_mean_loss, list(fresh.values()))
            cache.update(zip(fresh, losses))
            if verbosity >= 1:
                print(f"{pre_string}farmed {len(fresh)} trial(s) over "
                      f"{farm.n_workers} workers in {time.time() - t0:.2f}s "
                      f"(t={time.time() - tstart:.2f}s, "
                      f"iters={state['iters']})")
        if stop is not None:
            raise stop   # computed results are already in the cache
        return [cache[k] for k in keys]

    class _FarmedTrialExecutor:
        """Adapter giving grid_search's ``executor.map`` contract over
        farmed_trials_map (the objective argument is tr_objective's
        machinery, already folded into the batch map — ignored)."""

        def map(self, _objective, trials):
            return farmed_trials_map(trials)

    def best_from_cache():
        # ties broken by the key itself (not dict insertion order) so a
        # farmed search — whose completion order is nondeterministic —
        # returns exactly the sequential result
        best_key = min(cache, key=lambda k: ((cache[k], k)
                       if not np.isnan(cache[k]) else (np.inf, k)))
        return dict(zip(fields, best_key))

    try:
        if solver_route:
            # continuous / black-box solver route (reference
            # tune_across_folds -> Optimization.jl solve, tuning.jl:184-199);
            # the best point is read from the evaluation cache because the
            # solver's raw x may round to a different hyperparameter tuple
            # than the best one it actually evaluated
            solve_kw = {}
            if solver_workers:
                # DeviceFarm threads share the in-process objective (cache
                # and all); ProcessFarm generations go through the batch
                # twin, which keeps the cache parent-side and ships pure
                # sequential-folds jobs
                solve_kw["workers"] = (lambda f, xs: farmed_trials_map(xs)) \
                    if proc_farm else (lambda f, xs: farm.map(tr_objective,
                                                              xs))
            method.solve(tr_objective, x0, lb, ub, rng=g, maxiters=maxiters,
                         **solve_kw)
            best = best_from_cache() if cache else \
                _safe_paramlist(x0, fields, types, value_map, logspace_eta)
        else:
            executor_for_grid = None
            if farm_trials:
                executor_for_grid = _FarmedTrialExecutor() if proc_farm \
                    else farm
            sol = grid_search(g, tr_objective, method, lb, ub, is_disc,
                              fields, maxiters, executor=executor_for_grid)
            best = _safe_paramlist(sol, fields, types, value_map,
                                   logspace_eta)
    except _SearchExhausted as e:
        if verbosity >= 1:
            if str(e) == "maxiters":
                print(f"{pre_string}Reached maxiters={maxiters} distinct "
                      "evaluations, stopping.")
            else:
                print(f"{pre_string}Exceeded max_cache_hits={max_cache_hits} "
                      "consecutive cache hits, stopping early. Is your "
                      "search space too small?")
        best = best_from_cache()
    finally:
        if executor is not None:
            executor.shutdown(wait=False)
        if owned_farm is not None:
            owned_farm.close()
    return best, cache

"""Search-grid generation and grid search
(reference src/Training/hyperparameters/random_search.jl; a NumPy copy of
``mpstime_tpu/hyperopt/random_search.py``, which the port does not import)."""

from __future__ import annotations

import itertools
import warnings
from typing import Callable, List, Optional, Sequence

import numpy as np


class MPSRandomSearch:
    """Random-search tuning algorithm spec (reference MPSRandomSearch,
    hyperopt_utils.jl:21-31).  ``sampling`` in {'LatinHypercube',
    'UniformRandom', 'Exhaustive'}."""

    def __init__(self, sampling: str = "LatinHypercube"):
        s = sampling.lstrip(":")
        if s not in ("LatinHypercube", "UniformRandom", "Exhaustive"):
            raise ValueError("Unknown sampling type, expected LatinHypercube, "
                             "UniformRandom, or Exhaustive")
        self.sampling = s

    def __repr__(self):
        return f"MPSRandomSearch({self.sampling})"


def make_grid(rng: np.random.Generator, grid_type: str,
              lb: np.ndarray, ub: np.ndarray, is_disc: np.ndarray,
              maxiters: int, maxrerolls: int = 100) -> List[np.ndarray]:
    """Generate hyperparameter trial points (reference make_grid,
    random_search.jl:1-70)."""
    lb = np.asarray(lb, dtype=np.float64)
    ub = np.asarray(ub, dtype=np.float64)
    is_disc = np.asarray(is_disc, dtype=bool)
    P = len(lb)

    if grid_type == "UniformRandom":
        samps: List[np.ndarray] = []
        for i in range(maxiters):
            for _ in range(maxrerolls):
                s = np.empty(P)
                for j in range(P):
                    if is_disc[j]:
                        s[j] = rng.integers(int(lb[j]), int(ub[j]) + 1)
                    else:
                        s[j] = (ub[j] - lb[j]) * rng.random() + lb[j]
                if not any(np.array_equal(s, prev) for prev in samps):
                    samps.append(s)
                    break
            else:
                warnings.warn(f"Skipped sample {i+1}/{maxiters}: not unique "
                              f"after {maxrerolls} attempts")
        return samps

    if grid_type == "LatinHypercube":
        # one value per stratum per dimension, independently shuffled
        # (pseudo-LHC matching LatinHypercubeSampling.randomLHC semantics:
        # categorical dims get balanced level assignment)
        cols = []
        for j in range(P):
            if is_disc[j]:
                levels = np.arange(int(lb[j]), int(ub[j]) + 1)
                reps = np.resize(levels, maxiters).astype(np.float64)
                cols.append(rng.permutation(reps))
            else:
                strata = (np.arange(maxiters) + rng.random(maxiters)) / maxiters
                vals = lb[j] + strata * (ub[j] - lb[j])
                cols.append(rng.permutation(vals))
        return [np.array(row) for row in np.stack(cols, axis=1)]

    if grid_type == "Exhaustive":
        if not is_disc.all():
            raise ValueError("All hyperparameters must be discrete if using "
                             "the Exhaustive search method")
        ranges = [np.arange(int(l), int(u) + 1) for l, u in zip(lb, ub)]
        return [np.array(p, dtype=np.float64)
                for p in itertools.product(*ranges)]

    raise ValueError("Unknown sampling type, expected LatinHypercube, "
                     "UniformRandom, or Exhaustive")


def sort_big_trials_first(trials: List[np.ndarray],
                          fields: Sequence[str]) -> List[np.ndarray]:
    """Schedule slow (large chi_max * d) trials first (reference
    make_shorter_benchmark, random_search.jl:72-87)."""
    idx = [i for i, f in enumerate(fields) if f in ("chi_max", "d")]
    if not idx:
        return list(trials)
    return sorted(trials, key=lambda t: -np.prod([t[i] for i in idx]))


def grid_search(rng: np.random.Generator, objective: Callable,
                method: MPSRandomSearch, lb, ub, is_disc,
                fields: Sequence[str], maxiters: int,
                executor=None) -> np.ndarray:
    """Evaluate a trial grid and return the argmin trial (reference
    grid_search, random_search.jl:89-128).  ``executor`` optionally maps the
    objective over trials concurrently (e.g. ThreadPoolExecutor.map)."""
    trials = make_grid(rng, method.sampling, lb, ub, is_disc, maxiters)
    trials = sort_big_trials_first(trials, fields)
    if not trials:
        raise RuntimeError("no trials generated")
    if executor is not None:
        losses = list(executor.map(objective, trials))
    else:
        losses = [objective(t) for t in trials]
    # a diverged trial can score NaN (np.argmin would select it); NaN -> inf
    losses = np.where(np.isnan(np.asarray(losses, dtype=np.float64)),
                      np.inf, np.asarray(losses, dtype=np.float64))
    return trials[int(np.argmin(losses))]

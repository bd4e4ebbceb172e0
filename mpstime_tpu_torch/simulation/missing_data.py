"""Missing-data simulators under the Rubin taxonomy (a copy of
``mpstime_tpu/simulation/missing_data.py``; reference
src/Simulation/missing_data_mechanisms.jl).

Host-side numpy: these generate corruption patterns, not device compute, and
the same ``rng`` gives the same arrays as the JAX package's.  Returned
indices are 0-based.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

RngLike = Union[None, int, np.random.Generator]


def _rng(rng: RngLike) -> np.random.Generator:
    if isinstance(rng, np.random.Generator):
        return rng
    return np.random.default_rng(rng)


def percentage_missing_values(X: np.ndarray) -> float:
    X = np.asarray(X)
    return 100.0 * np.count_nonzero(np.isnan(X)) / X.size


def _remove(X: np.ndarray, idxs: np.ndarray) -> np.ndarray:
    Xc = np.asarray(X, dtype=np.float64).copy()
    Xc[idxs] = np.nan
    return Xc


def _check_fraction(f: float) -> None:
    if not (0.0 <= f <= 1.0):
        raise ValueError("fraction_missing must be between 0 and 1")


def mcar(X: np.ndarray, fraction_missing: float = 0.5, *,
         rng: RngLike = None, verbose: bool = False
         ) -> Tuple[np.ndarray, np.ndarray]:
    """Missing Completely At Random: Bernoulli(fraction) mask per point
    (reference mcar, missing_data_mechanisms.jl:56-85)."""
    _check_fraction(fraction_missing)
    X = np.asarray(X)
    g = _rng(rng)
    mask = g.random(len(X)) < fraction_missing
    missing_idxs = np.flatnonzero(mask)
    Xc = _remove(X, missing_idxs)
    if verbose:
        print(f"Expected missing: {100 * fraction_missing}%. Actual missing: "
              f"{percentage_missing_values(Xc):.2f}%")
    return Xc, missing_idxs


def mar(X: np.ndarray, fraction_missing: float = 0.5, *,
        rng: RngLike = None, verbose: bool = False
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Missing At Random: one contiguous block with uniformly random start
    (reference mar / BlockMissingMAR, missing_data_mechanisms.jl:114-153)."""
    _check_fraction(fraction_missing)
    X = np.asarray(X)
    n = len(X)
    g = _rng(rng)
    npts = int(round(n * fraction_missing))
    start = int(g.integers(0, n - npts + 1))
    missing_idxs = np.arange(start, start + npts)
    Xc = _remove(X, missing_idxs)
    if verbose:
        print(f"Expected missing: {100 * fraction_missing}%. Actual missing: "
              f"{percentage_missing_values(Xc):.2f}%")
    return Xc, missing_idxs


def mnar(X: np.ndarray, fraction_missing: float = 0.5,
         mechanism: str = "lowest", *, verbose: bool = False
         ) -> Tuple[np.ndarray, np.ndarray]:
    """Missing Not At Random: remove the lowest (or highest) values
    (reference mnar, missing_data_mechanisms.jl:182-215)."""
    _check_fraction(fraction_missing)
    X = np.asarray(X)
    npts = int(round(len(X) * fraction_missing))
    order = np.argsort(X, kind="stable")
    if mechanism == "highest":
        order = order[::-1]
    elif mechanism != "lowest":
        raise ValueError("mechanism must be 'lowest' or 'highest'")
    missing_idxs = np.sort(order[:npts])
    Xc = _remove(X, missing_idxs)
    if verbose:
        print(f"Expected missing: {100 * fraction_missing}%. Actual missing: "
              f"{percentage_missing_values(Xc):.2f}%")
    return Xc, missing_idxs

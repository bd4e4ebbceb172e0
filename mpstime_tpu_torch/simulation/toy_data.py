"""Synthetic time-series generators (a copy of
``mpstime_tpu/simulation/toy_data.py``; reference
src/Simulation/toy_data.jl).  Host numpy: the same ``rng`` gives the same
arrays as the JAX package's."""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np

from .missing_data import RngLike, _rng

ParamSpec = Union[None, float, int, Tuple[float, float], list, np.ndarray]


def _generate_param(spec: ParamSpec, default_range: Tuple[float, float],
                    g: np.random.Generator) -> float:
    """Fixed / uniform-range / discrete-choice parameter sampling
    (reference _generate_params, toy_data.jl:2-12)."""
    if spec is None:
        return float(g.uniform(*default_range))
    if isinstance(spec, tuple):
        return float(g.uniform(*spec))
    if isinstance(spec, (list, np.ndarray)):
        return float(g.choice(np.asarray(spec, dtype=np.float64)))
    return float(spec)


def trendy_sine(T: int, n: int, *, period: ParamSpec = None,
                slope: ParamSpec = None, phase: ParamSpec = None,
                sigma: float = 0.0, return_metadata: bool = True,
                rng: RngLike = None
                ) -> Tuple[np.ndarray, Optional[Dict]]:
    """x_t = sin(2 pi t / tau + psi) + m t / T + sigma n_t
    (reference trendy_sine, toy_data.jl:53-85).  Returns ([n, T], info)."""
    g = _rng(rng)
    DEFAULTS = {"period": (1.0, 50.0), "slope": (-5.0, 5.0),
                "phase": (0.0, 2 * np.pi)}
    periods = np.array([_generate_param(period, DEFAULTS["period"], g)
                        for _ in range(n)])
    slopes = np.array([_generate_param(slope, DEFAULTS["slope"], g)
                       for _ in range(n)])
    phases = np.array([_generate_param(phase, DEFAULTS["phase"], g)
                       for _ in range(n)])

    ts = np.arange(1, T + 1, dtype=np.float64)
    X = (np.sin(2 * np.pi / periods[:, None] * ts[None, :] + phases[:, None])
         + slopes[:, None] * ts[None, :] / T
         + sigma * g.standard_normal((n, T)))

    info = None
    if return_metadata:
        info = {"period": periods, "slope": slopes, "phase": phases,
                "sigma": sigma, "T": T, "n": n}
    return X, info


def _single_state_space(T: int, s: int, sigma: float,
                        g: np.random.Generator) -> np.ndarray:
    """(reference _single_state_space, toy_data.jl:87-107)"""
    Tb = T + s  # burn-in
    xs = np.zeros(Tb)
    thetas = np.zeros(Tb)
    lambdas = np.zeros(Tb)
    mus = np.zeros(Tb)
    for i in range(s - 1, Tb):
        theta = -np.sum(thetas[i - s + 1:i][::-1]) if s > 1 else 0.0
        theta += sigma * g.standard_normal()
        lam = lambdas[i - 1] + sigma * g.standard_normal()
        mu = mus[i - 1] + lambdas[i - 1] + sigma * g.standard_normal()
        x = mu + theta + sigma * g.standard_normal()
        xs[i], mus[i], lambdas[i], thetas[i] = x, mu, lam, theta
    return xs[s:]


def state_space(T: int, n: int, *, s: int = 2, sigma: float = 0.3,
                rng: RngLike = None) -> np.ndarray:
    """Local-linear-trend + seasonal state-space model
    (reference state_space, toy_data.jl:109-143).  Returns [n, T]."""
    if s < 2:
        raise ValueError("Lag order s must be >= 2.")
    g = _rng(rng)
    return np.stack([_single_state_space(T, s, sigma, g) for _ in range(n)])

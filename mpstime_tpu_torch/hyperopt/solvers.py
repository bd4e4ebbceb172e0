"""Continuous / black-box solver route for ``tune`` (a NumPy/SciPy copy of
``mpstime_tpu/hyperopt/solvers.py``, which the port does not import).

The reference routes any non-``MPSRandomSearch`` tuning method through
Optimization.jl's ``solve`` with box constraints, integer constraints
handled by rounding inside the objective, and the maxiters / cache-hit stop
callback (src/Training/hyperparameters/tuning.jl:143-207, callback
:184-199).  The analog here is :class:`ScipySolver`: a scipy.optimize
backend sharing ``tune``'s objective machinery (memoization cache, integer
rounding via ``_safe_paramlist``, logspace eta, SVD-divergence retry).

Integer hyperparameters are still rounded inside the objective, so the
landscape is piecewise constant along those axes — derivative-free methods
("Nelder-Mead", "Powell", "differential_evolution") are the useful choices,
exactly as the reference pairs this route with NelderMead/blackbox solvers.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

_MINIMIZE_METHODS = ("Nelder-Mead", "Powell", "L-BFGS-B", "COBYLA", "SLSQP",
                     "TNC")


class ScipySolver:
    """Box-constrained solver spec for :func:`mpstime_tpu_torch.tune`
    (the reference's Optimization.jl solver route, tuning.jl:143-207).

    ``method``: a scipy.optimize.minimize method name (derivative-free
    recommended: "Nelder-Mead", "Powell") or "differential_evolution".
    Extra keyword ``options`` are forwarded to scipy.
    """

    def __init__(self, method: str = "Nelder-Mead", **options):
        if method not in _MINIMIZE_METHODS + ("differential_evolution",):
            raise ValueError(
                f"Unknown ScipySolver method {method!r}; options: "
                f"{_MINIMIZE_METHODS + ('differential_evolution',)}")
        self.method = method
        self.options = options

    def __repr__(self):
        return f"ScipySolver({self.method})"

    @property
    def supports_workers(self) -> bool:
        """Whether :meth:`solve` can farm objective evaluations — true for
        differential_evolution, whose population energies are independent."""
        return self.method == "differential_evolution"

    def solve(self, objective: Callable[[np.ndarray], float],
              x0: np.ndarray, lb: np.ndarray, ub: np.ndarray, *,
              rng: Optional[np.random.Generator] = None,
              maxiters: int = 250,
              workers: Optional[Callable] = None) -> np.ndarray:
        """Minimise ``objective`` over the box [lb, ub] starting from x0.

        ``maxiters`` bounds the number of objective evaluations (the
        reference's callback counts evaluations the same way); the stop
        exceptions ``tune`` raises from inside the objective (max cache
        hits / maxiters) propagate out of scipy and are handled by
        ``tune`` itself.  Returns the best raw parameter vector.

        ``workers``: a map-like ``(fn, iterable) -> list`` used by the
        differential_evolution route to evaluate each generation's
        population concurrently (``tune(devices=...)`` passes the
        DeviceFarm's map).  DE always runs with ``updating="deferred"`` so
        farmed and sequential searches follow the identical trajectory at
        a fixed seed; other methods are inherently sequential and ignore
        ``workers``."""
        import scipy.optimize as so

        lb = np.asarray(lb, dtype=np.float64)
        ub = np.asarray(ub, dtype=np.float64)
        x0 = np.clip(np.asarray(x0, dtype=np.float64), lb, ub)
        bounds = list(zip(lb, ub))

        if self.method == "differential_evolution":
            seed = (int(rng.integers(2 ** 31 - 1))
                    if isinstance(rng, np.random.Generator) else rng)
            opts = dict(self.options)
            ndim = len(lb)
            # deferred updating (fixed below for farmed==sequential
            # reproducibility) trades per-generation progress for
            # parallelism; smaller populations over more generations
            # converge measurably better at equal budgets
            popsize = opts.pop("popsize", max(4, min(8, maxiters // ndim)))
            # scipy evaluates ~popsize*ndim energies per generation plus the
            # initial population; size the generation count to the budget
            per_gen = max(popsize * ndim, 1)
            if workers is not None:
                opts.setdefault("workers", lambda f, xs: workers(f, list(xs)))
            res = so.differential_evolution(
                objective, bounds=bounds, x0=x0, seed=seed,
                maxiter=max(1, maxiters // per_gen - 1),
                popsize=popsize, polish=False, tol=0.0,
                updating="deferred",
                init=opts.pop("init", "latinhypercube"), **opts)
            return np.asarray(res.x)

        options = dict(self.options)
        options.setdefault("maxiter", maxiters)
        if self.method in ("Nelder-Mead", "Powell"):
            options.setdefault("maxfev", maxiters)
        elif self.method in ("L-BFGS-B", "TNC"):
            options.setdefault("maxfun", maxiters)
        res = so.minimize(objective, x0, method=self.method, bounds=bounds,
                          options=options)
        return np.asarray(res.x)

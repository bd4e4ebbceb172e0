"""Data-driven encoding initialisers (counterpart of
``mpstime_tpu/encodings/data_driven.py``): KDE wavefunctions,
Sahand-Legendre orthogonal-polynomial families, and projected
Fourier/Legendre bases (reference src/Encodings/bases.jl:134-397).

The initialisers run once on the (scaled) training data on the host (numpy,
float64), line for line the JAX package's, so both packages hold the same
``enc_args``; the KDE evaluations that the encodings call (``kde_pdf``,
``kde_pdf_masked``) run on torch tensors on the data's device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import bases


# ---------------------------------------------------------------------------
# Gaussian KDE (replaces KernelDensity.jl)


def silverman_bandwidth(xs: np.ndarray) -> float:
    """KernelDensity.jl's default bandwidth: 0.9 min(sigma, IQR/1.34) n^-0.2."""
    xs = np.asarray(xs, dtype=np.float64)
    n = len(xs)
    sigma = xs.std(ddof=1) if n > 1 else 1.0
    iqr = np.subtract(*np.percentile(xs, [75, 25]))
    w = min(sigma, iqr / 1.34) if iqr > 0 else sigma
    if w <= 0:
        w = 1.0
    return 0.9 * w * n ** (-0.2)


def kde_pdf_np(x: np.ndarray, samples: np.ndarray, bw: float) -> np.ndarray:
    """Gaussian-kernel density estimate evaluated at x (host)."""
    x = np.asarray(x, dtype=np.float64)
    z = (x[..., None] - samples[None, :]) / bw
    return np.exp(-0.5 * z ** 2).sum(axis=-1) / (len(samples) * bw *
                                                 math.sqrt(2 * math.pi))


def kde_pdf(x: torch.Tensor, samples, bw: float) -> torch.Tensor:
    """Gaussian-kernel density estimate at x (torch, x's device)."""
    samples = bases.const(samples, x)
    z = (x[..., None] - samples) / bw
    return torch.exp(-0.5 * z ** 2).sum(dim=-1) / (samples.shape[-1] * bw *
                                                   math.sqrt(2 * math.pi))


def kde_pdf_masked(x: torch.Tensor, samples, bw) -> torch.Tensor:
    """Per-timepoint KDE: samples [T, M] (nan-padded), bw [T]; x [N, T]."""
    samples, bw = bases.const(samples, x), bases.const(bw, x)
    valid = torch.isfinite(samples)
    counts = valid.sum(dim=-1)
    samp = torch.where(valid, samples, torch.zeros_like(samples))
    z = (x[..., :, None] - samp) / bw[:, None]
    k = torch.where(valid, torch.exp(-0.5 * z ** 2),
                    torch.zeros_like(z)).sum(dim=-1)
    return k / (torch.clamp(counts, min=1) * bw * math.sqrt(2 * math.pi))


# ---------------------------------------------------------------------------
# trapezoid helpers


def _trapz(y: np.ndarray, x: np.ndarray) -> float:
    return float(np.trapezoid(y, x))


def construct_kerneldensity_wavefunction(xs: np.ndarray, x_range,
                                         max_samples: Optional[int] = None,
                                         bandwidth: Optional[float] = None):
    """sqrt of the KDE pdf on an oversampled grid (reference bases.jl:141-154)."""
    xs = np.asarray(xs, dtype=np.float64)
    if max_samples is None:
        max_samples = max(200, 2 * len(xs))
    bw = bandwidth if bandwidth is not None else silverman_bandwidth(xs)
    xs_samps = np.linspace(x_range[0], x_range[1], max_samples)
    wf = np.sqrt(kde_pdf_np(xs_samps, xs, bw))
    return xs_samps, wf


def remove_zeros(xs_samps: np.ndarray, f0: np.ndarray):
    """Floor near-zero density regions and renormalise (reference
    remove_zeros!, bases.jl:269-291).  Mutates f0; returns (minval, norm)."""
    tol = np.abs(f0).max() * 1e-2
    bad = np.abs(f0) <= tol
    non_bad = f0[~bad]
    if non_bad.size == 0:
        return 0.0, 1.0
    minval = np.abs(non_bad).min()
    f0[bad] = minval
    norm = _trapz(np.abs(f0) ** 2, xs_samps)
    f0 /= norm
    return float(minval), float(norm)


def sahand_legendre_coeffs(xs_samp: np.ndarray, f0: np.ndarray,
                           d: int) -> np.ndarray:
    """Gram-matrix orthogonalization producing polynomial coefficients c[n, i]
    (powers i of x) for the d basis functions f_n(x) = (sum_i c_{n,i} x^i) f0(x)
    (reference sahand_legendre_coeffs, bases.jl:158-206)."""
    N = d - 1
    c = np.zeros((N + 1, N + 1))
    c[0, 0] = 1.0

    M = np.empty((N + 1, N + 1))
    for i in range(N + 1):
        for j in range(N + 1):
            M[i, j] = _trapz(xs_samp ** (i + j) * f0 ** 2, xs_samp)

    for n in range(1, N + 1):
        if n == 1:
            c[1, 0] = 1.0
            c[1, 1] = -1.0 / M[1, 0]
            nrm = c[1, :2] @ M[:2, :2] @ c[1, :2]
            c[1] /= math.sqrt(nrm)
        else:
            delta = np.zeros(n)
            cvec_tmp = c[:n, :n] @ M[0, :n]
            A = c[:n, :n] @ M[1:n + 1, :n].T
            sol = np.linalg.solve(A, delta - cvec_tmp)
            c[n, 0] = 1.0
            c[n, 1:n + 1] = sol
            nrm = c[n, :n + 1] @ M[:n + 1, :n + 1] @ c[n, :n + 1]
            c[n] /= math.sqrt(nrm)
    return c


# ---------------------------------------------------------------------------
# Sahand-Legendre initialisers


def init_sahand_legendre(X_scaled: np.ndarray, y: np.ndarray, d: int, opts,
                         max_samples: Optional[int] = None,
                         bandwidth: Optional[float] = None,
                         rng=(-1.0, 1.0)) -> dict:
    """Time-independent SL init (reference init_sahand_legendre,
    bases.jl:294-307).  Divergence: the reference samples its grid on
    range(-a, b) which collapses to a constant for the (-1,1) domain (a typo
    bug); we sample range(a, b) as documented."""
    a, b = rng
    xs = np.asarray(X_scaled, dtype=np.float64).ravel()
    xs = xs[(a <= xs) & (xs <= b)]
    if max_samples is None:
        max_samples = max(200, X_scaled.shape[1] if X_scaled.ndim == 2 else 200)
    bw = bandwidth if bandwidth is not None else silverman_bandwidth(xs)
    xs_samps = np.linspace(a, b, max_samples)
    f0 = np.sqrt(np.maximum(kde_pdf_np(xs_samps, xs, bw), 0.0))
    minx, scale = remove_zeros(xs_samps, f0)
    cvecs = sahand_legendre_coeffs(xs_samps, f0, d)
    return {"kde_samples": xs, "kde_bw": bw, "minx": minx, "scale": scale,
            "cvecs": cvecs}


def init_sahand_legendre_time_dependent(X_scaled: np.ndarray, y: np.ndarray,
                                        d: int, opts,
                                        max_samples: Optional[int] = None,
                                        bandwidth: Optional[float] = None,
                                        rng=(-1.0, 1.0)) -> dict:
    """Per-timepoint SL init (reference init_sahand_legendre_time_dependent,
    bases.jl:310-342).  X_scaled: [N, T] (series as rows; the per-timepoint
    samples are the columns)."""
    a, b = rng
    X = np.asarray(X_scaled, dtype=np.float64)
    N, T = X.shape
    if max_samples is None:
        max_samples = max(200, N)
    xs_samps = np.linspace(a, b, max_samples)

    M = N
    samples = np.full((T, M), np.nan)
    bws = np.ones(T)
    minxs = np.zeros(T)
    scales = np.ones(T)
    cvecs = np.zeros((T, d, d))
    for t in range(T):
        xs = X[:, t]
        xs = xs[(a <= xs) & (xs <= b)]
        if xs.size == 0:
            continue
        samples[t, :len(xs)] = xs
        bw = bandwidth if bandwidth is not None else silverman_bandwidth(xs)
        bws[t] = bw
        f0 = np.sqrt(np.maximum(kde_pdf_np(xs_samps, xs, bw), 0.0))
        minxs[t], scales[t] = remove_zeros(xs_samps, f0)
        if minxs[t] == 0.0:
            continue
        cvecs[t] = sahand_legendre_coeffs(xs_samps, f0, d)
    return {"kde_samples": samples, "kde_bw": bws, "minx": minxs,
            "scale": scales, "cvecs": cvecs}


# ---------------------------------------------------------------------------
# projected bases (reference series_expand + project_*, bases.jl:346-397)


def _series_select(basis_vals: np.ndarray, xs: np.ndarray, wf: np.ndarray,
                   d: int) -> np.ndarray:
    """Indices of the d largest |<wf, b_k>|^2 by trapezoid inner product
    (reference series_expand, bases.jl:346-357)."""
    coeffs = np.trapezoid(wf[None, :] * np.conj(basis_vals), xs, axis=1)
    order = np.argsort(-np.abs(coeffs) ** 2, kind="stable")
    return np.sort(order[:d])


def init_project_fourier(X_scaled: np.ndarray, y: np.ndarray, d: int, opts,
                         max_series_terms: Optional[int] = None,
                         max_samples: Optional[int] = None,
                         bandwidth: Optional[float] = None,
                         rng=(-1.0, 1.0)) -> dict:
    """Per-timepoint Fourier frequency selection (reference project_fourier,
    bases.jl:360-376).  Divergence: the reference encodes with the *selection
    indices* as frequencies (bases.jl:44-48); we map indices back to the
    actual frequency list, implementing the documented intent."""
    if max_series_terms is None:
        max_series_terms = 10 * d
    a, b = rng
    X = np.asarray(X_scaled, dtype=np.float64)
    T = X.shape[1]
    freqs = bases.get_fourier_freqs(max_series_terms)
    select = np.zeros((T, d))
    for t in range(T):
        xs = X[:, t]
        xs = xs[(a <= xs) & (xs <= b)]
        xs_samps, wf = construct_kerneldensity_wavefunction(
            xs, (-1.0, 1.0), max_samples=max_samples, bandwidth=bandwidth)
        basis_vals = np.exp(1j * np.pi * freqs[:, None] * xs_samps[None, :])
        idx = _series_select(basis_vals, xs_samps, wf, d)
        select[t] = freqs[idx]
    return {"freq_select": select, "max_series_terms": float(max_series_terms)}


def init_project_legendre(X_scaled: np.ndarray, y: np.ndarray, d: int, opts,
                          max_series_terms: Optional[int] = None,
                          max_samples: Optional[int] = None,
                          bandwidth: Optional[float] = None,
                          rng=(-1.0, 1.0)) -> dict:
    """Per-timepoint Legendre order selection (reference project_legendre,
    bases.jl:379-397); orders are 0-based (the reference reuses 1-based
    selection indices as orders, an off-by-one we do not replicate)."""
    if max_series_terms is None:
        max_series_terms = 7 * d
    a, b = rng
    X = np.asarray(X_scaled, dtype=np.float64)
    T = X.shape[1]
    select = np.zeros((T, d), dtype=np.int64)
    for t in range(T):
        xs = X[:, t]
        xs = xs[(a <= xs) & (xs <= b)]
        xs_samps, wf = construct_kerneldensity_wavefunction(
            xs, (-1.0, 1.0), max_samples=max_samples, bandwidth=bandwidth)
        basis_vals = bases.legendre_stack(
            torch.from_numpy(xs_samps), max_series_terms - 1).numpy().T
        idx = _series_select(basis_vals, xs_samps, wf, d)
        select[t] = idx                       # orders are the 0-based indices
    return {"order_select": select}

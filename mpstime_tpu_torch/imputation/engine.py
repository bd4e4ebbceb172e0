"""Conditional-imputation engine (counterpart of
``mpstime_tpu/imputation/engine.py``; reference src/Imputation/MPS_methods.jl
+ sampling_utils.jl): masked scans with trace-metric environments, in plain
PyTorch on the trained model's device.

The math is the JAX package's:

 * Backward pass: PSD *trace-metric* environments R[t] [chi, chi]
     R[T]   = e0 e0^H
     known:   R[t] = w_t R[t+1] w_t^H,  w_t = sum_i conj(phi_t)_i W[t][:,i,:]
     missing: R[t] = sum_i W[t][:,i,:] R[t+1] W[t][:,i,:]^H
 * Forward pass: carry v [chi] (the conditioned left environment).  At a known
   site, contract the known state.  At a missing site,
     A[i,b] = sum_a v[a] W[t][a,i,b]
     rdm[i,j] = sum_{b,c} A[i,b] R[t+1][b,c] conj(A[j,c])
     p(x) = conj(phi(x))^T rdm phi(x)   on the whole guess grid at once,
   then the estimator (median/mean/mode/ITS, sampling_utils.jl:64-316) picks
   x*, the chosen state is projected into v, and the scan continues.

The known-site mask lives on the host and is shared by the whole batch, so
the JAX scan's ``lax.cond`` is a Python branch per site here: known sites
skip the guess-grid work.  B instances (or ITS trajectories) ride a leading
tensor axis.  Nothing in the site loop reads a device value back to the
host; the caller synchronises once, when it copies the result.
Environments are renormalized per step (scale-invariant: every estimator
normalizes by the grid partition function Z).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class ImputeResult(NamedTuple):
    x_samps: torch.Tensor            # [B, T] imputed + known values (scaled)
    errs: torch.Tensor               # [B, T] error bars (0 at known sites)
    cdfs: Optional[torch.Tensor]     # [B, T, G] conditional cdfs (rows at
                                     # known sites are 0), or None


def _cumtrapz(probs: torch.Tensor, dx: float) -> torch.Tensor:
    """Cumulative trapezoid with even spacing over the last axis
    (NumericalIntegration TrapezoidalEvenFast, sampling_utils.jl:181)."""
    c = torch.cumsum(probs, dim=-1)
    return dx * (c - 0.5 * probs - 0.5 * probs[..., :1])


def _weighted_median_abs_dev(grid_x: torch.Tensor, probs: torch.Tensor,
                             x0: torch.Tensor) -> torch.Tensor:
    """median(|x - x0|, weights=probs) per row (sampling_utils.jl:195):
    grid_x [G], probs [B, G], x0 [B] -> [B].  A stable sort and a left
    search, as jnp.argsort and jnp.searchsorted."""
    dev = torch.abs(grid_x - x0[:, None])
    order = torch.argsort(dev, dim=-1, stable=True)
    cw = torch.cumsum(torch.gather(probs, -1, order), dim=-1)
    half = 0.5 * cw[:, -1:]
    k = torch.searchsorted(cw, half, right=False).clamp(max=dev.shape[-1] - 1)
    return torch.gather(torch.gather(dev, -1, order), -1, k)[:, 0]


def _estimate(method: str, rdm: torch.Tensor, S: torch.Tensor,
              grid_x: torch.Tensor, dx: float, x_prev: torch.Tensor,
              u: Optional[torch.Tensor], *, get_err: bool,
              max_jump: Optional[float],
              rejection_threshold: Optional[float]):
    """One missing site's estimator over the batch: rdm [B, d, d], S [G, d]
    grid states, x_prev [B], u [B] or [B, trials] uniforms (ITS).  Returns
    (x* [B], k [B] the chosen grid index or None for mean, err [B],
    cdf_n [B, G]).  torch.argmin and torch.argmax return the first index of
    a tie, as jnp.argmin and jnp.argmax do."""
    rdtype = grid_x.dtype
    tiny = torch.finfo(rdtype).tiny
    # p(x) = conj(phi(x))^T rdm phi(x) over the grid: [B, G]
    probs = ((S.conj() @ rdm) * S).sum(-1)
    probs = torch.clamp(probs.real if probs.is_complex() else probs, min=0.0)
    cdf = _cumtrapz(probs, dx)
    Z = torch.clamp(cdf[:, -1], min=tiny)
    cdf_n = cdf / Z[:, None]
    probs_n = probs / Z[:, None]
    zero = torch.zeros_like(Z)

    if method == "median":
        k = torch.argmin(torch.abs(cdf_n - 0.5), dim=-1)
        x_star = grid_x[k]
        err = _weighted_median_abs_dev(grid_x, probs_n, x_star) \
            if get_err else zero
        return x_star, k, err, cdf_n

    if method == "mean":
        # rectangle-rule expectation over trapezoid Z (sampling_utils.jl:86)
        x_star = torch.sum(grid_x * probs, dim=-1) * dx / Z
        err = torch.sqrt(torch.sum((grid_x - x_star[:, None]) ** 2 * probs,
                                   dim=-1) * dx / Z) if get_err else zero
        return x_star, None, err, cdf_n

    if method == "mode":
        if max_jump is None:
            k = torch.argmax(probs, dim=-1)
        else:
            valid = torch.abs(grid_x - x_prev[:, None]) <= max_jump
            no_prev = ~torch.isfinite(x_prev)
            masked = torch.where(valid | no_prev[:, None], probs,
                                 torch.full_like(probs, -float("inf")))
            any_valid = valid.any(dim=-1) | no_prev
            k = torch.where(any_valid, torch.argmax(masked, dim=-1),
                            torch.argmax(probs, dim=-1))
        return grid_x[k], k, zero, cdf_n

    if method == "its":
        if rejection_threshold is None:
            k = torch.argmin(torch.abs(cdf_n - u[:, None]), dim=-1)
            return grid_x[k], k, zero, cdf_n
        # rejection sampling within threshold*WMAD of the median: the first
        # accepted trial, else the last one drawn
        kmed = torch.argmin(torch.abs(cdf_n - 0.5), dim=-1)
        med = grid_x[kmed]
        wmad = _weighted_median_abs_dev(grid_x, probs_n, med)
        k, found = kmed, torch.zeros_like(kmed, dtype=torch.bool)
        for j in range(u.shape[-1]):
            k_new = torch.argmin(torch.abs(cdf_n - u[:, j, None]),
                                 dim=-1)
            ok = torch.abs(grid_x[k_new] - med) < rejection_threshold * wmad
            k = torch.where(found, k, k_new)
            found = found | ok
        return grid_x[k], k, wmad, cdf_n

    raise ValueError(f"unknown method {method!r}")


def impute_scan(cores: torch.Tensor, phis_c: torch.Tensor,
                known_mask: np.ndarray, known_x: torch.Tensor,
                x_prev0: torch.Tensor, grid_x: torch.Tensor, dx: float,
                grid_states: torch.Tensor, *, method: str = "median",
                timedep: bool = False, want_cdf: bool = False,
                get_err: bool = True, max_jump: Optional[float] = None,
                rejection_threshold: Optional[float] = None,
                uniforms: Optional[torch.Tensor] = None,
                encode_at: Optional[Callable] = None) -> ImputeResult:
    """Impute a batch of instances that share one missing pattern.

    cores [T, chi, d, chi] (one class, center folded, normalized, in scan
    order); phis_c [B, T, d] conj'd target states; known_mask [T] host
    bool; known_x [B, T] and x_prev0 [B] (NaN where there is none) in the
    real dtype of the cores, as grid_x [G]; grid_states [G, d] or, with
    ``timedep``, [T, G, d] in the cores' dtype.  ITS reads ``uniforms``
    [B, T] (or [B, T, max_trials] with ``rejection_threshold``); the mean
    estimator re-encodes its expectation with ``encode_at(x [B], t) ->
    [B, d]`` (sampling_utils.jl:87)."""
    known_mask = np.asarray(known_mask, dtype=bool)
    T, chi, d = cores.shape[0], cores.shape[1], cores.shape[2]
    B = phis_c.shape[0]
    dtype, rdtype = cores.dtype, grid_x.dtype
    tiny = torch.finfo(rdtype).tiny
    if method == "its" and uniforms is None:
        raise ValueError("method='its' needs uniforms")
    if method == "mean" and encode_at is None:
        raise ValueError("method='mean' needs encode_at")

    def trace_normalised(R):
        tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1).real
        return R / torch.clamp(tr, min=tiny)[:, None, None]

    # the known sites' transfer matrices w_t[n] = sum_i conj(phi_t)_i W[t]
    # [:, i, :], all at once; the loops below are batched matrix products
    known_t = np.flatnonzero(known_mask)
    slot = np.full(T, -1)
    slot[known_t] = np.arange(len(known_t))
    w_known = torch.einsum("taib,nti->tnab", cores[known_t],
                           phis_c[:, known_t])
    W_rows = cores.reshape(T, chi, d * chi)         # [a, (i b)]
    W_cols = cores.reshape(T, chi * d, chi)         # [(a i), b]

    # ---- backward trace-metric environments ----
    e0 = torch.zeros((chi,), dtype=dtype, device=cores.device)
    e0[0] = 1.0
    R = torch.outer(e0, e0.conj()).expand(B, chi, chi)
    R_envs = [None] * (T + 1)
    R_envs[T] = R
    for t in range(T - 1, -1, -1):
        if known_mask[t]:
            w = w_known[slot[t]]
            R = w @ R @ w.conj().transpose(-2, -1)
        else:
            # sum_i W[:, i, :] R W[:, i, :]^H
            X = (W_cols[t] @ R).reshape(B, chi, d * chi)
            R = X @ W_rows[t].conj().transpose(0, 1)
        R = trace_normalised(R)
        R_envs[t] = R

    # ---- forward conditional scan ----
    v = e0.expand(B, 1, chi)
    x_prev = x_prev0
    zero = torch.zeros((B,), dtype=rdtype, device=cores.device)
    xs, errs, cdfs = [], [], []
    for t in range(T):
        if known_mask[t]:
            v2 = v @ w_known[slot[t]]
            xs.append(known_x[:, t])
            errs.append(zero)
            if want_cdf:
                cdfs.append(torch.zeros((B, grid_x.shape[0]), dtype=rdtype,
                                        device=cores.device))
        else:
            A = (v @ W_rows[t]).reshape(B, d, chi)      # A[n, i, b]
            rdm = A @ R_envs[t + 1] @ A.conj().transpose(-2, -1)
            S = grid_states[t] if timedep else grid_states
            x_star, k, err, cdf = _estimate(
                method, rdm, S, grid_x, dx, x_prev,
                None if uniforms is None else uniforms[:, t],
                get_err=get_err, max_jump=max_jump,
                rejection_threshold=rejection_threshold)
            # the mean's state is the exact encoding at the expectation
            # (sampling_utils.jl:87), the others' a grid point's
            state = encode_at(x_star, t) if method == "mean" else S[k]
            v2 = state.to(dtype).conj()[:, None, :] @ A
            xs.append(x_star)
            errs.append(err)
            if want_cdf:
                cdfs.append(cdf)
            x_prev = x_star
        nrm = torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
        v = v2 / torch.clamp(nrm, min=tiny)
    return ImputeResult(torch.stack(xs, dim=1), torch.stack(errs, dim=1),
                        torch.stack(cdfs, dim=1) if want_cdf else None)


def reverse_problem(cores_full: torch.Tensor) -> torch.Tensor:
    """Site-reversed MPS cores for impute_order='backwards': flip the site
    axis and swap each core's bond axes.  (The reference's :backwards path is
    broken by a NameError, MPS_methods.jl:163; here it is supported.)"""
    return torch.flip(cores_full, (0,)).permute(0, 3, 2, 1)

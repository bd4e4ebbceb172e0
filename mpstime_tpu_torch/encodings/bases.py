"""Closed-form real feature-map bases on torch tensors (counterpart of
``mpstime_tpu/encodings/bases.py``; the complex bases follow in a later
slice).  Each ``*_encode`` maps ``x`` (any shape) to ``x.shape + (d,)``."""

from __future__ import annotations

import math

import torch


def uniform_encode(x: torch.Tensor, d: int) -> torch.Tensor:
    """Constant 1/d features (reference bases.jl:3-5)."""
    return torch.full(tuple(x.shape) + (d,), 1.0 / d, dtype=x.dtype,
                      device=x.device)


def _legendre_norm_const(l: int) -> float:
    # normalised Legendre: sqrt((2l+1)/2) * P_l, unit norm on L2[-1, 1]
    return math.sqrt((2 * l + 1) / 2.0)


def legendre_stack(x: torch.Tensor, lmax: int) -> torch.Tensor:
    """Normalised Legendre polynomials P~_0..P~_lmax via the Bonnet
    recurrence, stacked on the last axis (shape x.shape + (lmax+1,))."""
    p_prev = torch.ones_like(x)
    outs = [p_prev * _legendre_norm_const(0)]
    if lmax >= 1:
        p_cur = x
        outs.append(p_cur * _legendre_norm_const(1))
        for l in range(1, lmax):
            p_next = ((2 * l + 1) * x * p_cur - l * p_prev) / (l + 1)
            outs.append(p_next * _legendre_norm_const(l + 1))
            p_prev, p_cur = p_cur, p_next
    return torch.stack(outs, dim=-1)


def legendre_encode(x: torch.Tensor, d: int, norm: bool = False) -> torch.Tensor:
    """First d normalised Legendre polynomials (reference bases.jl:77-108);
    ``norm=True`` divides by sqrt(P~_d(1) * d) so that |phi(x)|^2 <= 1."""
    ls = legendre_stack(x, d - 1)
    if norm:
        ls = ls / math.sqrt(_legendre_norm_const(d) * d)
    return ls

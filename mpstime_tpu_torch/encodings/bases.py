"""Closed-form feature-map bases on torch tensors (counterpart of
``mpstime_tpu/encodings/bases.py``).  Each ``*_encode`` maps ``x`` (any
shape) to ``x.shape + (d,)``; the complex bases (``angle_encode``,
``fourier_encode``, ``sahand_encode``) return the complex dtype of x's
precision."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


def const(a, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A host constant (array, list or scalar) as a tensor on ``like``'s
    device, in ``dtype`` (default ``like``'s).  The host-to-device copy is
    queued without waiting for the card's queue, so encoding inside a loop
    of device work does not synchronise."""
    t = torch.as_tensor(a, dtype=like.dtype if dtype is None else dtype)
    return t.to(like.device, non_blocking=True)


def _cis(theta: torch.Tensor) -> torch.Tensor:
    """e^{i theta} as cos + i sin (the JAX package's Euler form)."""
    return torch.complex(torch.cos(theta), torch.sin(theta))


def uniform_encode(x: torch.Tensor, d: int) -> torch.Tensor:
    """Constant 1/d features (reference bases.jl:3-5)."""
    return torch.full(tuple(x.shape) + (d,), 1.0 / d, dtype=x.dtype,
                      device=x.device)


def angle_encode(x: torch.Tensor, d: int = 2,
                 periods: float = 0.25) -> torch.Tensor:
    """Stoudenmire spin-1/2 angle encoding, d=2 only (reference
    bases.jl:8-20): [e^{3 i pi x/2} cos(2 pi p x), e^{-3 i pi x/2}
    sin(2 pi p x)]."""
    if d != 2:
        raise ValueError("Stoudenmire angle encoding only supports d = 2!")
    ph = _cis(1.5 * math.pi * x)
    s1 = ph * torch.cos(2 * math.pi * periods * x)
    s2 = ph.conj() * torch.sin(2 * math.pi * periods * x)
    return torch.stack([s1, s2], dim=-1)


def get_fourier_freqs(d: int) -> np.ndarray:
    """Symmetric frequency selection [0, 1, -1, 2, -2, ...][:d]
    (reference bases.jl:27-34)."""
    hbound = int(math.ceil((d - 1.0) / 2.0))
    freqs = [0]
    for i in range(1, hbound + 1):
        freqs += [i, -i]
    return np.asarray(freqs[:d], dtype=np.float64)


def fourier_encode(x: torch.Tensor, d: int,
                   freqs: Optional[Sequence[float]] = None) -> torch.Tensor:
    """phi_k(x) = e^{i pi f_k x} / sqrt(nf) (reference bases.jl:23-50);
    ``freqs`` overrides the default symmetric selection."""
    if freqs is None:
        freqs = get_fourier_freqs(d)
    f = const(np.asarray(freqs), x)
    return _cis(math.pi * x[..., None] * f) / math.sqrt(float(f.shape[0]))


def sahand_encode(x: torch.Tensor, d: int) -> torch.Tensor:
    """Piecewise-interval complex basis, even d (reference bases.jl:53-74)."""
    if d % 2 != 0:
        raise ValueError("Sahand encoding only supports even dimension")
    x = x[..., None]
    i = np.arange(1, d + 1, dtype=np.float64)            # basis index
    dx = 2.0 / d
    interval = np.ceil(i / 2.0)
    startx = const((interval - 1) * dx, x)
    inside = (startx <= x) & (x <= const(interval * dx, x))
    odd = const(i.astype(np.int64) % 2 == 1, x, torch.bool)
    phase = _cis(math.pi * 1.5 * x / dx)
    arg = 0.5 * math.pi * (x - startx) / dx
    vals = torch.where(odd, phase * torch.cos(arg),
                       phase.conj() * torch.sin(arg))
    return vals * inside.to(x.dtype)


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


def polyval_matrix(x: torch.Tensor, cvecs) -> torch.Tensor:
    """Evaluate the d polynomial rows of ``cvecs`` [d, d] (coefficients in
    increasing power order, reference bases.jl:115) at x -> x.shape + (d,)."""
    cvecs = const(cvecs, x)
    d = cvecs.shape[-1]
    powers = torch.pow(x[..., None],
                       torch.arange(d, dtype=x.dtype, device=x.device))
    return torch.einsum("...i,ni->...n", powers, cvecs)

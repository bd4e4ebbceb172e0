"""Warm-started truncated two-site splits (counterpart of the
``randomized_warm`` pieces of ``mpstime_tpu/ops/decomp.py``).

Shapes are static: a split always yields exactly ``keep`` (= chi_max)
directions and truncation (the chi cap and ITensor's relative ``cutoff`` on
squared singular values, reference decomposeBT RealRealHighDimension.jl:
146-203) is a mask that zeroes dropped directions.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _tiny(t: torch.Tensor) -> float:
    return torch.finfo(t.real.dtype).tiny


def _trunc_mask(w_desc: torch.Tensor, keep: int, cutoff,
                max_rank=None) -> torch.Tensor:
    """0/1 truncation mask over descending squared singular values: keep the
    minimal rank r with sum_{k>r} p_k <= cutoff * sum(p), r <= keep, and
    r <= ``max_rank`` when given."""
    w = torch.clamp(w_desc.real, min=0.0)
    total = torch.sum(w)
    # suffix[i] = sum_{k>=i} w_k; discard index i iff suffix[i] <= cutoff*total
    suffix = total - (torch.cumsum(w, 0) - w)
    idx = torch.arange(w.shape[0], device=w.device)
    mask = (suffix > cutoff * total) & (idx < keep) & (w > 0)
    if max_rank is not None:
        mask = mask & (idx < max_rank)
    return mask.to(w.dtype)


def _qr_orth(Y: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of the columns of Y: the Q of a reduced QR (the
    real branch of the JAX package's ``_qr_orth``)."""
    if Y.is_complex():
        raise NotImplementedError("complex QR orthogonalisation is ROADMAP.md "
                                  "queue 1 item 14 (complex encodings)")
    return torch.linalg.qr(Y, mode="reduced")[0]


#: Quintic Newton-Schulz coefficients and iteration counts per power step
#: (mpstime_tpu/ops/decomp.py:104-113): 8 quintic steps inflate small
#: singular values by ~3.44 each, then 6 cubic steps converge to
#: orthonormality.
_NS_QA, _NS_QB, _NS_QC = 3.4445, -4.7750, 2.0315
_NS_QUINTIC, _NS_CUBIC = 8, 6
#: eps * Y_prev revival before each polar step: keeps every cached
#: direction alive and bounds the input's condition number at ~1/eps
#: (mpstime_tpu/ops/decomp.py:114-137 gives the two failure modes it fixes).
_NS_REVIVE = 1e-3


def ns_orth(Y: torch.Tensor, n_quintic: int = _NS_QUINTIC,
            n_cubic: int = _NS_CUBIC) -> torch.Tensor:
    """Matmul-only polar orthogonalisation (Newton-Schulz): an orthonormal
    basis of span(Y), Y (Y^H Y)^(-1/2)."""
    nf = torch.linalg.vector_norm(Y) * (1.0 + 1e-3)
    X = Y / torch.clamp(nf, min=_tiny(Y))
    eye = torch.eye(Y.shape[1], dtype=Y.dtype, device=Y.device)
    for _ in range(n_quintic):
        G = X.conj().T @ X
        G2 = G @ G
        X = X @ (_NS_QA * eye + _NS_QB * G + _NS_QC * G2)
    for _ in range(n_cubic):
        G = X.conj().T @ X
        X = 1.5 * X - 0.5 * (X @ G)
    return X


def _orth(Y: torch.Tensor, orth: str) -> torch.Tensor:
    return ns_orth(Y) if orth == "ns" else _qr_orth(Y)


def _col_normalize(Z: torch.Tensor) -> torch.Tensor:
    return Z / torch.clamp(torch.linalg.vector_norm(Z, dim=0, keepdim=True),
                           min=_tiny(Z))


def _warm_power(mm, Y: torch.Tensor, q: int, orth: str) -> torch.Tensor:
    """q power steps of ``mm`` (one application of M^H M or M M^H) from the
    cached basis Y with per-step column normalisation; orth="ns" runs
    subspace iteration (eps revival + NS polar after every step), other
    orths orthogonalise once at the end."""
    for _ in range(q):
        Z = _col_normalize(mm(Y))
        Y = ns_orth(Z + _NS_REVIVE * Y) if orth == "ns" else Z
    return Y if orth == "ns" else _orth(Y, orth)


def _mask_by_energy(w: torch.Tensor, keep: int, cutoff, max_rank):
    """Per-direction keep mask from unsorted direction energies: the
    truncation rule over a stable descending sort."""
    order = torch.argsort(-w, stable=True)
    mask = _trunc_mask(w[order], keep, cutoff, max_rank)
    keep_col = torch.zeros_like(w)
    keep_col[order] = mask
    return keep_col


def warm_split_left(M: torch.Tensor, V0: torch.Tensor, keep: int, cutoff,
                    q: int = 1, refresh: bool = True, max_rank=None,
                    orth: str = "ns"
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Warm-started eigh-free split (column side) of M [R, C] against the
    previous sweep's subspace V0 [C, keep].  Returns (US, Vh, V_next), where
    V_next is the unmasked orthonormal basis cached for the next sweep."""
    k = min(keep, M.shape[1])
    if refresh:
        Q = _warm_power(lambda Yp: M.conj().T @ (M @ Yp), V0[:, :k], q, orth)
    else:
        Q = V0[:, :k]          # frozen sweep: split against the cached basis
    B = M @ Q
    keep_col = _mask_by_energy(torch.sum(B.abs() ** 2, dim=0), keep, cutoff,
                               max_rank)
    US = B * keep_col
    Vh = Q.conj().T * keep_col[:, None]
    if keep > k:
        US = torch.nn.functional.pad(US, (0, keep - k))
        Vh = torch.nn.functional.pad(Vh, (0, 0, 0, keep - k))
        Q = torch.nn.functional.pad(Q, (0, keep - k))
    return US, Vh, Q


def warm_split_right(M: torch.Tensor, U0: torch.Tensor, keep: int, cutoff,
                     q: int = 1, refresh: bool = True, max_rank=None,
                     orth: str = "ns"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mirror of :func:`warm_split_left` on the row side; U0 [R, keep]."""
    k = min(keep, M.shape[0])
    if refresh:
        Q = _warm_power(lambda Yp: M @ (M.conj().T @ Yp), U0[:, :k], q, orth)
    else:
        Q = U0[:, :k]
    B = Q.conj().T @ M
    keep_col = _mask_by_energy(torch.sum(B.abs() ** 2, dim=1), keep, cutoff,
                               max_rank)
    U = Q * keep_col
    SVh = B * keep_col[:, None]
    if keep > k:
        U = torch.nn.functional.pad(U, (0, keep - k))
        SVh = torch.nn.functional.pad(SVh, (0, 0, 0, keep - k))
        Q = torch.nn.functional.pad(Q, (0, keep - k))
    return U, SVh, Q


def warm_sketch_init(n: int, keep: int, dtype, device="cpu") -> torch.Tensor:
    """Orthonormal cold-start subspace [n, min(keep, n)] padded to keep:
    host numpy, as the JAX package's (decomp.py:774), so both packages
    start from bit-identical caches."""
    k = min(keep, n)
    rng = np.random.default_rng(20240817)
    Psi = rng.standard_normal((n, k))
    if np.dtype(dtype).kind == "c":
        Psi = Psi + 1j * rng.standard_normal((n, k))
    Q, _ = np.linalg.qr(Psi.astype(dtype))
    if keep > k:
        Q = np.pad(Q, ((0, 0), (0, keep - k)))
    return torch.from_numpy(np.ascontiguousarray(Q)).to(device)

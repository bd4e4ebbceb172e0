"""Truncated two-site splits (counterpart of the real routes of
``mpstime_tpu/ops/decomp.py``): the warm-started splits of the fused bond
step, and the unfused ones, ``split_bond_left/right`` with the Gram
eigendecomposition (the CPU default), the SVD, and the cold randomized and
lean sketches.

Shapes are static: a split always yields exactly ``keep`` (= chi_max)
directions and truncation (the chi cap and ITensor's relative ``cutoff`` on
squared singular values, reference decomposeBT RealRealHighDimension.jl:
146-203) is a mask that zeroes dropped directions.
"""

from __future__ import annotations

import functools
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


def _fixed_sketch(shape, dtype, device="cpu") -> torch.Tensor:
    """Deterministic Gaussian sketch matrix: host numpy from the JAX
    package's seed (decomp.py:53), so both packages sketch with bit-identical
    matrices; the same sketch serves every bond."""
    rng = np.random.default_rng(20240817)
    om = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        om = om + 1j * rng.standard_normal(shape)
    return torch.from_numpy(om.astype(dtype)).to(device)


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _qr_orth(Y: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of the columns of Y: the Q of a reduced QR (the
    JAX package's ``_qr_orth``, decomp.py:64-101).

    A complex Y takes one real QR of its realified [2R, 2k] embedding,
    which interleaves each column y with i*y; the even columns' halves are
    the (Re, Im) parts of a nested complex-orthonormal basis.  This keeps
    the JAX package's per-column phases (a complex QR picks others, and the
    warm caches carry them on).  On a rank-deficient Y the fill-in columns
    of the deficient tail need not be complex-orthonormal; their energies
    are ~0 and the cutoff mask drops them (decomp.py:80-91)."""
    if not Y.is_complex():
        return torch.linalg.qr(Y, mode="reduced")[0]
    R, k = Y.shape
    Yr, Yi = Y.real, Y.imag
    top = torch.stack([Yr, -Yi], dim=2).reshape(R, 2 * k)
    bot = torch.stack([Yi, Yr], dim=2).reshape(R, 2 * k)
    Qe = torch.linalg.qr(torch.cat([top, bot]), mode="reduced")[0][:, ::2]
    return torch.complex(Qe[:R], Qe[R:])


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


#: Damped triangular-Newton iterations of ``tri_newton``
#: (mpstime_tpu/ops/pallas_bond_c.py:320-325).
_TRI_NEWTON_ITERS = 8


def tri_newton(X: torch.Tensor, iters: int = _TRI_NEWTON_ITERS
               ) -> torch.Tensor:
    """QR-gauge orthogonalisation by damped triangular Newton, the plain
    version of the JAX package's ``_tri_newton_pair`` (pallas_bond_c.py:
    328-365): X <- X (I - s (triu(E, 1) + diag(E)/2)) with E = X^H X - I and
    s = 1 / max(1, ||E||_F).  Every correction is upper triangular, so the
    limit is the thin-QR Q factor of X with a positive real R diagonal; the
    fused tracked-ritz step (K12cr) refreshes its basis with it."""
    k = X.shape[1]
    eye = torch.eye(k, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        E = X.conj().T @ X - eye
        s = 1.0 / torch.clamp(torch.linalg.vector_norm(E), min=1.0)
        # diag(E) is real (E is hermitian), so T's diagonal is real
        T = eye - s * (torch.triu(E, 1) + torch.diag(E.diagonal().real / 2))
        X = X @ T
    return X


def _orth(Y: torch.Tensor, orth: str) -> torch.Tensor:
    return ns_orth(Y) if orth == "ns" else _qr_orth(Y)


def _col_normalize(Z: torch.Tensor) -> torch.Tensor:
    return Z / torch.clamp(torch.linalg.vector_norm(Z, dim=0, keepdim=True),
                           min=_tiny(Z))


def _power_orth(mm, Y0: torch.Tensor, q: int, orth: str) -> torch.Tensor:
    """Orthonormal basis of the q-step power iterate of Y0 under ``mm``
    (decomp.py:194): orth="qr" chains q applications, normalises the columns
    once and takes one QR; orth="ns" runs subspace iteration (per-step
    normalisation, eps revival and NS polar after every step)."""
    if orth == "ns":
        Y = _col_normalize(Y0)
        for _ in range(q):
            Y = ns_orth(_col_normalize(mm(Y)) + _NS_REVIVE * Y)
        return Y
    for _ in range(q):
        Y0 = mm(Y0)
    return _orth(_col_normalize(Y0), orth)


def _sketch_k(keep: int, other: int) -> int:
    """Sketch width: keep + max(keep/8, 8) oversampling, capped by the small
    dimension (decomp.py:227)."""
    return min(keep + max(keep // 8, 8), other)


def warm_iterate(mm, Y: torch.Tensor, q: int, orth: str) -> torch.Tensor:
    """q power steps of ``mm`` (one application of M^H M or M M^H) from the
    cached basis Y with per-step column normalisation.  orth="ns" runs
    subspace iteration (eps revival + NS polar after every step) and returns
    an orthonormal basis; orth="tri" orthogonalises every normalised step
    by ``tri_newton``, with no revival (K12cr's refresh, pallas_bond_c.py:
    289-294); other orths return the column-normalised iterate, which the
    caller orthogonalises (K1's Y)."""
    for _ in range(q):
        Z = _col_normalize(mm(Y))
        if orth == "ns":
            Y = ns_orth(Z + _NS_REVIVE * Y)
        elif orth == "tri":
            Y = tri_newton(Z)
        else:
            Y = Z
    return Y


def _warm_power(mm, Y: torch.Tensor, q: int, orth: str) -> torch.Tensor:
    """The warm splits' subspace refresh (decomp.py:362): ``warm_iterate``,
    orthogonalised once at the end unless orth="ns"."""
    Y = warm_iterate(mm, Y, q, orth)
    return Y if orth == "ns" else _orth(Y, orth)


def _mask_by_energy(w: torch.Tensor, keep: int, cutoff, max_rank):
    """Per-direction keep mask from unsorted direction energies: the
    truncation rule over a stable descending sort."""
    order = torch.argsort(-w, stable=True)
    mask = _trunc_mask(w[order], keep, cutoff, max_rank)
    keep_col = torch.zeros_like(w)
    keep_col[order] = mask
    return keep_col


def _pairwise_mask(w: torch.Tensor, cutoff, max_rank=None) -> torch.Tensor:
    """The same rule without a sort, as the bond kernels apply it
    (mpstime_tpu/ops/pallas_bond.py:662-697): direction i counts j toward
    its suffix iff w_j < w_i, or w_j == w_i and j >= i (the stable
    descending order), and is kept iff that suffix's energy exceeds cutoff
    * total, w_i > 0, and its sorted position is below max_rank."""
    k = w.shape[0]
    idx = torch.arange(k, device=w.device)
    wi, wj = w[:, None], w[None, :]
    leq = (wj < wi) | ((wj == wi) & (idx[None, :] >= idx[:, None]))
    suffix = torch.sum(torch.where(leq, wj, torch.zeros_like(wj)), dim=1)
    cnt = torch.sum(leq, dim=1)
    mr = k if max_rank is None else max_rank
    keep = (suffix > cutoff * torch.sum(w)) & (w > 0) & (cnt > k - mr)
    return keep.to(w.dtype)


def _pad_cols(X: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(X, (0, n)) if n > 0 else X


def _pad_rows(X: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(X, (0, 0, 0, n)) if n > 0 else X


def warm_split_left(M: torch.Tensor, V0: torch.Tensor, keep: int, cutoff,
                    q: int = 1, refresh: bool = True, max_rank=None,
                    orth: str = "qr"
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
    return (_pad_cols(B * keep_col, keep - k),
            _pad_rows(Q.conj().T * keep_col[:, None], keep - k),
            _pad_cols(Q, keep - k))


def warm_split_right(M: torch.Tensor, U0: torch.Tensor, keep: int, cutoff,
                     q: int = 1, refresh: bool = True, max_rank=None,
                     orth: str = "qr"
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
    return (_pad_cols(Q * keep_col, keep - k),
            _pad_rows(B * keep_col[:, None], keep - k),
            _pad_cols(Q, keep - k))


# ---- the ritz route: per-bond eigen-rotations of the projected Gram ------

#: Orthogonal-iteration steps per bond for rot="track" (decomp.py:445-451).
_RITZ_TRACK_ITERS = 2


def _ritz_rot_track(S: torch.Tensor, iters: int = _RITZ_TRACK_ITERS
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigh-free eigen-tracking of a hermitian PSD S [k, k] by orthogonal
    iteration, W <- qr(S W) from W0 = qr(S), on S scaled by max |diag S|
    (decomp.py:454-502).  Returns the Rayleigh quotients diag(W^H S W)
    sorted descending and W's columns in that order."""
    nf = torch.clamp(torch.max(torch.abs(torch.diagonal(S))), min=_tiny(S))
    Sn = S / nf
    W = _qr_orth(Sn)
    for _ in range(iters - 1):
        W = _qr_orth(Sn @ W)
    w = torch.diagonal(W.conj().T @ (S @ W)).real
    order = torch.argsort(-w, stable=True)
    return w[order], W[:, order]


#: Relative size, per real itemsize, of the fixed hermitian perturbation
#: that splits degenerate complex clusters before the realified eigh
#: (decomp.py:505-517).
_EIGH_R_SPLIT = {4: 1e-5, 8: 1e-11}


@functools.lru_cache(maxsize=8)
def _fixed_hermitian_np(k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic unit-norm hermitian (re, im) parts [k, k]: host numpy
    from the JAX package's seed (decomp.py:520-527), bit-identical."""
    rng = np.random.default_rng(20250819)
    A = rng.standard_normal((k, k)) + 1j * rng.standard_normal((k, k))
    H = (A + A.conj().T) / 2
    H = H / np.linalg.norm(H)
    return np.ascontiguousarray(H.real), np.ascontiguousarray(H.imag)


def _ritz_rot_eigh_realified(S: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of a complex hermitian S [k, k] through one real
    symmetric eigh of its realified [2k, 2k] embedding (decomp.py:530-569):
    a fixed eps-hermitian perturbation splits degenerate complex clusters,
    every other column of the descending real eigenbasis gives one complex
    representative per eigenvalue, and the realified QR polishes them.
    Returns the unperturbed Rayleigh quotients, descending, and W."""
    k = S.shape[0]
    rdt = S.real.dtype
    nf = torch.clamp(torch.linalg.vector_norm(S), min=_tiny(S))
    eps = _EIGH_R_SPLIT[torch.finfo(rdt).bits // 8]
    Hr, Hi = (torch.from_numpy(h).to(rdt).to(S.device)
              for h in _fixed_hermitian_np(k))
    Sr = S.real + (eps * nf) * Hr
    Si = S.imag + (eps * nf) * Hi
    R = torch.cat([torch.cat([Sr, -Si], 1), torch.cat([Si, Sr], 1)])
    _, V = _eigh_desc(R)                         # J-pairs adjacent
    cand = V[:, ::2]
    W = _qr_orth(torch.complex(cand[:k], cand[k:]).to(S.dtype))
    wq = torch.diagonal(W.conj().T @ (S @ W)).real
    order = torch.argsort(-wq, stable=True)
    return wq[order], W[:, order]


#: Odd-even adjacent-pair Jacobi rounds per bond for rot="jacobi" (the
#: tracked sweeps) and rot="jacobi_warm" (the cold-start sweeps that stand
#: in for an exact eigh), decomp.py:572-587.
_JACOBI_ROUNDS = 6
_JACOBI_WARM_ROUNDS = 24


def _jacobi_round(S: torch.Tensor, W: torch.Tensor, off: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round of exact 2x2 Jacobi rotations on the disjoint adjacent
    pairs (i, i+1), i = off, off+2, ...: S <- J^H S J, W <- W J
    (decomp.py:590-638, the same branch rules).  Each rotation's first
    column is the larger eigenvector of its 2x2 block, so every touched pair
    leaves in descending order."""
    k = S.shape[0]
    cdt, rdt = S.dtype, S.real.dtype
    idx = torch.arange(k, device=S.device)
    first = (idx >= off) & ((idx - off) % 2 == 0) & (idx + 1 < k)
    alpha = torch.diagonal(S).real
    beta = torch.roll(alpha, -1)
    woff = torch.cat([torch.diagonal(S, 1), torch.zeros(1, dtype=cdt,
                                                        device=S.device)])
    aw = torch.abs(woff)
    half = (alpha - beta) / 2
    root = torch.sqrt(half * half + aw * aw)
    mu_p = (alpha + beta) / 2 + root
    use_hi = alpha >= beta
    x = torch.where(use_hi, (mu_p - beta).to(cdt), woff)
    y = torch.where(use_hi, woff.conj(), (mu_p - alpha).to(cdt))
    n = torch.sqrt(torch.abs(x) ** 2 + torch.abs(y) ** 2)
    live = first & (n > torch.finfo(rdt).tiny ** 0.5)
    n_safe = torch.where(live, n, torch.ones_like(n)).to(cdt)
    one = torch.ones_like(x)
    x = torch.where(live, x / n_safe, one)
    y = torch.where(live, y / n_safe, torch.zeros_like(y))
    # J: column i = (x, y) at rows (i, i+1); column i+1 = (-conj(y), conj(x))
    diag = torch.where(live, x, one)
    diag = torch.where(torch.roll(live, 1), torch.roll(x.conj(), 1), diag)
    J = (torch.diag(diag) + torch.diag((-y.conj())[:-1], 1)
         + torch.diag(y[:-1], -1))
    S2 = J.conj().T @ (S @ J)
    return (S2 + S2.conj().T) / 2, W @ J


def _ritz_rot_jacobi(S: torch.Tensor, rounds: int = _JACOBI_ROUNDS
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matmul-only eigen-tracker: ``rounds`` alternating odd-even rounds of
    ``_jacobi_round`` on S scaled by max |diag S| (decomp.py:641-672).
    Returns (w, W) in ROUND ORDER, not sorted, as the fused kernel K12cr
    (which cannot reorder columns) returns them."""
    nf = torch.clamp(torch.max(torch.abs(torch.diagonal(S))), min=_tiny(S))
    Sn = S / nf
    W = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    for r in range(rounds):
        Sn, W = _jacobi_round(Sn, W, r % 2)
    return torch.diagonal(Sn).real * nf, W


def _ritz_rot(S: torch.Tensor, rot: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ritz splits' eigen-rotation (decomp.py:675-690): the exact eigh
    (descending), the realified eigh ("eigh_r", complex S), or the eigh-free
    trackers "track", "jacobi" and "jacobi_warm"."""
    if rot == "track":
        return _ritz_rot_track(S)
    if rot == "jacobi":
        return _ritz_rot_jacobi(S)
    if rot == "jacobi_warm":
        return _ritz_rot_jacobi(S, rounds=_JACOBI_WARM_ROUNDS)
    if rot == "eigh_r" and S.is_complex():
        return _ritz_rot_eigh_realified(S)
    return _eigh_desc(S)


def warm_ritz_split_left(M: torch.Tensor, V0: torch.Tensor, keep: int,
                         cutoff, q: int = 1, refresh: bool = True,
                         max_rank=None, orth: str = "qr", rot: str = "eigh"
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``warm_split_left`` plus a per-bond Rayleigh-Ritz rotation
    (svd_alg="randomized_warm_ritz", decomp.py:693-745): the kept basis is
    rotated by the eigenbasis W of the projected Gram S = (M Q)^H (M Q),
    and the cutoff mask reads its eigenvalues, decided in sorted order and
    scattered back to the rotation's column order.  Returns (US, Vh,
    V_next) with V_next = Q W, rotated and unmasked."""
    k = min(keep, M.shape[1])
    Q = (_warm_power(lambda Yp: M.conj().T @ (M @ Yp), V0[:, :k], q, orth)
         if refresh else V0[:, :k])
    B = M @ Q
    w, W = _ritz_rot(B.conj().T @ B, rot)
    Wm = W * _mask_by_energy(w, keep, cutoff, max_rank)
    return (_pad_cols(B @ Wm, keep - k),
            _pad_rows((Q @ Wm).conj().T.resolve_conj(), keep - k),
            _pad_cols(Q @ W, keep - k))


def warm_ritz_split_right(M: torch.Tensor, U0: torch.Tensor, keep: int,
                          cutoff, q: int = 1, refresh: bool = True,
                          max_rank=None, orth: str = "qr", rot: str = "eigh"
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mirror of :func:`warm_ritz_split_left` on the row side
    (decomp.py:748-771); U0 [R, keep]."""
    k = min(keep, M.shape[0])
    Q = (_warm_power(lambda Yp: M @ (M.conj().T @ Yp), U0[:, :k], q, orth)
         if refresh else U0[:, :k])
    B = Q.conj().T @ M
    w, W = _ritz_rot(B @ B.conj().T, rot)
    Wm = W * _mask_by_energy(w, keep, cutoff, max_rank)
    return (_pad_cols(Q @ Wm, keep - k),
            _pad_rows(Wm.conj().T @ B, keep - k),
            _pad_cols(Q @ W, keep - k))


def _eigh_desc(G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenpairs of a hermitian G in descending order (eigh ascends).

    The Gram matrices of early bonds at the allocated width have mostly
    exactly-zero rows (ECG200 at chi 25, d 5: 125 x 125 with 116 zero rows,
    rank 5), and MKL's eigensolver fails on them: in float32 it raises or
    returns NaN eigenvectors (25 failures in 100 such matrices), and in
    float64 multi-threaded syevd raises LinAlgError at some thread counts
    (4 and 8 threads on that matrix, tests/data/eigh_zero_rows_gram.npy).
    So single precision is solved in double and cast back, and only the
    live block (the rows and columns that are not exactly zero) goes to the
    solver, on every device.  A zero row of a hermitian matrix is an exact
    null direction: its unit vector is an eigenvector of eigenvalue 0, and
    the live block's eigenpairs, embedded, are the others.  The solve gets
    smaller and every eigenpair stays exact."""
    wide = {torch.float32: torch.float64, torch.complex64: torch.complex128}
    Gw = G.to(wide.get(G.dtype, G.dtype))
    n = Gw.shape[-1]
    nonzero = (Gw != 0).any(dim=1)
    live = torch.nonzero(nonzero).flatten()
    m = live.numel()
    if m == n:
        w, V = torch.linalg.eigh(Gw)
    else:
        wl, Vl = torch.linalg.eigh(Gw[live][:, live])
        dead = torch.nonzero(~nonzero).flatten()
        w = torch.cat([wl, wl.new_zeros(n - m)])
        V = Gw.new_zeros((n, n))
        V[live, :m] = Vl
        V[dead, torch.arange(m, n, device=Gw.device)] = 1
        order = torch.sort(w, stable=True).indices
        w, V = w[order], V[:, order]
    return (torch.flip(w, (0,)).to(G.real.dtype),
            torch.flip(V, (1,)).to(G.dtype))


def randomized_split_left(M: torch.Tensor, keep: int, cutoff, q: int = 2,
                          max_rank=None, orth: str = "qr"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Randomized truncated split (column side, decomp.py:235): a sketched
    power iteration finds the dominant right-singular subspace, a
    Rayleigh-Ritz eigh orders it for the cutoff."""
    R, C = M.shape
    k = _sketch_k(keep, C)
    if k >= C:
        return split_bond_left(M, keep, cutoff, "gram_eigh", max_rank=max_rank)
    Psi = _fixed_sketch((R, k), _np_dtype(M), M.device)
    Q = _power_orth(lambda Yp: M.conj().T @ (M @ Yp), M.conj().T @ Psi, q,
                    orth)                                    # [C, k]
    B = M @ Q
    w, W = _eigh_desc(B.conj().T @ B)                        # [k, k] Ritz Gram
    mask = _trunc_mask(w, keep, cutoff, max_rank)
    Qt = Q @ (W[:, :keep] * mask[:keep])                     # k > keep here
    return M @ Qt, Qt.conj().T


def randomized_split_right(M: torch.Tensor, keep: int, cutoff, q: int = 2,
                           max_rank=None, orth: str = "qr"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mirror of :func:`randomized_split_left` on the row side (U, SVh)."""
    R, C = M.shape
    k = _sketch_k(keep, R)
    if k >= R:
        return split_bond_right(M, keep, cutoff, "gram_eigh", max_rank=max_rank)
    Psi = _fixed_sketch((C, k), _np_dtype(M), M.device)
    Q = _power_orth(lambda Yp: M @ (M.conj().T @ Yp), M @ Psi, q,
                    orth)                                    # [R, k]
    B = Q.conj().T @ M
    w, W = _eigh_desc(B @ B.conj().T)
    mask = _trunc_mask(w, keep, cutoff, max_rank)
    Ut = Q @ (W[:, :keep] * mask[:keep])
    return Ut, Ut.conj().T @ M


def lean_split_left(M: torch.Tensor, keep: int, cutoff, q: int = 2,
                    max_rank=None, orth: str = "qr"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Randomized split without the Rayleigh-Ritz eigh (decomp.py:296): the
    sketched basis itself is the kept isometry, masked by column energy."""
    R, C = M.shape
    k = min(keep, C)
    Psi = _fixed_sketch((R, k), _np_dtype(M), M.device)
    Q = _power_orth(lambda Yp: M.conj().T @ (M @ Yp), M.conj().T @ Psi, q,
                    orth)                                    # [C, k]
    B = M @ Q
    keep_col = _mask_by_energy(torch.sum(B.abs() ** 2, dim=0), keep, cutoff,
                               max_rank)
    return (_pad_cols(B * keep_col, keep - k),
            _pad_rows(Q.conj().T * keep_col[:, None], keep - k))


def lean_split_right(M: torch.Tensor, keep: int, cutoff, q: int = 2,
                     max_rank=None, orth: str = "qr"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mirror of :func:`lean_split_left` on the row side."""
    R, C = M.shape
    k = min(keep, R)
    Psi = _fixed_sketch((C, k), _np_dtype(M), M.device)
    Q = _power_orth(lambda Yp: M @ (M.conj().T @ Yp), M @ Psi, q,
                    orth)                                    # [R, k]
    B = Q.conj().T @ M
    keep_col = _mask_by_energy(torch.sum(B.abs() ** 2, dim=1), keep, cutoff,
                               max_rank)
    return (_pad_cols(Q * keep_col, keep - k),
            _pad_rows(B * keep_col[:, None], keep - k))


def split_bond_left(M: torch.Tensor, keep: int, cutoff,
                    alg: str = "gram_eigh", max_rank=None, orth: str = "qr"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split M [R, C] -> (US [R, keep], Vh [keep, C]) with V column-
    orthonormal, truncated and masked (decomp.py:788).  Used going left:
    U*S joins the new center (reference RealRealHighDimension.jl:171-173).
    ``alg``: "gram_eigh" (eigh of M^H M), "svd", "randomized",
    "randomized_lean"."""
    if alg == "randomized":
        return randomized_split_left(M, keep, cutoff, max_rank=max_rank,
                                     orth=orth)
    if alg == "randomized_lean":
        return lean_split_left(M, keep, cutoff, max_rank=max_rank, orth=orth)
    if alg == "svd":
        U, S, Vh = torch.linalg.svd(M, full_matrices=False)
        mask = _trunc_mask(S * S, keep, cutoff, max_rank)
        k = min(keep, S.shape[0])
        return (_pad_cols(U[:, :k] * (S[:k] * mask[:k]), keep - k),
                _pad_rows(Vh[:k] * mask[:k, None], keep - k))
    w, V = _eigh_desc(M.conj().T @ M)
    mask = _trunc_mask(w, keep, cutoff, max_rank)
    k = min(keep, M.shape[1])
    Vk = V[:, :k] * mask[:k]
    return _pad_cols(M @ Vk, keep - k), _pad_rows(Vk.conj().T, keep - k)


def split_bond_right(M: torch.Tensor, keep: int, cutoff,
                     alg: str = "gram_eigh", max_rank=None, orth: str = "qr"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split M [R, C] -> (U [R, keep], SVh [keep, C]) with U column-
    orthonormal, truncated and masked (decomp.py:828).  Used going right:
    S*Vh joins the new center (reference RealRealHighDimension.jl:189-191)."""
    if alg == "randomized":
        return randomized_split_right(M, keep, cutoff, max_rank=max_rank,
                                      orth=orth)
    if alg == "randomized_lean":
        return lean_split_right(M, keep, cutoff, max_rank=max_rank, orth=orth)
    if alg == "svd":
        U, S, Vh = torch.linalg.svd(M, full_matrices=False)
        mask = _trunc_mask(S * S, keep, cutoff, max_rank)
        k = min(keep, S.shape[0])
        return (_pad_cols(U[:, :k] * mask[:k], keep - k),
                _pad_rows((S[:k] * mask[:k])[:, None] * Vh[:k], keep - k))
    w, U = _eigh_desc(M @ M.conj().T)
    mask = _trunc_mask(w, keep, cutoff, max_rank)
    k = min(keep, M.shape[0])
    Uk = U[:, :k] * mask[:k]
    return _pad_cols(Uk, keep - k), _pad_rows(Uk.conj().T @ M, keep - k)


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

"""Plain reference of an MPSTime fit and classify: numpy and torch only.

It follows the published method (MPSTime.jl, arXiv:2412.15826; the fit of
`src/Training/RealRealHighDimension.jl`, the encodings of
`src/Encodings/bases.jl`, the transforms of `src/utils.jl`) with the split
that the benchmark's configurations state: the warm-started subspace split
(`svd_alg="randomized_warm"`) with Newton-Schulz orthogonalisation (`ns`)
and `q` power steps a bond, KLD loss and a TSGO step.  Every function here
is written out anew: nothing of the program under test is imported.

Each step takes ``rnd``, applied to every tensor it makes: the identity for
the reference itself (float64), ``round_bf16`` for the control that stands
in for a lower-precision program.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

Rnd = Callable[[torch.Tensor], torch.Tensor]


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 storage (real and imaginary parts apart), keeping
    the tensor's dtype: every stored value carries bf16's 8-bit mantissa."""
    if x.is_complex():
        return torch.complex(x.real.to(torch.bfloat16).to(x.real.dtype),
                             x.imag.to(torch.bfloat16).to(x.real.dtype))
    if x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    return x


# ---- preprocessing (utils.jl:161-295) -------------------------------------

def _sigmoid(X, med, iqr):
    scale = iqr / 1.35
    if scale == 0:
        scale = 1.0
    return 1.0 / (1.0 + np.exp(-(X - med) / scale))


def fit_norms(X_train: np.ndarray) -> Tuple[float, float, float, float]:
    """(median, IQR, min, max): the robust sigmoid's statistics over the
    whole training matrix, then the min and max of its output."""
    X = np.asarray(X_train, np.float64)
    med = float(np.median(X))
    iqr = float(np.quantile(X, 0.75) - np.quantile(X, 0.25))
    S = _sigmoid(X, med, iqr)
    return med, iqr, float(S.min()), float(S.max())


def scale_rows(X: np.ndarray, norms, enc_range, rescue: bool) -> np.ndarray:
    """Robust sigmoid -> min-max to [0, 1] -> (rescue: shift and shrink a
    test series that leaves [0, 1]) -> affine map onto the encoding's
    domain."""
    med, iqr, lo, hi = norms
    X = _sigmoid(np.asarray(X, np.float64), med, iqr)
    X = (X - lo) / ((hi - lo) or 1.0)
    if rescue:
        X = X.copy()
        for i in range(X.shape[0]):
            ts = X[i]
            if ts.min() < 0:
                ts -= ts.min()
            if ts.max() > 1:
                ts /= ts.max()
    a, b = enc_range
    return (b - a) * X + a


# ---- encodings (bases.jl:23-108) ------------------------------------------

def legendre_features(x: torch.Tensor, d: int) -> torch.Tensor:
    """The first d normalised Legendre polynomials sqrt((2l+1)/2) P_l(x)."""
    ps = [torch.ones_like(x), x]
    for l in range(1, d - 1):
        ps.append(((2 * l + 1) * x * ps[l] - l * ps[l - 1]) / (l + 1))
    return torch.stack([p * math.sqrt((2 * l + 1) / 2.0)
                        for l, p in enumerate(ps[:d])], dim=-1)


def fourier_features(x: torch.Tensor, d: int) -> torch.Tensor:
    """e^{i pi f x} / sqrt(d) over the frequencies 0, 1, -1, 2, -2, ..."""
    freqs = [0.0]
    for k in range(1, d):
        freqs += [float(k), float(-k)]
    f = torch.tensor(freqs[:d], dtype=x.dtype, device=x.device)
    th = math.pi * x[..., None] * f
    return torch.complex(torch.cos(th), torch.sin(th)) / math.sqrt(d)


FEATURES = {"legendre_no_norm": (legendre_features, (-1.0, 1.0)),
            "fourier": (fourier_features, (-1.0, 1.0))}


def encode(X_scaled: np.ndarray, encoding: str, d: int, device,
           rnd: Rnd = exact) -> torch.Tensor:
    """[N, T] scaled series -> [N, T, d] product states in float64
    (complex128 for a complex basis)."""
    feats = FEATURES[encoding][0]
    x = torch.as_tensor(np.asarray(X_scaled, np.float64), device=device)
    return rnd(feats(x, d))


def class_sort(X: np.ndarray, y: np.ndarray):
    """(X, class index, labels) in the stable class-sorted order."""
    labels = np.unique(y)
    idx = np.searchsorted(labels, y)
    order = np.argsort(idx, kind="stable")
    return X[order], idx[order], labels


# ---- the initial state (RealRealHighDimension.jl:1-41) ---------------------

def random_mps(seed: int, T: int, d: int, C: int, chi_init: int,
               chi_max: int, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """The seeded random MPS, left-orthogonal up to the last site, which
    carries the label axis, computed in the configuration's dtype; (cores
    [T, chi, d, chi], center [chi, d, chi, C])."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)

    def randn(*shape):
        x = rng.standard_normal(shape)
        if dtype.kind == "c":
            x = x + 1j * rng.standard_normal(shape)
        return x.astype(dtype)

    dims = [1] + [int(min(chi_init, d ** t, d ** (T - t)))
                  for t in range(1, T)] + [1]
    sites = [randn(dims[t], d, dims[t + 1]) for t in range(T)]
    label = randn(dims[T - 1], d, 1, C)
    for t in range(T - 1):
        a, _, b = sites[t].shape
        Q, R = np.linalg.qr(sites[t].reshape(a * d, b))
        k = Q.shape[1]
        Q = Q.reshape(a, d, k)
        sites[t] = Q[:, :, :b] if k >= b else np.pad(
            Q, ((0, 0), (0, 0), (0, b - k)))
        R = R if k >= b else np.pad(R, ((0, b - k), (0, 0)))
        if np.linalg.norm(R) > 0:
            R = R / np.linalg.norm(R)
        if t + 1 < T - 1:
            sites[t + 1] = np.einsum("ab,bic->aic", R[:b], sites[t + 1])
        else:
            label = np.einsum("ab,bicl->aicl", R[:b], label)
    label = label / np.linalg.norm(label)
    cores = np.zeros((T, chi_max, d, chi_max), dtype)
    for t in range(T - 1):
        A = sites[t]
        cores[t, :A.shape[0], :, :A.shape[2]] = A
    center = np.zeros((chi_max, d, chi_max, C), dtype)
    center[:label.shape[0], :, :1, :] = label
    return cores, center


def cold_subspace(n: int, keep: int, dtype) -> np.ndarray:
    """The warm split's cold-start basis [n, keep]: the Q of a fixed
    Gaussian draw (seed 20240817) in the configuration's dtype."""
    k = min(keep, n)
    rng = np.random.default_rng(20240817)
    Psi = rng.standard_normal((n, k))
    if np.dtype(dtype).kind == "c":
        Psi = Psi + 1j * rng.standard_normal((n, k))
    Q = np.linalg.qr(Psi.astype(dtype))[0]
    return np.pad(Q, ((0, 0), (0, keep - k))) if keep > k else Q


# ---- one bond -------------------------------------------------------------

def _norm(x):
    return torch.linalg.vector_norm(x)


def env_step(v, ls, core, phi_c, left: bool, rnd: Rnd):
    """Advance a per-sample environment [N, chi] by one site (conjugated
    features phi_c [N, d]) and renormalise it, adding the log of the norm
    to ls [N]."""
    if left:
        v = torch.einsum("nib,ni->nb", torch.einsum("na,aib->nib", v, core),
                         phi_c)
    else:
        v = torch.einsum("nai,ni->na", torch.einsum("aib,nb->nai", core, v),
                         phi_c)
    nrm = torch.linalg.vector_norm(v, dim=1, keepdim=True)
    nrm = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    return rnd(v / nrm), ls + torch.log(nrm[:, 0]).real


def kld_step(BT, le, re, phil_c, phir_c, y1h, w, eta, rnd: Rnd):
    """The KLD gradient of the bond tensor BT [chi, d, d, chi, C] over the
    batch, one TSGO step of length eta, then renormalisation."""
    chi, d, _, _, C = BT.shape
    N = le.shape[0]
    L = (le[:, :, None] * phil_c.conj()[:, None, :]).reshape(N, chi * d)
    R = (phir_c.conj()[:, :, None] * re[:, None, :]).reshape(N, d * chi)
    M = BT.reshape(chi * d, d * chi, C)
    yhat = rnd(torch.einsum("nyc,ny->nc",
                            torch.einsum("nx,xyc->nyc", L.conj(), M),
                            R.conj()))
    y_true = torch.sum(yhat * y1h.to(yhat.dtype), dim=1)
    W = y1h.to(BT.dtype) * (w / y_true.conj()).to(BT.dtype)[:, None]
    G = rnd(-torch.einsum("nx,nyc->xyc", L,
                          R[:, :, None] * W[:, None, :]).reshape(BT.shape))
    BT = rnd(BT - eta * (G / _norm(G)))
    return rnd(BT / _norm(BT))


def ns_orth(Y, rnd: Rnd):
    """Newton-Schulz polar: an orthonormal basis of span(Y), 8 quintic then
    6 cubic steps from Y scaled just under unit norm."""
    X = rnd(Y / torch.clamp(_norm(Y) * (1.0 + 1e-3),
                            min=torch.finfo(Y.real.dtype).tiny))
    eye = torch.eye(Y.shape[1], dtype=Y.dtype, device=Y.device)
    for _ in range(8):
        G = rnd(X.conj().T @ X)
        X = rnd(X @ (3.4445 * eye - 4.7750 * G + 2.0315 * rnd(G @ G)))
    for _ in range(6):
        X = rnd(1.5 * X - 0.5 * (X @ rnd(X.conj().T @ X)))
    return X


def _colnorm(Z):
    return Z / torch.clamp(torch.linalg.vector_norm(Z, dim=0, keepdim=True),
                           min=torch.finfo(Z.real.dtype).tiny)


def power_basis(gram_apply, Y, q: int, rnd: Rnd):
    """q subspace-iteration steps from the cached basis Y: each step applies
    the Gram, normalises the columns, revives the old basis by 1e-3 and
    orthonormalises by Newton-Schulz."""
    for _ in range(q):
        Y = ns_orth(rnd(_colnorm(rnd(gram_apply(Y)))) + 1e-3 * Y, rnd)
    return Y


def keep_mask(w: torch.Tensor, keep: int, cutoff: float) -> torch.Tensor:
    """Keep a direction iff its rank in the stable descending order of the
    energies w is below keep, its energy is positive, and the energy from it
    down exceeds cutoff times the total (ITensor's relative cutoff)."""
    order = torch.argsort(-w, stable=True)
    ws = torch.clamp(w[order], min=0.0)
    suffix = torch.sum(ws) - (torch.cumsum(ws, 0) - ws)
    idx = torch.arange(ws.shape[0], device=w.device)
    m = ((suffix > cutoff * torch.sum(ws)) & (idx < keep) & (ws > 0))
    out = torch.zeros_like(w)
    out[order] = m.to(w.dtype)
    return out


# ---- one bond step ---------------------------------------------------------

def boundary(N: int, chi: int, dtype, device) -> torch.Tensor:
    v = torch.zeros((N, chi), dtype=dtype, device=device)
    v[:, 0] = 1.0
    return v


def bond_tensor(A, center_c, le, re, phil_c, phir_c, y1h, w, *,
                forward: bool, eta: float, rnd: Rnd = exact):
    """The bond tensor [chi, d, d, chi, C] of the static core A [chi, d,
    chi] and the class-major center [C, chi, d, chi] (A on the right going
    forward, on the left going backward) after a KLD/TSGO step over the
    batch (environments le, re [N, chi]; conjugated features phil_c,
    phir_c [N, d])."""
    if forward:
        BT = rnd(torch.einsum("caim,mkb->aikbc", center_c, A))
    else:
        BT = rnd(torch.einsum("aim,cmkb->aikbc", A, center_c))
    return kld_step(BT, le, re, phil_c, phir_c, y1h, w, eta, rnd)


def _split_matrix(BT, forward: bool):
    """The matrix a split factors: the emitted core's side by the rest."""
    chi, d, _, _, C = BT.shape
    if forward:
        return BT.reshape(chi * d, d * chi * C)
    return BT.permute(0, 1, 4, 2, 3).reshape(chi * d * C, d * chi)


def split(BT, V0, *, forward: bool, cutoff: float, q: int,
          rnd: Rnd = exact):
    """q power steps from the cached basis V0 [chi*d, chi], and the split
    of the bond tensor BT against it.  Returns (center_c', core', Q'): the
    center moved one site on, the emitted core and the basis the next
    sweep starts from."""
    chi, d, C = BT.shape[0], BT.shape[1], BT.shape[4]
    M = _split_matrix(BT, forward)
    if forward:
        Q = power_basis(lambda Y: M @ (M.conj().T @ Y), V0, q, rnd)
        B = rnd(Q.conj().T @ M)
        m = keep_mask(torch.sum(B.abs() ** 2, dim=1), chi, cutoff)
        return ((B * m[:, None]).reshape(chi, d, chi, C).permute(3, 0, 1, 2),
                (Q * m).reshape(chi, d, chi), Q)
    Q = power_basis(lambda Y: M.conj().T @ (M @ Y), V0, q, rnd)
    B = rnd(M @ Q)
    m = keep_mask(torch.sum(B.abs() ** 2, dim=0), chi, cutoff)
    return ((B * m).reshape(chi, d, C, chi).permute(2, 0, 1, 3),
            (Q.conj().T * m[:, None]).reshape(chi, d, chi), Q)


def project(BT, core, forward: bool):
    """The center that an emitted core [chi, d, chi] leaves of the bond
    tensor BT: BT projected on the core's columns (forward) or rows
    (backward), as ``split`` makes its center under its own core."""
    chi, d, C = BT.shape[0], BT.shape[1], BT.shape[4]
    M = _split_matrix(BT, forward)
    if forward:
        B = core.reshape(chi * d, chi).conj().T @ M
        return B.reshape(chi, d, chi, C).permute(3, 0, 1, 2)
    B = M @ core.reshape(chi, d * chi).conj().T
    return B.reshape(chi, d, C, chi).permute(2, 0, 1, 3)


def left_envs(cores, phis_c, upto: int, rnd: Rnd = exact):
    """[LE_0 .. LE_upto]: LE_t the environment of sites 0..t-1, phis_c [T,
    N, d]."""
    N, chi = phis_c.shape[1], cores.shape[1]
    v = boundary(N, chi, cores.dtype, cores.device)
    ls = torch.zeros(N, dtype=phis_c.real.dtype, device=cores.device)
    out = [v]
    for t in range(upto):
        v, ls = env_step(v, ls, cores[t], phis_c[t], True, rnd)
        out.append(v)
    return out


def right_envs(cores, phis_c, downto: int, rnd: Rnd = exact):
    """{t: RE_t} for t = T..downto: RE_t the environment of sites t..T-1."""
    T, N, chi = cores.shape[0], phis_c.shape[1], cores.shape[1]
    v = boundary(N, chi, cores.dtype, cores.device)
    ls = torch.zeros(N, dtype=phis_c.real.dtype, device=cores.device)
    out = {T: v}
    for t in range(T - 1, downto - 1, -1):
        v, ls = env_step(v, ls, cores[t], phis_c[t], False, rnd)
        out[t] = v
    return out


# ---- reading a state ------------------------------------------------------

def site_run(center_c, cores, center_first: bool):
    """A run of sites as [class, chi, d, chi] tensors: the class-major
    center [C, chi, d, chi] first or last, the cores [n, chi, d, chi] with a
    class axis of one."""
    rest = [c[None] for c in cores]
    return [center_c] + rest if center_first else rest + [center_c]


def segment_inner(x: list, y: list) -> complex:
    """<x|y> of two runs of sites over the same sites, their open end bonds
    and the class index summed (the class may sit at a different site in
    each run)."""
    chi = x[0].shape[1]
    E = torch.eye(chi, dtype=y[0].dtype, device=y[0].device)[None, None]
    for X, Y in zip(x, y):
        E = torch.einsum("xyaA,paib,qAiB->xpyqbB", E, X.conj(), Y)
        s = E.shape
        E = E.reshape(s[0] * s[1], s[2] * s[3], s[4], s[5])
    return complex(torch.einsum("ccbb->", E))


def segment_distance(x: list, y: list) -> float:
    """||x - y|| of two runs of sites, whatever their gauge."""
    d2 = (segment_inner(x, x).real + segment_inner(y, y).real
          - 2.0 * segment_inner(x, y).real)
    return math.sqrt(max(d2, 0.0))


def _amplitudes(cores, center, phis_c, rnd: Rnd):
    """(y [N, C] scaled, log-scales [N]) of a state, the center at site T-1,
    over conjugated product states phis_c [N, T, d]."""
    T, chi = cores.shape[0], cores.shape[1]
    N = phis_c.shape[0]
    v = boundary(N, chi, cores.dtype, cores.device)
    ls = torch.zeros(N, dtype=phis_c.real.dtype, device=cores.device)
    for t in range(T - 1):
        v, ls = env_step(v, ls, cores[t], phis_c[:, t], True, rnd)
    y = torch.einsum("nbc,nb->nc", torch.einsum(
        "nibc,ni->nbc", torch.einsum("na,aibc->nibc", v, center),
        phis_c[:, T - 1]), boundary(N, chi, cores.dtype, cores.device))
    return y, ls


def class_scores(cores, center, phis, rnd: Rnd = exact) -> torch.Tensor:
    """|<state_c|phi_n>|^2 normalised over the classes, [N, C], for product
    states phis [N, T, d], the center at site T-1."""
    y, _ = _amplitudes(cores, center, phis.conj(), rnd)
    p = y.abs() ** 2
    return p / p.sum(dim=1, keepdim=True)

"""Entanglement-entropy analysis (counterpart of
``mpstime_tpu/analysis/analyse.py``; reference src/Analysis/analyse.jl), in
plain PyTorch on the trained model's device.

 * Bipartite entropies come from ONE right-to-left RQ sweep then ONE
   left-to-right QR sweep (a Python loop over the sites), not the
   reference's per-site re-orthogonalization loop (analyse.jl:27-44):
   O(T chi^3) total.  The bond Grams' and the single-site RDMs' spectra are
   one batched eigvalsh each.
 * ``see_variation`` replaces the reference's per-prefix ``precondition`` +
   re-orthogonalize (analyse.jl:180-193) with trace-metric environments;
   the measured-prefix length k rides a leading tensor axis (left
   environments [T, chi, chi], the project-or-trace choice a [T] mask of
   t < k), so the loop runs over the sites only: conditioning on sites < k
   is a rank-1 (projected) transfer step, tracing is the full transfer
   step, and the SEE at site j is the spectrum of
   E_k[j] . W[j] . R[j+1] . W[j]^H normalized.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..models.mps import SingleMPS, expand_label_index
from ..training.fit import TrainedMPS

_LOGFNS = {"log": np.log, "log2": np.log2, "log10": np.log10}


def _log_base_factor(logfn: str) -> float:
    if logfn not in _LOGFNS:
        raise ValueError("logfn must be one of: log, log2, log10")
    return {"log": 1.0, "log2": 1.0 / math.log(2), "log10": 1.0 / math.log(10)}[logfn]


def _entropy_from_p(p: np.ndarray, factor: float, tol: float = 1e-12) -> np.ndarray:
    """-sum p log p over the last axis, ignoring p <= tol (analyse.jl:36-41)."""
    p = np.where(p > tol, p, 1.0)   # log(1) = 0 contribution
    return -np.sum(p * np.log(p), axis=-1) * factor


#: Matrices per batched eigvalsh call: cuSOLVER's batched eigensolver
#: refuses 32768 matrices of 5 x 5 and more (CUSOLVER_STATUS_INVALID_VALUE;
#: 16384 pass; NVIDIA H100, torch 2.11 + CUDA 12.8), and see_variation
#: hands it n x T x T of them.
EIGH_BATCH = 16384


def _eigvalsh_desc(H: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of a batch of hermitian matrices, descending, as the real
    dtype of H.  Single precision on the CPU is solved in double (MKL's
    float32 eigensolver fails on mostly-zero Grams, ops/decomp._eigh_desc)."""
    wide = {torch.float32: torch.float64, torch.complex64: torch.complex128}
    Hs = H.to(wide[H.dtype]) if H.device.type == "cpu" and H.dtype in wide \
        else H
    flat = Hs.reshape((-1,) + Hs.shape[-2:])
    w = torch.cat([torch.linalg.eigvalsh(c) for c in flat.split(EIGH_BATCH)])
    return torch.flip(w.reshape(Hs.shape[:-1]), (-1,)).to(H.real.dtype)


def _canonical_sweep_spectra(cores_full: torch.Tensor):
    """One right-to-left RQ sweep, then one left-to-right QR sweep: returns
    (bond_p [T, chi], site_rho [T, d, d]).

    bond_p[t] = squared singular values across the bond (t | t+1);
    site_rho[t] = single-site RDM at site t.  Assumes the MPS is normalized."""
    T, chi, d, _ = cores_full.shape
    dtype = cores_full.dtype

    # move the center to site 0 first (right-canonicalize via LQ from the end)
    R = torch.eye(chi, dtype=dtype, device=cores_full.device)
    right_cores = [None] * T
    for t in range(T - 1, -1, -1):
        # core [chi,d,chi]; absorb R from the right: C = core . R
        C = torch.einsum("aib,bc->aic", cores_full[t], R)
        M = C.reshape(chi, d * chi)
        # LQ via reduced QR of M^H: M = L Q with Q [chi, d*chi] row-orthonormal
        Q, Rh = torch.linalg.qr(M.conj().T)
        right_cores[t] = Q.conj().T.reshape(chi, d, chi)
        R = Rh.conj().T
    # the center at site 0: R absorbed into the leftmost core
    C = torch.einsum("ab,bic->aic", R, right_cores[0])

    grams, rhos = [], []
    for t in range(T):
        # bond spectrum at cut (t | t+1): Gram of M [chi*d, chi]
        M = C.reshape(chi * d, chi)
        grams.append(M.conj().T @ M)
        # single-site rho at t: trace out both bonds of the center
        rhos.append(torch.einsum("aib,ajb->ij", C, C.conj()))
        if t + 1 < T:
            # QR split; absorb R into the next core
            _, Rq = torch.linalg.qr(M)
            C = torch.einsum("ab,bic->aic", Rq, right_cores[t + 1])
    bond_p = _eigvalsh_desc(torch.stack(grams))
    return bond_p, torch.stack(rhos)


def _host64(t: torch.Tensor) -> np.ndarray:
    a = t.cpu().numpy()
    return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)


def von_neumann_entropy(m: SingleMPS, logfn: str = "log") -> np.ndarray:
    """Bipartite entanglement entropy at each bond (reference
    von_neumann_entropy, analyse.jl:20-45).  entropy[t] is the entropy of the
    cut between sites 0..t and t+1..T-1 (entropy[T-1] = 0)."""
    factor = _log_base_factor(logfn)
    bond_p, _ = _canonical_sweep_spectra(m.folded_cores())
    return _entropy_from_p(_host64(bond_p), factor)


def bipartite_spectrum(mps: TrainedMPS, logfn: str = "log") -> List[np.ndarray]:
    """Per-class bipartite entanglement entropy (reference analyse.jl:57-67)."""
    _log_base_factor(logfn)
    return [von_neumann_entropy(m, logfn) for m in expand_label_index(mps.mps)]


def rho_correct(rho: np.ndarray, eigentol: Optional[float] = None) -> np.ndarray:
    """Clamp tiny negative RDM eigenvalues; DomainError-equivalent otherwise
    (reference rho_correct, analyse.jl:69-91).  Host numpy."""
    rho = np.asarray(rho)
    if eigentol is None:
        eigentol = math.sqrt(np.finfo(np.float64).eps)
    w, V = np.linalg.eigh(rho)
    if (w >= 0).all():
        return rho
    oot = w[w < -eigentol]
    if oot.size:
        raise ValueError(
            f"RDM contains large negative eigenvalues outside of the tolerance "
            f"{eigentol}: lambda = {oot}")
    w = np.clip(w, eigentol, None)
    rho_c = (V * w) @ V.conj().T
    if not np.isclose(np.trace(rho_c).real, 1.0, atol=0.01):
        raise ValueError(f"Tr(rho_corrected) != 1.0 ({np.trace(rho_c)})")
    return rho_c


def one_site_rdm(m: SingleMPS, site: int) -> np.ndarray:
    """Single-site RDM at ``site`` (reference one_site_rdm, analyse.jl:102-109)."""
    _, site_rho = _canonical_sweep_spectra(m.folded_cores())
    return rho_correct(site_rho[site].cpu().numpy())


def single_site_entropy(m: SingleMPS, eigentol: Optional[float] = None
                        ) -> np.ndarray:
    """SEE(t) = -tr(rho_t log rho_t) for every site (reference
    single_site_entropy, analyse.jl:111-120)."""
    if eigentol is None:
        eigentol = math.sqrt(np.finfo(np.float64).eps)
    _, site_rho = _canonical_sweep_spectra(m.folded_cores())
    w = _host64(_eigvalsh_desc(site_rho))
    if (w < -eigentol).any():
        raise ValueError("RDM contains large negative eigenvalues outside of "
                         f"the tolerance {eigentol}")
    return _entropy_from_p(np.clip(w, 0.0, None), 1.0)


def single_site_spectrum(mps: TrainedMPS) -> List[np.ndarray]:
    """Per-class single-site entanglement entropy spectrum
    (reference single_site_spectrum, analyse.jl:141-149)."""
    return [single_site_entropy(m) for m in expand_label_index(mps.mps)]


# ---------------------------------------------------------------------------
# SEE variation under incremental measurement


def _see_variation_spectra(cores_full: torch.Tensor,
                           phis_c: torch.Tensor) -> torch.Tensor:
    """For every instance n, measured-prefix length k (0..T-1) and probe site
    j, the single-site RDM spectrum of the MPS conditioned on the n-th
    instance's sites < k.

    cores_full [T,chi,d,chi] (normalized class MPS, center folded);
    phis_c [n,T,d]: conj'd encoded measurement outcomes.
    Returns p [n, T(k), T(j), d], descending (entries with j < k are
    garbage — mask outside)."""
    T, chi, d, _ = cores_full.shape
    n = phis_c.shape[0]
    dtype = cores_full.dtype
    tiny = 1e-300 if phis_c.real.dtype == torch.float64 else 1e-30
    dev = cores_full.device

    def normalised(X):
        tr = torch.clamp(torch.diagonal(X, dim1=-2, dim2=-1).sum(-1).real,
                         min=tiny)
        return X / tr[..., None, None].to(dtype)

    # right trace environments R[t] (shared across k and instances)
    e0 = torch.zeros((chi,), dtype=dtype, device=dev)
    e0[0] = 1.0
    R = torch.outer(e0, e0.conj())
    R_env = [None] * (T + 1)
    R_env[T] = R
    for t in range(T - 1, -1, -1):
        W = cores_full[t]
        R = normalised(torch.einsum("aib,bd,cid->ac", W, R, W.conj()))
        R_env[t] = R

    # left environments E[n, k]: projected for t < k, traced for k <= t
    E = torch.outer(e0, e0.conj()).expand(n, T, chi, chi)
    ks = torch.arange(T, device=dev)
    rhos = []
    for t in range(T):
        W = cores_full[t]
        # rho_j candidate at this site (before stepping), for every (n, k)
        WRW = torch.einsum("aib,bd,cjd->aicj", W, R_env[t + 1], W.conj())
        rhos.append(normalised(torch.einsum("nkac,aicj->nkij", E, WRW)))
        # step: project if t < k else trace
        w_proj = torch.einsum("aib,ni->nab", W, phis_c[:, t])
        E_proj = torch.einsum("nab,nkac,ncd->nkbd", w_proj, E, w_proj.conj())
        E_trace = torch.einsum("aib,nkac,cid->nkbd", W, E, W.conj())
        E = normalised(torch.where((t < ks)[None, :, None, None], E_proj,
                                   E_trace))
    rho = torch.stack(rhos, dim=2)                      # [n, T(k), T(j), d, d]
    return _eigvalsh_desc(rho)


def see_variation(mps: TrainedMPS, measure_series: np.ndarray,
                  class_label=None) -> np.ndarray:
    """SEE at each probe site after measuring the first k sites
    (reference see_variation, analyse.jl:168-194).

    Returns [n_instances, T, T]: out[i, k, j] is the SEE at site j of the
    class MPS conditioned on the first k measured values of instance i
    (out[i, 0, :] is the unmeasured baseline); entries with j < k are 0.
    """
    from ..encodings.pipeline import encode_rows
    from ..utils.preprocessing import transform_test_data

    measure_series = np.atleast_2d(np.asarray(measure_series, dtype=np.float64))
    if class_label is None:
        class_label = mps.labels[0]
    ci = int(np.where(mps.labels == class_label)[0][0])
    m = expand_label_index(mps.mps)[ci]
    T = m.T
    opts = mps.opts

    X_scaled, _ = transform_test_data(measure_series, mps.norms, opts)
    phis = encode_rows(X_scaled, opts, mps.train_data.enc_args,
                       spec=mps.encoding_spec(), class_idx=ci,
                       dtype=mps.mps.dtype, device=mps.mps.device)
    p = _host64(_see_variation_spectra(m.folded_cores(), phis.conj()))
    ent = _entropy_from_p(np.clip(p, 0.0, None), 1.0)      # [n, T, T]
    # zero out j < k (measured sites have no remaining entropy)
    k_idx, j_idx = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
    return np.where(j_idx >= k_idx, ent, 0.0)

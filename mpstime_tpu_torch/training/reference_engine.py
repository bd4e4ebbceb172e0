"""Naive per-sample reference implementation of the DMRG training sweep
(a copy of ``mpstime_tpu/training/reference_engine.py``).

Plays the role of the reference's legacy ITensor engine (src/legacy_itensor/,
``fitMPS_IT``): an independent, slow, readable implementation used to
cross-check the batched engine (the reference asserts the two engines
agree, test/classification.jl:10-24).  Pure numpy, float64, ragged (true)
bond dimensions, per-sample loops — deliberately nothing shared with the
fast path beyond the encoded inputs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _truncate_svd(M: np.ndarray, chi_max: int, cutoff: float):
    U, S, Vh = np.linalg.svd(M, full_matrices=False)
    p = S ** 2
    total = p.sum()
    if total > 0:
        suffix = np.cumsum(p[::-1])[::-1]
        keep = (suffix > cutoff * total) & (np.arange(len(S)) < chi_max)
    else:
        keep = np.arange(len(S)) < 1
    r = max(int(keep.sum()), 1)
    return U[:, :r], S[:r], Vh[:r]


class NaiveMPS:
    """Ragged-bond-dimension MPS; sites[t]: [chi_l, d, chi_r], label axis kept
    on the ``center`` site as [chi_l, d, chi_r, C]."""

    def __init__(self, sites: List[np.ndarray], center: np.ndarray,
                 center_pos: int):
        self.sites = sites
        self.center = center
        self.center_pos = center_pos

    @property
    def T(self):
        return len(self.sites)


def naive_random_mps(seed: int, T: int, d: int, C: int, chi_init: int
                     ) -> NaiveMPS:
    rng = np.random.default_rng(seed)
    dims = [1] + [min(chi_init, d ** t, d ** (T - t)) for t in range(1, T)] + [1]
    sites = [rng.standard_normal((dims[t], d, dims[t + 1])) for t in range(T)]
    center = rng.standard_normal((dims[T - 1], d, 1, C))
    # left-orthogonalize 0..T-2
    for t in range(T - 1):
        chi_l, _, chi_r = sites[t].shape
        Q, R = np.linalg.qr(sites[t].reshape(chi_l * d, chi_r))
        R /= np.linalg.norm(R)
        sites[t] = Q.reshape(chi_l, d, Q.shape[1])
        if t + 1 < T - 1:
            sites[t + 1] = np.einsum("ab,bic->aic", R, sites[t + 1])
        else:
            center = np.einsum("ab,bicl->aicl", R, center)
    center /= np.linalg.norm(center)
    sites[T - 1] = None
    return NaiveMPS(sites, center, T - 1)


def _envs_left(mps: NaiveMPS, phis: np.ndarray) -> list:
    """LE[t][n]: contraction of sites 0..t-1 (conj'd states)."""
    N = phis.shape[0]
    LE = [np.ones((N, 1))]
    for t in range(mps.T - 1):
        A = mps.sites[t]
        LE.append(np.einsum("na,ni,aib->nb", LE[t], np.conj(phis[:, t]), A))
    return LE


def _kld_loss_grad(BT, le, re, pl, pr, y_idx, weights):
    """loss, grad for one bond (naive): yhat_n = <BT[..., y_n], conj(P_n)>."""
    N = le.shape[0]
    grad = np.zeros_like(BT)
    loss = 0.0
    for n in range(N):
        P = np.einsum("a,i,k,b->aikb", le[n], pl[n], pr[n], re[n])
        yh = np.sum(BT[..., y_idx[n]] * np.conj(P))
        loss += weights[n] * -np.log(abs(yh) ** 2)
        grad[..., y_idx[n]] += -weights[n] * np.real(P / np.conj(yh)) if \
            not np.iscomplexobj(BT) else -weights[n] * (P / np.conj(yh))
    return loss, grad


def naive_fit_mps(X_enc: np.ndarray, y_idx: np.ndarray, C: int, *,
                  nsweeps: int = 10, chi_max: int = 25, chi_init: int = 4,
                  eta: float = 0.01, cutoff: float = 1e-10, seed: int = 1234,
                  bbopt: str = "TSGO", update_iters: int = 1,
                  train_separate: bool = False) -> NaiveMPS:
    """Train on pre-encoded states X_enc [N, T, d] (numpy).  Mirrors the fast
    engine's semantics (TSGO/GD + KLD + rescale-after + truncated SVD) with
    per-sample loops and true ragged bond dimensions."""
    X_enc = np.asarray(X_enc)
    N, T, d = X_enc.shape
    mps = naive_random_mps(seed, T, d, C, chi_init)
    counts = np.bincount(y_idx, minlength=C).astype(float)
    weights = (1.0 / counts[y_idx]) if train_separate else np.full(N, 1.0 / N)

    def env_norm(v):
        out = np.linalg.norm(v, axis=1, keepdims=True)
        out[out == 0] = 1.0
        return v / out

    for sweep in range(nsweeps):
        # ---- backward ----
        LE = [env_norm(e) for e in _envs_left(mps, X_enc)]
        RE = {T: np.ones((N, 1))}
        for j in range(T - 2, -1, -1):
            A = mps.sites[j]
            BT = np.einsum("aim,mkbc->aikbc", A, mps.center)
            for _ in range(update_iters):
                loss, g = _kld_loss_grad(BT, LE[j], RE[j + 2],
                                         X_enc[:, j], X_enc[:, j + 1],
                                         y_idx, weights)
                if bbopt == "TSGO":
                    g = g / np.linalg.norm(g)
                BT = BT - eta * g
            BT /= np.linalg.norm(BT)
            chi_l = BT.shape[0]
            chi_r = BT.shape[3]
            M = BT.transpose(0, 1, 4, 2, 3).reshape(chi_l * d * C, d * chi_r)
            U, S, Vh = _truncate_svd(M, chi_max, cutoff)
            r = len(S)
            mps.center = (U * S).reshape(chi_l, d, C, r).transpose(0, 1, 3, 2)
            mps.center_pos = j
            V = Vh.reshape(r, d, chi_r)
            mps.sites[j + 1] = V
            mps.sites[j] = None
            RE[j + 1] = env_norm(np.einsum("aib,ni,nb->na", V,
                                           np.conj(X_enc[:, j + 1]), RE[j + 2]))
        # ---- forward ----
        RE = {T: np.ones((N, 1))}
        for t in range(T - 1, 0, -1):
            RE[t] = env_norm(np.einsum("aib,ni,nb->na", mps.sites[t],
                                       np.conj(X_enc[:, t]), RE[t + 1]))
        LEd = {0: np.ones((N, 1))}
        for j in range(T - 1):
            B = mps.sites[j + 1]
            BT = np.einsum("aimc,mkb->aikbc", mps.center, B)
            for _ in range(update_iters):
                loss, g = _kld_loss_grad(BT, LEd[j], RE[j + 2],
                                         X_enc[:, j], X_enc[:, j + 1],
                                         y_idx, weights)
                if bbopt == "TSGO":
                    g = g / np.linalg.norm(g)
                BT = BT - eta * g
            BT /= np.linalg.norm(BT)
            chi_l = BT.shape[0]
            chi_r = BT.shape[3]
            M = BT.reshape(chi_l * d, d * chi_r * C)
            U, S, Vh = _truncate_svd(M, chi_max, cutoff)
            r = len(S)
            Unew = U.reshape(chi_l, d, r)
            mps.sites[j] = Unew
            mps.center = (S[:, None] * Vh).reshape(r, d, chi_r, C)
            mps.center_pos = j + 1
            mps.sites[j + 1] = None
            LEd[j + 1] = env_norm(np.einsum("na,ni,aib->nb", LEd[j],
                                            np.conj(X_enc[:, j]), Unew))
    mps.center /= np.linalg.norm(mps.center)
    return mps


def naive_predict(mps: NaiveMPS, X_enc: np.ndarray) -> np.ndarray:
    """argmax_c |<psi_c | conj(phi)>| class indices."""
    N = X_enc.shape[0]
    preds = np.empty(N, dtype=np.int64)
    for n in range(N):
        v = np.ones((1,))
        for t in range(mps.T):
            if t == mps.center_pos:
                out = np.einsum("a,aibc,i->bc", v, mps.center,
                                np.conj(X_enc[n, t]))
                v = None
                vc = out
            else:
                site = mps.sites[t]
                if v is not None:
                    v = np.einsum("a,aib,i->b", v, site, np.conj(X_enc[n, t]))
                    nv = np.linalg.norm(v)
                    v = v / nv if nv > 0 else v
                else:
                    vc = np.einsum("bc,bia,i->ac", vc, site,
                                   np.conj(X_enc[n, t]))
                    nv = np.linalg.norm(vc)
                    vc = vc / nv if nv > 0 else vc
        preds[n] = int(np.argmax(np.abs(vc[0] if vc.ndim == 2 else vc)))
    return preds

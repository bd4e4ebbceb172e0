"""Label-indexed Matrix Product State with fixed (padded) shapes
(counterpart of ``mpstime_tpu/models/mps.py``).

  * ``cores``:  [T, chi, d, chi] site tensors, padded to chi = chi_max; the
                slot at ``center_pos`` is unused.
  * ``center``: [chi, d, chi, C] the orthogonality-center site tensor
                carrying the class axis C.

Sites left of ``center_pos`` are left-orthogonal and sites right of it
right-orthogonal, so ``norm(mps) == norm(center)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..ops.env import boundary_env, env_step_left_scaled, env_step_right_scaled


@dataclass
class MPS:
    cores: torch.Tensor       # [T, chi, d, chi]
    center: torch.Tensor      # [chi, d, chi, C]
    center_pos: int

    @property
    def T(self) -> int:
        return self.cores.shape[0]

    @property
    def chi(self) -> int:
        return self.cores.shape[1]

    @property
    def d(self) -> int:
        return self.cores.shape[2]

    @property
    def num_classes(self) -> int:
        return self.center.shape[3]

    @property
    def dtype(self) -> torch.dtype:
        return self.cores.dtype

    @property
    def device(self) -> torch.device:
        return self.cores.device

    def norm(self) -> torch.Tensor:
        return torch.linalg.vector_norm(self.center)

    def normalize(self) -> "MPS":
        return MPS(self.cores, self.center / self.norm(), self.center_pos)

    @classmethod
    def from_numpy(cls, cores: np.ndarray, center: np.ndarray,
                   center_pos: int, device="cpu") -> "MPS":
        """Weight converter: an MPS from host arrays in the JAX package's
        layouts (``np.asarray(jax_mps.cores)``, ``np.asarray(jax_mps.center)``),
        so both packages compute on the same parameters."""
        cores = np.array(cores)          # a writable copy
        center = np.array(center)
        if cores.ndim != 4 or center.ndim != 4:
            raise ValueError(f"cores must be [T, chi, d, chi] and center "
                             f"[chi, d, chi, C]; got {cores.shape} and "
                             f"{center.shape}")
        if center.shape[:3] != cores.shape[1:]:
            raise ValueError(f"center {center.shape} does not match cores "
                             f"{cores.shape}")
        return cls(torch.from_numpy(cores).to(device),
                   torch.from_numpy(center).to(device), int(center_pos))


def random_mps(seed: int, T: int, d: int, num_classes: int, chi_init: int,
               chi_max: int, dtype=np.float32, device="cpu") -> MPS:
    """Seeded random MPS, left-orthogonal up to the last site, which carries
    the label axis (reference RealRealHighDimension.jl:1-41).  Host numpy,
    line for line the JAX package's ``random_mps`` (mps.py:87), so both
    packages start from bit-identical cores."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    is_complex = dtype.kind == "c"

    def randn(*shape):
        x = rng.standard_normal(shape)
        if is_complex:
            x = x + 1j * rng.standard_normal(shape)
        return x.astype(dtype)

    dims = [1]
    for t in range(1, T):
        dims.append(int(min(chi_init, d ** t, d ** (T - t))))
    dims.append(1)

    site_tensors = [randn(dims[t], d, dims[t + 1]) for t in range(T)]
    label_site = randn(dims[T - 1], d, 1, num_classes)

    for t in range(T - 1):
        A = site_tensors[t]
        chi_l, _, chi_r = A.shape
        M = A.reshape(chi_l * d, chi_r)
        Q, R = np.linalg.qr(M)
        k = Q.shape[1]
        site_tensors[t] = Q.reshape(chi_l, d, k)[:, :, :chi_r] if k >= chi_r \
            else np.pad(Q.reshape(chi_l, d, k), ((0, 0), (0, 0), (0, chi_r - k)))
        Rfull = R if k >= chi_r else np.pad(R, ((0, chi_r - k), (0, 0)))
        # normalise the absorbed factor each step: the product of ~T
        # R-factors overflows float32 otherwise
        rnorm = np.linalg.norm(Rfull)
        if rnorm > 0:
            Rfull = Rfull / rnorm
        if t + 1 < T - 1:
            site_tensors[t + 1] = np.einsum("ab,bic->aic", Rfull[:chi_r, :],
                                            site_tensors[t + 1])
        else:
            label_site = np.einsum("ab,bicl->aicl", Rfull[:chi_r, :], label_site)

    label_site = label_site / np.linalg.norm(label_site)

    chi = chi_max
    cores = np.zeros((T, chi, d, chi), dtype=dtype)
    for t in range(T - 1):
        A = site_tensors[t]
        cores[t, :A.shape[0], :, :A.shape[2]] = A
    center = np.zeros((chi, d, chi, num_classes), dtype=dtype)
    center[:label_site.shape[0], :, :1, :] = label_site
    return MPS.from_numpy(cores, center, T - 1, device)


def _contract_batch(cores: torch.Tensor, center: torch.Tensor,
                    center_pos: int, phis: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched MPS-product-state contraction with per-sample log-scales.

    ``phis`` [N, T, d] encoded states.  Returns (yhat_scaled [N, C],
    logscale [N]); the true value is yhat_scaled * exp(logscale) = sum over
    the network of W * conj(phi) (reference contract_mps, summary.jl:4-14)."""
    T, chi = cores.shape[0], cores.shape[1]
    N = phis.shape[0]
    phis_c = phis.conj().to(cores.dtype)
    rdt = phis.real.dtype

    vL = boundary_env(N, chi, cores.dtype, cores.device)
    lsL = torch.zeros((N,), dtype=rdt, device=cores.device)
    for t in range(center_pos):
        vL, lsL = env_step_left_scaled(vL, lsL, cores[t], phis_c[:, t])

    vR = boundary_env(N, chi, cores.dtype, cores.device)
    lsR = torch.zeros((N,), dtype=rdt, device=cores.device)
    for t in range(T - 1, center_pos, -1):
        vR, lsR = env_step_right_scaled(vR, lsR, cores[t], phis_c[:, t])

    # y[n,c] = vL[n,a] conj(phi[n,p,i]) center[a,i,b,c] vR[n,b]
    tmp = torch.einsum("na,aibc->nibc", vL, center)
    tmp = torch.einsum("nibc,ni->nbc", tmp, phis_c[:, center_pos])
    yhat = torch.einsum("nbc,nb->nc", tmp, vR)
    return yhat, lsL + lsR


def contract_batch_scaled(mps: MPS, phis: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(yhat_scaled [N, C], logscale [N]) for encoded states [N, T, d]."""
    return _contract_batch(mps.cores, mps.center, mps.center_pos, phis)


def contract_batch(mps: MPS, phis: torch.Tensor) -> torch.Tensor:
    """True-scale yhat [N, C]; may under/overflow for long series."""
    yhat, ls = contract_batch_scaled(mps, phis)
    return yhat * torch.exp(ls)[:, None].to(yhat.dtype)


@dataclass
class SingleMPS:
    """An unlabeled MPS (one class slice); same canonical structure."""
    cores: torch.Tensor       # [T, chi, d, chi]
    center: torch.Tensor      # [chi, d, chi]
    center_pos: int


def expand_label_index(mps: MPS) -> List[SingleMPS]:
    """Per-class normalised MPS list (reference utils.jl:356-370)."""
    out = []
    for c in range(mps.num_classes):
        center_c = mps.center[:, :, :, c]
        out.append(SingleMPS(mps.cores, center_c / torch.linalg.vector_norm(center_c),
                             mps.center_pos))
    return out

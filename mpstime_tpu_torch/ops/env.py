"""Environment (prefix/suffix) caches for the DMRG sweep (counterpart of
``mpstime_tpu/ops/env.py``).

  LE[t] = contraction of sites 0..t-1 with conj(phi); LE[0] = e0
  RE[t] = contraction of sites t..T-1 with conj(phi); RE[T] = e0

Environments are stored normalised per sample with an accumulated
log-scale, since raw prefix products under/overflow within ~100 sites.  The
bond gradient is invariant to those scales; the KLD loss recovers the true
magnitude as log|yhat_scaled|^2 + 2*logscale.
"""

from __future__ import annotations

from typing import Tuple

import torch


def boundary_env(N: int, chi: int, dtype, device="cpu") -> torch.Tensor:
    v = torch.zeros((N, chi), dtype=dtype, device=device)
    v[:, 0] = 1.0
    return v


def _normalize(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalise [N, chi] rows; return (unit rows, log norms [N])."""
    nrm = torch.linalg.vector_norm(v, dim=1, keepdim=True)
    safe = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    return v / safe, torch.log(safe[:, 0]).real


def env_step_left(v: torch.Tensor, core: torch.Tensor, phi_c: torch.Tensor
                  ) -> torch.Tensor:
    """v'[n,b] = sum_{a,i} v[n,a] conj(phi)[n,i] core[a,i,b]."""
    tmp = torch.einsum("na,aib->nib", v, core)
    return torch.einsum("nib,ni->nb", tmp, phi_c)


def env_step_right(v: torch.Tensor, core: torch.Tensor, phi_c: torch.Tensor
                   ) -> torch.Tensor:
    """v'[n,a] = sum_{i,b} core[a,i,b] conj(phi)[n,i] v[n,b]."""
    tmp = torch.einsum("aib,nb->nai", core, v)
    return torch.einsum("nai,ni->na", tmp, phi_c)


def env_step_left_scaled(v, ls, core, phi_c):
    v2, dls = _normalize(env_step_left(v, core, phi_c))
    return v2, ls + dls


def env_step_right_scaled(v, ls, core, phi_c):
    v2, dls = _normalize(env_step_right(v, core, phi_c))
    return v2, ls + dls


def build_left_envs(cores: torch.Tensor, phis_c: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(LE [T+1, N, chi], logscale [T+1, N]) with LE[0] = e0; ``phis_c`` is
    the conjugated [T, N, d] stack."""
    T, chi = cores.shape[0], cores.shape[1]
    N = phis_c.shape[1]
    v = boundary_env(N, chi, cores.dtype, cores.device)
    ls = torch.zeros((N,), dtype=phis_c.real.dtype, device=cores.device)
    vs, lss = [v], [ls]
    for t in range(T):
        v, ls = env_step_left_scaled(v, ls, cores[t], phis_c[t])
        vs.append(v)
        lss.append(ls)
    return torch.stack(vs), torch.stack(lss)


def build_right_envs(cores: torch.Tensor, phis_c: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(RE [T+1, N, chi], logscale [T+1, N]) with RE[T] = e0; RE[t] is the
    contraction of sites t..T-1."""
    T, chi = cores.shape[0], cores.shape[1]
    N = phis_c.shape[1]
    v = boundary_env(N, chi, cores.dtype, cores.device)
    ls = torch.zeros((N,), dtype=phis_c.real.dtype, device=cores.device)
    vs, lss = [v], [ls]
    for t in range(T - 1, -1, -1):
        v, ls = env_step_right_scaled(v, ls, cores[t], phis_c[t])
        vs.append(v)
        lss.append(ls)
    return torch.stack(vs[::-1]), torch.stack(lss[::-1])

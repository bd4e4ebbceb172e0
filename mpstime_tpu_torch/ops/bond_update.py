"""Bond-tensor loss/gradient and the local optimiser step (counterpart of
``mpstime_tpu/ops/bond_update.py``).  Per bond:

  P[n]       = le[n] (x) phi_l[n] (x) phi_r[n] (x) re[n]
  yhat[n, c] = sum BT[..., c] * conj(P[n])
  KLD grad[..., c] = -(1/Z_c) sum_{n: y_n=c} P[n] / conj(yhat[n, y_n])
  MSE grad[..., c] = sum_n w_n conj(P[n]) (yhat[n,c] - onehot[n,c])

The environments arrive normalised per sample with log-scales ``env_ls``;
the KLD gradient is invariant to them and the MSE path rebuilds the
true-scale yhat.  These functions build the plain versions of the bond
kernels (ops/bond_kernels.py).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _lr_factors(le, re, phi_l, phi_r):
    """L[n, chi*d] = le (x) phi_l ;  R[n, d*chi] = phi_r (x) re."""
    N, chi = le.shape
    d = phi_l.shape[1]
    L = (le[:, :, None] * phi_l[:, None, :]).reshape(N, chi * d)
    R = (phi_r[:, :, None] * re[:, None, :]).reshape(N, d * chi)
    return L, R


def _yhat(BT, L, R):
    chi, d, _, _, C = BT.shape
    BTm = BT.reshape(chi * d, d * chi, C)
    t = torch.einsum("nx,xyc->nyc", L.conj(), BTm)
    return torch.einsum("nyc,ny->nc", t, R.conj())


def kld_loss_grad(BT: torch.Tensor, le, re, phi_l, phi_r,
                  y_onehot: torch.Tensor, class_weight: torch.Tensor,
                  env_ls: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """KLD loss and gradient for BT [chi, d, d, chi, C]; env_ls [N] is the
    summed log-scale of le and re."""
    L, R = _lr_factors(le, re, phi_l, phi_r)
    yhat = _yhat(BT, L, R)                                     # [N, C] scaled
    y_true = torch.sum(yhat * y_onehot.to(yhat.dtype), dim=1)
    abs2 = y_true.real ** 2 + (y_true.imag ** 2 if y_true.is_complex() else 0)
    loss = torch.sum(class_weight * (-torch.log(abs2) - 2.0 * env_ls))
    u = (class_weight / y_true.conj()).to(BT.dtype)
    Wc = y_onehot.to(BT.dtype) * u[:, None]                    # [N, C]
    RW = R[:, :, None] * Wc[:, None, :]                        # [N, d*chi, C]
    grad = -torch.einsum("nx,nyc->xyc", L, RW)
    return loss, grad.reshape(BT.shape)


def mse_loss_grad(BT: torch.Tensor, le, re, phi_l, phi_r,
                  y_onehot: torch.Tensor, class_weight: torch.Tensor,
                  env_ls: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """MSE loss and gradient (pooled normalisation, reference :561-619);
    true-scale yhat = yhat_scaled * exp(env_ls)."""
    L, R = _lr_factors(le, re, phi_l, phi_r)
    yhat_s = _yhat(BT, L, R)
    scale = torch.exp(env_ls).to(yhat_s.real.dtype)           # [N]
    yhat = yhat_s * scale[:, None].to(yhat_s.dtype)
    resid = yhat - y_onehot.to(yhat.dtype)                     # [N, C]
    loss = 0.5 * torch.sum(class_weight * torch.sum(resid.abs() ** 2, dim=1))
    W = resid * (class_weight * scale)[:, None].to(yhat.dtype)
    RW = R.conj()[:, :, None] * W[:, None, :]
    grad = torch.einsum("nx,nyc->xyc", L.conj(), RW)
    return loss, grad.reshape(BT.shape)


_LOSS_GRADS = {"KLD": kld_loss_grad, "MSE": mse_loss_grad}


def apply_update(BT: torch.Tensor, le, re, phi_l, phi_r, y_onehot,
                 class_weight, env_ls, *, eta, loss: str = "KLD",
                 bbopt: str = "TSGO", update_iters: int = 1,
                 rescale: Tuple[bool, bool] = (False, True)
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Optimise one bond tensor (reference apply_update,
    loss_functions.jl:88-188) with "GD" (fixed step) or "TSGO"
    (normalised-gradient step, loss_functions.jl:79).  Returns
    (loss_before_last_step, BT_new)."""
    if loss not in _LOSS_GRADS or bbopt not in ("TSGO", "GD"):
        raise NotImplementedError(
            f"loss={loss}/bbopt={bbopt}: the port covers {{KLD, MSE}} x "
            "{TSGO, GD}; the mixed loss and CGD are ROADMAP.md queue 1 "
            "item 10")
    loss_grad = _LOSS_GRADS[loss]
    if rescale[0]:
        BT = BT / torch.linalg.vector_norm(BT)
    last_loss = torch.zeros((), dtype=BT.real.dtype, device=BT.device)
    for _ in range(update_iters):
        last_loss, g = loss_grad(BT, le, re, phi_l, phi_r, y_onehot,
                                 class_weight, env_ls)
        if bbopt == "TSGO":
            g = g / torch.linalg.vector_norm(g)
        BT = BT - eta * g
    if rescale[1]:
        BT = BT / torch.linalg.vector_norm(BT)
    return last_loss, BT

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


def bond_yhat(BT: torch.Tensor, le, re, phi_l, phi_r) -> torch.Tensor:
    """Scaled yhat [N, C] for bond tensor BT [chi, d, d, chi, C]."""
    return _yhat(BT, *_lr_factors(le, re, phi_l, phi_r))


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


def mixed_loss_grad(BT: torch.Tensor, le, re, phi_l, phi_r,
                    y_onehot: torch.Tensor, class_weight: torch.Tensor,
                    env_ls: torch.Tensor, alpha: float = 5.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KLD + alpha * MSE (the reference's :Mixed loss, loss_functions.jl:
    622-668); the Kronecker factors and yhat are computed once for both."""
    L, R = _lr_factors(le, re, phi_l, phi_r)
    yhat_s = _yhat(BT, L, R)
    y1 = y_onehot.to(yhat_s.dtype)
    # KLD part (see kld_loss_grad)
    y_true = torch.sum(yhat_s * y1, dim=1)
    abs2 = y_true.real ** 2 + (y_true.imag ** 2 if y_true.is_complex() else 0)
    l_kld = torch.sum(class_weight * (-torch.log(abs2) - 2.0 * env_ls))
    u = (class_weight / y_true.conj()).to(BT.dtype)
    Wc = y_onehot.to(BT.dtype) * u[:, None]
    g_kld = -torch.einsum("nx,nyc->xyc", L, R[:, :, None] * Wc[:, None, :])
    # MSE part (see mse_loss_grad)
    scale = torch.exp(env_ls).to(yhat_s.real.dtype)
    resid = yhat_s * scale[:, None].to(yhat_s.dtype) - y1
    l_mse = 0.5 * torch.sum(class_weight * torch.sum(resid.abs() ** 2, dim=1))
    W = resid * (class_weight * scale)[:, None].to(resid.dtype)
    g_mse = torch.einsum("nx,nyc->xyc", L.conj(),
                         R.conj()[:, :, None] * W[:, None, :])
    return l_kld + alpha * l_mse, (g_kld + alpha * g_mse).reshape(BT.shape)


_LOSS_GRADS = {"KLD": kld_loss_grad, "MSE": mse_loss_grad,
               "MIXED": mixed_loss_grad}


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re <a, b> with a conjugated, over all elements."""
    return torch.sum(a.conj() * b).real


def apply_update(BT, le, re, phi_l, phi_r, y_onehot, class_weight, env_ls,
                 *, eta, loss: str = "KLD", bbopt: str = "TSGO",
                 update_iters: int = 1,
                 rescale: Tuple[bool, bool] = (False, True), mesh=None):
    """Optimise one bond tensor (reference apply_update,
    loss_functions.jl:88-188) with "GD" (fixed step), "TSGO"
    (normalised-gradient step, loss_functions.jl:79) or "CGD" (Polak-Ribiere
    conjugate gradient with a normalised fixed step; the reference's CGD
    uses a line search instead, a difference documented at
    mpstime_tpu/options.py:258-267).  ``loss``: "KLD", "MSE" or "MIXED".
    Returns (loss_before_last_step, BT_new).

    ``mesh``: a data-parallel mesh (parallel/mesh.py).  BT is then a list
    with one tensor per replica and the batch operands lists with one tensor
    per shard; at every loss_grad call one ``mesh.all_reduce`` sums the
    shards' losses and gradients (mpstime_tpu/ops/bond_update.py:145-167)
    and every replica takes the same step.  Returns the summed loss (replica
    0's copy) and the list of stepped bond tensors."""
    if loss not in _LOSS_GRADS or bbopt not in ("TSGO", "GD", "CGD"):
        raise ValueError(f"loss={loss}/bbopt={bbopt}: loss must be one of "
                         f"{sorted(_LOSS_GRADS)} and bbopt TSGO, GD or CGD")
    loss_grad = _LOSS_GRADS[loss]
    batch = (le, re, phi_l, phi_r, y_onehot, class_weight, env_ls)
    if mesh is None:
        BTs = [BT]

        def loss_grads(BTs):
            return [loss_grad(BTs[0], *batch)]
    else:
        BTs = list(BT)

        def loss_grads(BTs):
            on = mesh.to_shards(BTs)
            return mesh.all_reduce([loss_grad(on[s], *(x[s] for x in batch))
                                    for s in range(len(mesh))])
    if rescale[0]:
        BTs = [B / torch.linalg.vector_norm(B) for B in BTs]
    tiny = torch.finfo(BTs[0].real.dtype).tiny
    last_loss = torch.zeros((), dtype=BTs[0].real.dtype,
                            device=BTs[0].device)
    g_prev = [torch.zeros_like(B) for B in BTs]
    p_prev = list(g_prev)
    for _ in range(update_iters):
        lgs = loss_grads(BTs)
        last_loss = lgs[0][0]
        for r, (_, g) in enumerate(lgs):
            if bbopt == "CGD":
                gg = _vdot(g_prev[r], g_prev[r])
                beta = torch.clamp(_vdot(g, g - g_prev[r])
                                   / torch.clamp(gg, min=tiny), min=0.0)
                p = -g + torch.where(gg > 0, beta, 0.0).to(g.dtype) * p_prev[r]
                BTs[r] = BTs[r] + eta * (p / torch.clamp(
                    torch.linalg.vector_norm(p), min=tiny))
                g_prev[r], p_prev[r] = g, p
                continue
            if bbopt == "TSGO":
                g = g / torch.linalg.vector_norm(g)
            BTs[r] = BTs[r] - eta * g
    if rescale[1]:
        BTs = [B / torch.linalg.vector_norm(B) for B in BTs]
    return last_loss, (BTs[0] if mesh is None else BTs)

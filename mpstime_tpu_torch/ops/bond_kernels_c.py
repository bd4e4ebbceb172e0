"""The complex bond-step kernels K12c, K12mc, K1c, K2c, K12cr, the four
complex pieces of the dp and batch-tiled bond step and K1c-tail
(counterpart of ``mpstime_tpu/ops/pallas_bond_c.py``).

``bond_step_c``, ``bond_block_steps_c`` and ``bond_step_c_ritz`` keep the
signatures of the JAX package's (pallas_bond_c.py:1308, :1184, :1031) with
complex tensors in place of its (re, im) pairs: complex operands stay
``torch.complex64`` (or, on the CPU, complex128) end to end, and the CUDA
kernels read them interleaved.  A refresh bond under orth="qr" runs K1c ->
the realified QR of ops/decomp.py's ``_qr_orth`` -> K2c
(pallas_bond_c.py:1368-1412); every other bond of the warm route runs K12c,
and a block of bonds K12mc.  A bond of the ritz route's Jacobi-rotated
sweeps runs K12cr.  ``bond_step_c_dp`` runs a bond on a data-parallel mesh
and ``bond_step_c(stream_tile=)`` the batch in row tiles
(pallas_bond_c.py:1228-1412): K1c-grad per shard or tile, one sum of the
gradients, K1c-update -> the realified QR (orth="qr") -> K2c-split once per
replica, K2c-env per shard or tile, the real pieces' chain
(``bond_kernels.bond_step_dp``) over the complex pieces.  On the split-tail
route (``split_tail=``, as ``bond_kernels.bond_step``'s) a refresh bond runs
K1c or K1c-update without its power step, then ``power_iters`` K1c-tail
launches at q=1 (pallas_bond_c.py:1363-1391, :1274-1284).  As in the JAX
package the complex kernels cover KLD + TSGO only; the wrappers refuse any
other loss or optimiser with a ValueError.

  * CUDA tensors launch the hand-written kernels (csrc/bond_step_c.cu, the
    real kernels' device functions at a complex scalar), or raise.  There
    is no fallback.  K12c and K12cr run one bond over a thread-block
    cluster of ``CLUSTER`` blocks, K12mc a block of bonds over
    ``K12MC_CLUSTER``, K1c over ``K1C_CLUSTER``, K1c-update over
    ``K1C_UPDATE_CLUSTER``, K1c-grad over ``K1C_GRAD_CLUSTER``, K2c over
    ``K2C_CLUSTER`` and K2c-split over ``K2C_SPLIT_CLUSTER``; K2c-env over
    independent blocks of ``K2C_ENV_ROWS`` rows and K1c-tail over a
    cooperative grid of ``K1C_TAIL_BLOCKS`` blocks.  The one-block K12mc,
    K1c, K1c-update, K1c-grad, K2c, K2c-split, K2c-env and K1c-tail
    (``k12mc_block_cuda``, ``k1c_block_cuda``, ``k1c_update_block_cuda``,
    ``k1c_grad_block_cuda``, ``k2c_block_cuda``, ``k2c_split_block_cuda``,
    ``k2c_env_block_cuda``, ``k1c_tail_block_cuda``) stay as the reference
    those kernels are held against bit for bit; no route calls them.
  * CPU tensors take the plain versions (``k12c_plain``, ``k12mc_plain``,
    ``k1c_plain``, ``k2c_plain``, ``k12cr_plain``, ``k1c_grad_plain``,
    ``k1c_update_plain``, ``k2c_split_plain``, ``k2c_env_plain``,
    ``k1c_tail_plain``), built
    from the ported update, splits, rotations and environment steps, which
    are dtype-generic.

Launches and plain calls count under "k12c", "k12mc", "k1c", "k2c",
"k12cr", "k1c_grad", "k1c_update", "k2c_split", "k2c_env" and "k1c_tail" in
``bond_kernels.LAUNCHES`` / ``PLAIN_CALLS`` (the one-block K12mc, K1c,
K1c-update, K1c-grad, K2c, K2c-split, K2c-env and K1c-tail under
"k12mc_block", "k1c_block", "k1c_update_block", "k1c_grad_block",
"k2c_block", "k2c_split_block", "k2c_env_block" and "k1c_tail_block"),
through ``bond_kernels.counted_launch`` and ``bond_kernels.count``.
Operand layouts are the real kernels': phil / phir are the conjugated
encoded states, the center is class-major [C, chi, d, chi], environments
[N, chi] with real log-scales [N], labels [N, C] and weights [N] real
float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import bond_kernels as bk
from .bond_kernels import (CLUSTER_KERNELS, GRID_KERNELS,  # noqa: F401
                           MAX_CLUSTER, MAX_ENV_ROWS, _cluster_size,
                           _env_rows, _grid_blocks, cluster_occupancy,
                           grid_occupancy)
from .decomp import (_JACOBI_ROUNDS, _JACOBI_WARM_ROUNDS, _pairwise_mask,
                     _qr_orth, _ritz_rot_jacobi)
from .env import env_step_left_scaled, env_step_right_scaled

Out4, Out5 = bk.Out4, bk.Out5


def _check_kld_tsgo(loss: str, bbopt: str) -> None:
    if (loss, bbopt) != ("KLD", "TSGO"):
        raise ValueError(f"loss={loss}/bbopt={bbopt}: the complex bond "
                         "kernels cover KLD + TSGO only; other complex "
                         "configurations take the unfused route of "
                         "training/sweep.py")


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def k1c_plain(A_or_B, center_c, le, re, phil, phir, y1h, w, V0, eta, *,
              forward: bool, emit_y: bool = True, power_iters: int = 1,
              orth: str = "qr") -> Tuple[torch.Tensor, torch.Tensor]:
    """K1c in plain PyTorch, with K1c's operands (no log-scale: the KLD
    gradient needs none): ``bond_kernels.k1_plain``.  Returns
    (BT [C, chi*d, d, chi], Y [chi*d, chi])."""
    gls = torch.zeros(le.shape[0], dtype=le.real.dtype, device=le.device)
    return bk.k1_plain(A_or_B, center_c, le, re, phil, phir, y1h, w, gls, V0,
                       eta, forward=forward, emit_y=emit_y,
                       power_iters=power_iters, orth=orth)


#: The other plain versions are the real kernels', which are dtype-generic
#: and take the same operands (KLD + TSGO by default).
k2c_plain = bk.k2_plain
k12c_plain = bk.k12_plain
k12mc_plain = bk.k12m_plain
k2c_split_plain = bk.k2_split_plain
k2c_env_plain = bk.k2_env_plain
#: K1c-grad and K1c-update: the complex KLD gradient of the batch, with the
#: KLD sign (as _k1c_bt_grad's -G, pallas_bond_c.py:211), and the TSGO step
#: against the summed gradient with q power steps.
k1c_grad_plain = bk.k1a_plain
k1c_update_plain = bk.k1b_plain
#: K1c-tail: the complex power step of a stored bond tensor
#: (_k1c_power, pallas_bond_c.py:250-317), BT^H BT backward and BT BT^H
#: forward.
k1c_tail_plain = bk.k1_tail_plain


def k12cr_plain(A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0,
                eta, cutoff, *, forward: bool, refresh: bool = True,
                power_iters: int = 1, max_rank=None,
                rounds: int = _JACOBI_ROUNDS) -> Out5:
    """K12cr, the tracked-ritz bond step, in plain PyTorch
    (pallas_bond_c.py:913-997): K1c with the tri-Newton refresh (a frozen
    bond keeps Q = V0), the projected blocks B and Gram S, ``rounds`` Jacobi
    rounds, the sort-free cutoff mask on the round-order energies, the
    emission through the masked rotation Wm and the environment advance
    through Qm = Q Wm.  Returns (center_c', core', env', env_ls', Q W); the
    cache Q W is rotated and unmasked."""
    C, chi, d, _ = center_c.shape
    BT, Q = k1c_plain(A_or_B, center_c, le, re, phil, phir, y1h, w, V0, eta,
                      forward=forward, emit_y=refresh,
                      power_iters=power_iters, orth="tri")
    BT = BT.reshape(C, chi * d, d * chi)
    if forward:
        B = Q.conj().T @ BT                            # [C, chi, d*chi]
        S = torch.sum(B @ B.conj().transpose(1, 2), 0)
    else:
        B = BT @ Q                                     # [C, chi*d, chi]
        S = torch.sum(B.conj().transpose(1, 2) @ B, 0)
    wv, W = _ritz_rot_jacobi(S, rounds)
    Wm = W * _pairwise_mask(wv, cutoff, max_rank)
    Qm = Q @ Wm
    if forward:
        center = (Wm.conj().T @ B).reshape(C, chi, d, chi)
        core = Qm.reshape(chi, d, chi)
        env2, ls2 = env_step_left_scaled(le, env_ls, core, phil)
    else:
        center = (B @ Wm).reshape(C, chi, d, chi)
        core = Qm.conj().T.resolve_conj().reshape(chi, d, chi)
        env2, ls2 = env_step_right_scaled(re, env_ls, core, phir)
    return center, core, env2, ls2, Q @ W


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _launcher(device: torch.device, entry: str):
    return bk._cuda_launch(device, entry, "mpst_c_workspace_floats")


#: Thread blocks in the cluster that runs one bond of K12c or K12cr.
CLUSTER = 16
#: Thread blocks in the cluster of K1c, of K1c-update, of K12mc, of
#: K1c-grad, of K2c and of K2c-split, from their times by cluster size on
#: the card (chip_smoke.py's [k1c-k1c-update-cluster],
#: [k12m-k12mc-cluster], [k1a-k1c-grad-cluster] and [k2-k2split-cluster]).
K1C_CLUSTER = 16
K1C_UPDATE_CLUSTER = 16
K12MC_CLUSTER = 16
K1C_GRAD_CLUSTER = 16
K2C_CLUSTER = 16
K2C_SPLIT_CLUSTER = 16
#: Rows a block of K2c-env advances (ceil(N / K2C_ENV_ROWS) independent
#: blocks), and blocks of the cooperative grid of K1c-tail, from their times
#: on the card at N 100, 50 and 32 and at chi 128 and 192
#: (chip_smoke.py's [k2env-k1tail-redesign]).
K2C_ENV_ROWS = 8
K1C_TAIL_BLOCKS = 132


def _k12mc(entry, extra, *args, **kw) -> Out5:
    """K12mc's operands (KLD + TSGO) checked and launched through
    ``entry``, with ``extra`` after K12mc's C arguments (the Jacobi round
    count, the cluster size)."""
    launch, wsf = _launcher(args[1].device, entry)
    return bk._launch_k12m(*args, loss="KLD", bbopt="TSGO",
                           launch=lambda *a: launch(*a, *extra),
                           workspace_floats=wsf, dtype=torch.complex64, **kw)


def _k12mc_cluster(cluster, *args, **kw) -> Out5:
    """K12mc's operands launched over a thread-block cluster of ``cluster``
    blocks, checked before the library loads; a cluster the card cannot
    place raises RuntimeError."""
    return _k12mc("mpst_k12mc_cluster_launch", (_cluster_size(cluster),),
                  *args, **kw)


@bk.counted_launch("k12c")
def k12c_cuda(A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0,
              eta, cutoff, *, forward: bool, refresh: bool = True,
              power_iters: int = 1, max_rank=None, loss: str = "KLD",
              bbopt: str = "TSGO", cluster: Optional[int] = None) -> Out5:
    """K12c: one complex bond step as one launch of a thread-block cluster
    of ``cluster`` blocks (default ``CLUSTER``); a cluster the card cannot
    place raises RuntimeError."""
    _check_kld_tsgo(loss, bbopt)
    n = _cluster_size(CLUSTER if cluster is None else cluster)
    env, envx = (le, re) if forward else (re, le)
    center2, core, env2, ls2, Q = _k12mc(
        "mpst_k12c_launch", (n,), A_or_B[None], center_c, envx[None], env,
        env_ls, None, phil[None], phir[None], y1h, w, V0[None], eta, cutoff,
        forward=forward, refresh=refresh, power_iters=power_iters,
        max_rank=max_rank)
    return center2, core[0], env2[0], ls2[0], Q[0]


@bk.counted_launch("k12mc")
def k12mc_cuda(A_blk, center_c, envx_blk, env0, env_ls0, phil_blk,
               phir_blk, y1h, w, V0_blk, eta, cutoff, *, forward: bool,
               refresh: bool = True, power_iters: int = 1, max_rank=None,
               loss: str = "KLD", bbopt: str = "TSGO") -> Out5:
    """K12mc: Bb consecutive complex bond steps as one launch of a
    thread-block cluster of ``K12MC_CLUSTER`` blocks."""
    _check_kld_tsgo(loss, bbopt)
    return _k12mc_cluster(K12MC_CLUSTER, A_blk, center_c, envx_blk, env0,
                          env_ls0, None, phil_blk, phir_blk, y1h, w, V0_blk,
                          eta, cutoff, forward=forward, refresh=refresh,
                          power_iters=power_iters, max_rank=max_rank)


@bk.counted_launch("k12mc_block")
def k12mc_block_cuda(A_blk, center_c, envx_blk, env0, env_ls0, phil_blk,
                     phir_blk, y1h, w, V0_blk, eta, cutoff, *,
                     forward: bool, refresh: bool = True,
                     power_iters: int = 1, max_rank=None) -> Out5:
    """K12mc on one thread block, the reference ``k12mc_cuda`` and
    ``k12c_cuda`` are held against bit for bit (no route calls it);
    operands and results as ``k12mc_plain``'s."""
    return _k12mc("mpst_k12mc_launch", (), A_blk, center_c, envx_blk, env0,
                  env_ls0, None, phil_blk, phir_blk, y1h, w, V0_blk, eta,
                  cutoff, forward=forward, refresh=refresh,
                  power_iters=power_iters, max_rank=max_rank)


def _k1c(entry, extra, A_or_B, center_c, le, re, phil, phir, y1h, w, V0,
         eta, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1c's operands checked and launched through ``entry``, with
    ``extra`` after K1c's C arguments (the cluster size)."""
    launch, wsf = _launcher(center_c.device, entry)
    return bk._launch_k1(A_or_B, center_c, le, re, phil, phir, y1h, w, None,
                         V0, eta, loss="KLD", bbopt="TSGO",
                         launch=lambda *a: launch(*a, *extra),
                         workspace_floats=wsf, dtype=torch.complex64, **kw)


@bk.counted_launch("k1c")
def k1c_cuda(A_or_B, center_c, le, re, phil, phir, y1h, w, V0, eta, *,
             forward: bool, emit_y: bool = True, power_iters: int = 1,
             orth: str = "qr", loss: str = "KLD", bbopt: str = "TSGO",
             cluster: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1c as one launch of a thread-block cluster of ``cluster`` blocks
    (default ``K1C_CLUSTER``); operands and results as ``k1c_plain``'s.  A
    cluster the card cannot place raises RuntimeError."""
    _check_kld_tsgo(loss, bbopt)
    n = _cluster_size(K1C_CLUSTER if cluster is None else cluster)
    return _k1c("mpst_k1c_cluster_launch", (n,), A_or_B, center_c, le, re,
                phil, phir, y1h, w, V0, eta, forward=forward, emit_y=emit_y,
                power_iters=power_iters, orth=orth)


@bk.counted_launch("k1c_block")
def k1c_block_cuda(A_or_B, center_c, le, re, phil, phir, y1h, w, V0, eta, *,
                   forward: bool, emit_y: bool = True, power_iters: int = 1,
                   orth: str = "qr") -> Tuple[torch.Tensor, torch.Tensor]:
    """K1c on one thread block, the reference ``k1c_cuda`` is held against
    bit for bit (no route calls it); operands and results as
    ``k1c_plain``'s."""
    return _k1c("mpst_k1c_launch", (), A_or_B, center_c, le, re, phil, phir,
                y1h, w, V0, eta, forward=forward, emit_y=emit_y,
                power_iters=power_iters, orth=orth)


def _k2c(entry, extra, *args, **kw) -> Out4:
    """K2c's operands checked and launched through ``entry``, with
    ``extra`` after K2c's C arguments (the parts to run, the cluster
    size)."""
    launch, wsf = _launcher(args[0].device, entry)
    return bk._launch_k2(*args, launch=lambda *a: launch(*a, *extra),
                         workspace_floats=wsf, dtype=torch.complex64, **kw)


@bk.counted_launch("k2c")
def k2c_cuda(BT, Q, env, env_ls, phi, cutoff, *, forward: bool,
             max_rank=None, cluster: Optional[int] = None) -> Out4:
    """K2c as one launch of a thread-block cluster of ``cluster`` blocks
    (default ``K2C_CLUSTER``); operands and results as ``k2c_plain``'s.  A
    cluster the card cannot place raises RuntimeError."""
    n = _cluster_size(K2C_CLUSTER if cluster is None else cluster)
    return _k2c("mpst_k2c_cluster_launch", (n,), BT, Q, env, env_ls, phi,
                cutoff, forward=forward, max_rank=max_rank)


@bk.counted_launch("k2c_block")
def k2c_block_cuda(BT, Q, env, env_ls, phi, cutoff, *, forward: bool,
                   max_rank=None) -> Out4:
    """K2c on one thread block, the reference ``k2c_cuda`` is held against
    bit for bit (no route calls it); operands and results as
    ``k2c_plain``'s."""
    return _k2c("mpst_k2c_launch", (), BT, Q, env, env_ls, phi, cutoff,
                forward=forward, max_rank=max_rank)


@bk.counted_launch("k12cr")
def k12cr_cuda(A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0,
               eta, cutoff, *, forward: bool, refresh: bool = True,
               power_iters: int = 1, max_rank=None,
               rounds: int = _JACOBI_ROUNDS,
               cluster: Optional[int] = None) -> Out5:
    """K12cr as one launch of a thread-block cluster of ``cluster`` blocks
    (default ``CLUSTER``); operands and results as ``k12cr_plain``'s.  The
    operands are checked and the outputs allocated as for K12c (a block of
    one bond); the launch adds the Jacobi round count.  A cluster the card
    cannot place raises RuntimeError."""
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    n = _cluster_size(CLUSTER if cluster is None else cluster)
    env, envx = (le, re) if forward else (re, le)
    center2, core, env2, ls2, Q = _k12mc(
        "mpst_k12cr_launch", (int(rounds), n), A_or_B[None], center_c,
        envx[None], env, env_ls, None, phil[None], phir[None], y1h, w,
        V0[None], eta, cutoff, forward=forward, refresh=refresh,
        power_iters=power_iters, max_rank=max_rank)
    return center2, core[0], env2[0], ls2[0], Q[0]


def _k1c_grad(entry, extra, A_or_B, center_c, le, re, phil, phir, y1h, w,
              *, forward: bool) -> torch.Tensor:
    """K1c-grad's operands checked and launched through ``entry``, with
    ``extra`` after K1c-grad's C arguments (the cluster size)."""
    launch, wsf = _launcher(center_c.device, entry)
    return bk._launch_k1a(A_or_B, center_c, le, re, phil, phir, y1h, w, None,
                          forward=forward, loss="KLD",
                          launch=lambda *a: launch(*a, *extra),
                          workspace_floats=wsf, dtype=torch.complex64)


@bk.counted_launch("k1c_grad")
def k1c_grad_cuda(A_or_B, center_c, le, re, phil, phir, y1h, w, gls, *,
                  forward: bool, loss: str = "KLD",
                  cluster: Optional[int] = None) -> torch.Tensor:
    """K1c-grad as one launch of a thread-block cluster of ``cluster``
    blocks (default ``K1C_GRAD_CLUSTER``); operands and result as
    ``k1c_grad_plain``'s (``gls`` is not read).  A cluster the card cannot
    place raises RuntimeError."""
    _check_kld_tsgo(loss, "TSGO")
    n = _cluster_size(K1C_GRAD_CLUSTER if cluster is None else cluster)
    return _k1c_grad("mpst_k1c_grad_cluster_launch", (n,), A_or_B, center_c,
                     le, re, phil, phir, y1h, w, forward=forward)


@bk.counted_launch("k1c_grad_block")
def k1c_grad_block_cuda(A_or_B, center_c, le, re, phil, phir, y1h, w, gls,
                        *, forward: bool) -> torch.Tensor:
    """K1c-grad on one thread block, the reference ``k1c_grad_cuda`` is
    held against bit for bit (no route calls it); operands and result as
    ``k1c_grad_plain``'s (``gls`` is not read)."""
    return _k1c_grad("mpst_k1c_grad_launch", (), A_or_B, center_c, le, re,
                     phil, phir, y1h, w, forward=forward)


def _k1c_update(entry, extra, A_or_B, center_c, G, V0, eta, **kw
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1c-update's operands checked and launched through ``entry``, with
    ``extra`` after K1c-update's C arguments (the cluster size)."""
    launch, wsf = _launcher(center_c.device, entry)
    return bk._launch_k1b(A_or_B, center_c, G, V0, eta, bbopt="TSGO",
                          launch=lambda *a: launch(*a, *extra),
                          workspace_floats=wsf, dtype=torch.complex64, **kw)


@bk.counted_launch("k1c_update")
def k1c_update_cuda(A_or_B, center_c, G, V0, eta, *, forward: bool,
                    emit_y: bool = True, power_iters: int = 1,
                    orth: str = "qr", bbopt: str = "TSGO",
                    cluster: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1c-update as one launch of a thread-block cluster of ``cluster``
    blocks (default ``K1C_UPDATE_CLUSTER``); operands and results as
    ``k1c_update_plain``'s.  A cluster the card cannot place raises
    RuntimeError."""
    _check_kld_tsgo("KLD", bbopt)
    n = _cluster_size(K1C_UPDATE_CLUSTER if cluster is None else cluster)
    return _k1c_update("mpst_k1c_update_cluster_launch", (n,), A_or_B,
                       center_c, G, V0, eta, forward=forward, emit_y=emit_y,
                       power_iters=power_iters, orth=orth)


@bk.counted_launch("k1c_update_block")
def k1c_update_block_cuda(A_or_B, center_c, G, V0, eta, *, forward: bool,
                          emit_y: bool = True, power_iters: int = 1,
                          orth: str = "qr"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1c-update on one thread block, the reference ``k1c_update_cuda`` is
    held against bit for bit (no route calls it); operands and results as
    ``k1c_update_plain``'s."""
    return _k1c_update("mpst_k1c_update_launch", (), A_or_B, center_c, G, V0,
                       eta, forward=forward, emit_y=emit_y,
                       power_iters=power_iters, orth=orth)


def _k2c_split(entry, extra, *args, **kw
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2c-split's operands checked and launched through ``entry``, with
    ``extra`` after K2c-split's C arguments (the cluster size)."""
    launch, wsf = _launcher(args[0].device, entry)
    return bk._launch_k2_split(*args, launch=lambda *a: launch(*a, *extra),
                               workspace_floats=wsf, dtype=torch.complex64,
                               **kw)


@bk.counted_launch("k2c_split")
def k2c_split_cuda(BT, Q, cutoff, *, forward: bool, max_rank=None,
                   cluster: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2c-split as one launch of a thread-block cluster of ``cluster``
    blocks (default ``K2C_SPLIT_CLUSTER``); operands and results as
    ``k2c_split_plain``'s: (center_c', core', Qm).  A cluster the card
    cannot place raises RuntimeError."""
    n = _cluster_size(K2C_SPLIT_CLUSTER if cluster is None else cluster)
    return _k2c_split("mpst_k2c_split_cluster_launch", (n,), BT, Q, cutoff,
                      forward=forward, max_rank=max_rank)


@bk.counted_launch("k2c_split_block")
def k2c_split_block_cuda(BT, Q, cutoff, *, forward: bool, max_rank=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2c-split on one thread block, the reference ``k2c_split_cuda`` is
    held against bit for bit (no route calls it); operands and results as
    ``k2c_split_plain``'s."""
    return _k2c_split("mpst_k2c_split_launch", (), BT, Q, cutoff,
                      forward=forward, max_rank=max_rank)


def _k2c_env(entry, extra, *args, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2c-env's operands checked and launched through ``entry``, with
    ``extra`` after K2c-env's C arguments (the rows a block and the staging
    flag)."""
    launch, wsf = _launcher(args[0].device, entry)
    return bk._launch_k2_env(*args, launch=lambda *a: launch(*a, *extra),
                             workspace_floats=wsf, dtype=torch.complex64,
                             **kw)


@bk.counted_launch("k2c_env")
def k2c_env_cuda(Qm, env, env_ls, phi, *, forward: bool,
                 rows: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2c-env as one launch of ceil(N / ``rows``) independent blocks of
    ``rows`` rows each (default ``K2C_ENV_ROWS``), staged as K2-env's;
    operands and results as ``k2c_env_plain``'s."""
    n = _env_rows(K2C_ENV_ROWS if rows is None else rows)
    return _k2c_env("mpst_k2c_env_rows_launch", (n, 1), Qm, env, env_ls, phi,
                    forward=forward)


@bk.counted_launch("k2c_env_block")
def k2c_env_block_cuda(Qm, env, env_ls, phi, *, forward: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2c-env on one thread block, the reference ``k2c_env_cuda`` is held
    against bit for bit (no route calls it); operands and results as
    ``k2c_env_plain``'s."""
    return _k2c_env("mpst_k2c_env_launch", (), Qm, env, env_ls, phi,
                    forward=forward)


def _k1c_tail(entry, extra, *args, **kw) -> torch.Tensor:
    """K1c-tail's operands checked and launched through ``entry``, with
    ``extra`` after K1c-tail's C arguments (the grid size)."""
    launch, wsf = _launcher(args[0].device, entry)
    return bk._launch_k1_tail(*args, launch=lambda *a: launch(*a, *extra),
                              workspace_floats=wsf, dtype=torch.complex64,
                              **kw)


@bk.counted_launch("k1c_tail")
def k1c_tail_cuda(BT, V0, *, forward: bool, power_iters: int = 1,
                  orth: str = "qr", blocks: Optional[int] = None
                  ) -> torch.Tensor:
    """K1c-tail as one launch of a cooperative grid of ``blocks`` blocks
    (default ``K1C_TAIL_BLOCKS``); operands and result as
    ``k1c_tail_plain``'s (orth "ns" or "qr").  A grid the card cannot hold
    at once raises RuntimeError."""
    n = _grid_blocks(K1C_TAIL_BLOCKS if blocks is None else blocks)
    return _k1c_tail("mpst_k1c_tail_grid_launch", (n,), BT, V0,
                     forward=forward, power_iters=power_iters, orth=orth)


@bk.counted_launch("k1c_tail_block")
def k1c_tail_block_cuda(BT, V0, *, forward: bool, power_iters: int = 1,
                        orth: str = "qr") -> torch.Tensor:
    """K1c-tail on one thread block, the reference ``k1c_tail_cuda`` is held
    against bit for bit (no route calls it); operands and result as
    ``k1c_tail_plain``'s."""
    return _k1c_tail("mpst_k1c_tail_launch", (), BT, V0, forward=forward,
                     power_iters=power_iters, orth=orth)


#: The complex pieces of ``bond_kernels.bond_step_dp``'s chain and the split
#: tail, under the real pieces' names: (counter, plain, CUDA).
PIECES = {"k1a": ("k1c_grad", k1c_grad_plain, k1c_grad_cuda),
          "k1b": ("k1c_update", k1c_update_plain, k1c_update_cuda),
          "k2_split": ("k2c_split", k2c_split_plain, k2c_split_cuda),
          "k2_env": ("k2c_env", k2c_env_plain, k2c_env_cuda),
          "k1_tail": ("k1c_tail", k1c_tail_plain, k1c_tail_cuda)}


# --------------------------------------------------------------------------
# public complex bond steps
# --------------------------------------------------------------------------

def _check_route(orth: str, axis_name=None) -> None:
    if axis_name is not None:
        raise ValueError("the port's data-parallel complex bond step is "
                         "bond_step_c_dp(mesh, ...), one process driving the "
                         "mesh's devices: it takes no axis_name")
    if orth not in ("qr", "ns"):
        raise ValueError(f"orth must be 'qr' or 'ns', got {orth!r}")


def qr_bond_step_c(A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0,
                   eta, cutoff, *, forward: bool, plain: bool,
                   power_iters: int = 1, max_rank=None, orth: str = "qr",
                   split_tail: bool = False) -> Out5:
    """A complex refresh bond through K1c and K2c: K1c, the realified QR of
    its Y (orth="qr"; ``_qr_orth``, pallas_bond_c.py:1216-1225), then K2c
    against Q; with ``split_tail``, K1c without its power step and
    ``bond_kernels.split_tail_basis`` over K1c-tail (orth "qr" or "ns").
    ``plain`` selects the plain versions instead of the CUDA kernels; both
    orthonormalise with the same QR.  Returns (center_c', core', env',
    env_ls', Q')."""
    k1, k2 = (k1c_plain, k2c_plain) if plain else (k1c_cuda, k2c_cuda)
    BT, Y = k1(A_or_B, center_c, le, re, phil, phir, y1h, w, V0, eta,
               forward=forward, emit_y=not split_tail,
               power_iters=power_iters, orth=orth)
    if split_tail:
        Q = bk.split_tail_basis(k1c_tail_plain if plain else k1c_tail_cuda,
                                BT, V0, forward=forward,
                                power_iters=power_iters, orth=orth)
    else:
        Q = _qr_orth(Y).contiguous()
    env, phi = (le, phil) if forward else (re, phir)
    return k2(BT, Q, env, env_ls, phi, cutoff, forward=forward,
              max_rank=max_rank) + (Q,)


def bond_step_c(A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0,
                eta, cutoff, *, forward: bool, refresh: bool = True,
                axis_name: str = None, power_iters: int = 1,
                orth: str = "qr", max_rank=None,
                stream_tile: Optional[int] = None,
                split_tail: Optional[bool] = None) -> Out5:
    """One complex bond step (KLD + TSGO): K1c -> QR -> K2c for a refresh
    bond under orth="qr", else one K12c; on the split-tail route
    (``split_tail`` as ``bond_kernels.bond_step``'s) a refresh bond runs K1c
    without its power step, ``power_iters`` K1c-tail launches, the QR under
    orth="qr", then K2c.  Operands and results as
    ``bond_kernels.bond_step``'s, complex; env_ls stays real.

    ``stream_tile``: run the batch in tiles of this many rows
    (pallas_bond_c.py:1228-1305): the pad rows copy row 0 at weight 0, the
    tiles' K1c-grad gradients are summed in tile order, one K1c-update (->
    QR) -> K2c-split follows, then K2c-env on each tile.  The data-parallel
    step is ``bond_step_c_dp``, so ``axis_name`` is refused."""
    _check_route(orth, axis_name)
    args = (A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0, eta,
            cutoff)
    kw = dict(forward=forward, power_iters=power_iters, max_rank=max_rank)
    if stream_tile is not None:
        return bk._bond_step_streamed(*args, refresh=refresh, orth=orth,
                                      stream_tile=stream_tile,
                                      split_tail=split_tail, **kw)
    cuda = bk._device_of(center_c) == "cuda"
    tail = refresh and bk.splits_tail(center_c.shape[1], split_tail)
    if refresh and (orth == "qr" or tail):
        if not cuda:
            bk.count(bk.PLAIN_CALLS, "k1c")
            bk.count(bk.PLAIN_CALLS, "k2c")
            if tail:
                bk.count(bk.PLAIN_CALLS, "k1c_tail", power_iters)
        return qr_bond_step_c(*args, plain=not cuda, orth=orth,
                              split_tail=tail, **kw)
    if cuda:
        return k12c_cuda(*args, refresh=refresh, **kw)
    bk.count(bk.PLAIN_CALLS, "k12c")
    return k12c_plain(*args, refresh=refresh, **kw)


def bond_step_c_dp(mesh, A_or_B, center_c, le, re, env_ls, phil, phir, y1h,
                   w, V0, eta, cutoff, *, forward: bool, refresh: bool = True,
                   power_iters: int = 1, orth: str = "qr", max_rank=None,
                   split_tail: Optional[bool] = None):
    """One complex bond step (KLD + TSGO) on a data-parallel ``mesh``, the
    JAX ``bond_step_c`` with ``axis_name`` (pallas_bond_c.py:1308-1412):
    K1c-grad on every shard, ``mesh.all_reduce`` of the gradients, K1c-update,
    the realified QR under orth="qr" and K2c-split once per replica (a
    frozen bond keeps Q = V0), K2c-env on every shard; on the split-tail
    route K1c-update runs without its power step and ``power_iters``
    K1c-tail launches follow it.  Operands (lists per replica and per
    shard) and results as ``bond_kernels.bond_step_dp``'s."""
    return bk.bond_step_dp(mesh, A_or_B, center_c, le, re, env_ls, phil, phir,
                           y1h, w, V0, eta, cutoff, forward=forward,
                           refresh=refresh, power_iters=power_iters,
                           orth=orth, max_rank=max_rank,
                           split_tail=split_tail)


def bond_step_c_ritz(A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w,
                     V0, eta, cutoff, *, forward: bool, refresh: bool = True,
                     power_iters: int = 1, max_rank=None,
                     rounds: Optional[int] = None,
                     rot: str = "jacobi") -> Out5:
    """One tracked-ritz complex bond step, K12cr (pallas_bond_c.py:1031-
    1064): the whole step of the ritz route's Jacobi-rotated sweeps in one
    kernel.  ``rot``: "jacobi" (the tracked sweeps, 6 rounds) or
    "jacobi_warm" (cold-start sweeps, 24 rounds); ``rounds`` overrides.  The
    refresh is always the QR-gauge tri-Newton, whatever the fit's orth.
    Operands and results as ``bond_step_c``'s; the returned cache is the
    rotated basis Q W."""
    if rot not in ("jacobi", "jacobi_warm"):
        raise ValueError(f"K12cr runs the Jacobi rotations 'jacobi' and "
                         f"'jacobi_warm', got {rot!r}")
    if rounds is None:
        rounds = (_JACOBI_WARM_ROUNDS if rot == "jacobi_warm"
                  else _JACOBI_ROUNDS)
    args = (A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0, eta,
            cutoff)
    kw = dict(forward=forward, refresh=refresh, power_iters=power_iters,
              max_rank=max_rank, rounds=rounds)
    if bk._device_of(center_c) == "cuda":
        return k12cr_cuda(*args, **kw)
    bk.count(bk.PLAIN_CALLS, "k12cr")
    return k12cr_plain(*args, **kw)


def bond_block_steps_c(A_blk, center_c, envx_blk, env0, env_ls0, phil_blk,
                       phir_blk, y1h, w, V0_blk, eta, cutoff, *,
                       forward: bool, refresh: bool = True,
                       power_iters: int = 1, orth: str = "ns",
                       max_rank=None) -> Out5:
    """Bb consecutive complex bond updates (K12mc): Newton-Schulz refresh
    bonds, or frozen bonds under either orth.  Operands and results as
    ``bond_kernels.bond_block_steps``'s, complex."""
    _check_route(orth)
    if refresh and orth != "ns":
        raise ValueError("K12mc refreshes with the Newton-Schulz polar only; "
                         "orth='qr' refresh bonds run bond_step_c")
    kw = dict(forward=forward, refresh=refresh, power_iters=power_iters,
              max_rank=max_rank)
    args = (A_blk, center_c, envx_blk, env0, env_ls0, phil_blk, phir_blk,
            y1h, w, V0_blk, eta, cutoff)
    if bk._device_of(center_c) == "cuda":
        return k12mc_cuda(*args, **kw)
    bk.count(bk.PLAIN_CALLS, "k12mc")
    return k12mc_plain(*args, **kw)

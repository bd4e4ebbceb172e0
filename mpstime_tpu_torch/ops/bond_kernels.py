"""The fused bond step, K12, its multi-bond block, K12m, the two halves K1
and K2 of the bond step around an outside QR, its four pieces K1a, K1b,
K2-split and K2-env for data-parallel meshes and batch tiles, and the
stand-alone power step K1-tail of the split-tail route (counterpart of
``mpstime_tpu/ops/pallas_bond.py``).

``bond_step`` and ``bond_block_steps`` keep the signatures of the JAX
package's (pallas_bond.py:1235, :1062).  A refresh bond under orth="qr" runs
K1 -> ``torch.linalg.qr`` -> K2 (pallas_bond.py:1320-1372); every other bond
runs K12.  On the split-tail route (``split_tail=``, by default where
``splits_tail`` says so) a refresh bond runs K1 without its power step, then
``power_iters`` K1-tail launches at q=1 over the stored bond tensor, then the
QR under orth="qr", then K2 (pallas_bond.py:1332-1351); the dp and
batch-tiled steps split K1b the same way.  ``bond_step(stream_tile=)`` runs
the batch in row tiles (pallas_bond.py:1150-1232) and ``bond_step_dp`` a
bond on a data-parallel mesh (the JAX bond step with ``axis_name``): K1a per
tile or shard, one sum of their gradients, K1b -> QR -> K2-split once per
device, K2-env per tile or shard.  Each kernel dispatches on the device of
the tensors it is given:

  * CUDA tensors launch the hand-written kernel (csrc/bond_step.cu), built
    at first use, or raise.  There is no fallback.  K12 and K12m run their
    block of bonds over a thread-block cluster of ``K12M_CLUSTER`` blocks,
    K1a its batch gradient over ``K1A_CLUSTER``, K1 and K1b their bond
    update over ``K1_CLUSTER`` and ``K1B_CLUSTER``, K2 and K2-split their
    split over ``K2_CLUSTER`` and ``K2_SPLIT_CLUSTER``; K2-env runs
    independent blocks of ``K2_ENV_ROWS`` rows, K1-tail a cooperative grid
    of ``K1_TAIL_BLOCKS`` blocks; the one-block K12m, K1a, K1, K1b, K2,
    K2-split, K2-env and K1-tail (``k12m_block_cuda``, ``k1a_block_cuda``,
    ``k1_block_cuda``, ``k1b_block_cuda``, ``k2_block_cuda``,
    ``k2_split_block_cuda``, ``k2_env_block_cuda``,
    ``k1_tail_block_cuda``) stay as the reference they are held against
    bit for bit, and no route calls them.
  * CPU tensors take the kernel's plain PyTorch version (``k12_plain``,
    ``k12m_plain``, ``k1_plain``, ``k2_plain``, ``k1a_plain``,
    ``k1b_plain``, ``k2_split_plain``, ``k2_env_plain``,
    ``k1_tail_plain``), built from the ported gradient, split and
    environment functions.

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` the dispatches to the
plain versions, so a run can show which path it took (the one-block K12m,
K1a, K1, K1b, K2, K2-split, K2-env and K1-tail under "k12m_block",
"k1a_block", "k1_block", "k1b_block", "k2_block", "k2_split_block",
"k2_env_block" and "k1_tail_block"); both are bumped under one lock
(``count``), and each counted launch is the program span "mps/launch"
under a profiler (``counted_launch``).  Operand layouts are
the JAX kernels': the class-major center [C, chi, d, chi], environments
[N, chi], conjugated features [N, d], subspace caches [chi*d, chi], and the
bond tensor and its gradient [C, chi*d, d, chi].
"""

from __future__ import annotations

import ctypes
import functools
import numbers
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from ..utils import profiling
from .bond_update import kld_loss_grad, mse_loss_grad
from .decomp import _qr_orth, warm_iterate, warm_split_left, warm_split_right
from .env import env_step_left_scaled, env_step_right_scaled

#: Kernel launches per kernel since the last reset_counts().
#: The complex kernels (ops/bond_kernels_c.py) count here too; "k12m_block",
#: "k12mc_block", "k1c_block", "k1c_update_block", "k1a_block",
#: "k1c_grad_block", "k1_block", "k1b_block", "k2_block", "k2c_block",
#: "k2_split_block", "k2c_split_block", "k2_env_block", "k2c_env_block",
#: "k1_tail_block" and "k1c_tail_block" count the one-block K12m, K12mc,
#: K1c, K1c-update, K1a, K1c-grad, K1, K1b, K2, K2c, K2-split, K2c-split,
#: K2-env, K2c-env, K1-tail and K1c-tail, which no route launches (their
#: cluster, row-tile and grid kernels count under "k12" and "k12m",
#: "k12mc", "k1c", "k1c_update", "k1a", "k1c_grad", "k1", "k1b", "k2",
#: "k2c", "k2_split", "k2c_split", "k2_env", "k2c_env", "k1_tail",
#: "k1c_tail").
LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("k12", "k12m", "k1", "k2", "k12c", "k12mc", "k1c", "k2c", "k12cr",
     "k1a", "k1b", "k2_split", "k2_env", "k1c_grad", "k1c_update",
     "k2c_split", "k2c_env", "k1_tail", "k1c_tail", "k1c_block",
     "k1c_update_block", "k12m_block", "k12mc_block", "k1a_block",
     "k1c_grad_block", "k1_block", "k1b_block", "k2_block", "k2c_block",
     "k2_split_block", "k2c_split_block", "k2_env_block", "k2c_env_block",
     "k1_tail_block", "k1c_tail_block"), 0)
#: Dispatches to each kernel's plain version since the last reset_counts().
PLAIN_CALLS: Dict[str, int] = dict(LAUNCHES)

#: Refresh bonds with chi >= SPLIT_TAIL_CHI take the split-tail route unless
#: the caller passes ``split_tail=``; None: never by default.  The port's
#: counterpart of pallas_bond.SPLIT_TAIL_FOOTPRINT, keyed on chi (the card
#: has no VMEM gate); its value is the large-chi timing of chip_smoke.py's
#: [split-tail-kernels] phase (PERF.md): with K1-tail over a cooperative
#: grid the split form beats the fused one from chi 192 (the smallest
#: measured) under ns and qr, and complex from 128.
SPLIT_TAIL_CHI: Optional[int] = 192

Out5 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
             torch.Tensor]
Out4 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


_count_lock = threading.Lock()


def count(table: Dict[str, int], key: str, n: int = 1) -> None:
    """Add ``n`` to ``table[key]`` (LAUNCHES or PLAIN_CALLS) under one lock,
    so that threads launching at once (``DeviceFarm``) lose no count."""
    with _count_lock:
        table[key] += n


def reset_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            PLAIN_CALLS[k] = 0


def counted_launch(kernel: str) -> Callable:
    """Decorator of a CUDA launch wrapper: each call that returns counts
    once under ``LAUNCHES[kernel]``, and under a profiler is the program
    span "mps/launch" (attribute ``kernel``) from entry to return."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def launch(*args, **kw):
            with profiling.annotate("mps/launch", kernel=kernel):
                out = fn(*args, **kw)
                count(LAUNCHES, kernel)
            return out
        return launch
    return wrap


def splits_tail(chi: int, split_tail: Optional[bool] = None) -> bool:
    """Whether a refresh bond of bond dimension ``chi`` takes the split-tail
    route: ``split_tail`` when given, else chi >= SPLIT_TAIL_CHI."""
    if split_tail is not None:
        return bool(split_tail)
    return SPLIT_TAIL_CHI is not None and chi >= SPLIT_TAIL_CHI


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _bond_tensor(A_or_B, center_c, forward: bool) -> torch.Tensor:
    """The bond tensor [chi, d, d, chi, C] (ops/bond_update.py's layout) of
    the static core and the class-major center."""
    if forward:
        return torch.einsum("caim,mkb->aikbc", center_c, A_or_B)
    return torch.einsum("aim,cmkb->aikbc", A_or_B, center_c)


def _class_major(BT: torch.Tensor) -> torch.Tensor:
    """[chi, d, d, chi, C] -> the kernels' [C, chi*d, d, chi]."""
    chi, d, _, _, C = BT.shape
    return BT.permute(4, 0, 1, 2, 3).reshape(C, chi * d, d, chi).contiguous()


def _grad(BT, le, re, phil, phir, y1h, w, gls, loss: str) -> torch.Tensor:
    """The KLD or MSE gradient of BT [chi, d, d, chi, C] over the batch
    (ops/bond_update.py, which takes the features unconjugated)."""
    if loss not in ("KLD", "MSE"):
        raise ValueError(f"loss={loss}: the bond kernels cover KLD and MSE")
    loss_grad = kld_loss_grad if loss == "KLD" else mse_loss_grad
    return loss_grad(BT, le, re, phil.conj(), phir.conj(), y1h, w, gls)[1]


def _step(BT, G, eta, bbopt: str) -> torch.Tensor:
    """The TSGO or GD step of BT against G, then renormalisation
    (ops/bond_update.apply_update at one iteration, rescale (False, True))."""
    if bbopt not in ("TSGO", "GD"):
        raise ValueError(f"bbopt={bbopt}: the bond kernels cover TSGO and GD")
    if bbopt == "TSGO":
        G = G / torch.linalg.vector_norm(G)
    BT = BT - eta * G
    return BT / torch.linalg.vector_norm(BT)


def _power(BT, V0, *, forward: bool, emit_y: bool, power_iters: int,
           orth: str) -> torch.Tensor:
    """Y [chi*d, chi]: q warm power steps of the stepped BT from V0 (the
    column-normalised iterate under orth="qr", orthonormal under "ns" and
    "tri"), or V0 itself for a frozen bond."""
    if not emit_y:
        return V0
    chi, d, _, _, C = BT.shape
    if forward:
        M = BT.reshape(chi * d, d * chi * C)
        return warm_iterate(lambda Yp: M @ (M.conj().T @ Yp), V0,
                            power_iters, orth)
    M = BT.permute(0, 1, 4, 2, 3).reshape(chi * d * C, d * chi)
    return warm_iterate(lambda Yp: M.conj().T @ (M @ Yp), V0, power_iters,
                        orth)


def k1_tail_plain(BT, V0, *, forward: bool, power_iters: int = 1,
                  orth: str = "qr") -> torch.Tensor:
    """K1-tail in plain PyTorch, real or complex: ``power_iters`` warm power
    steps of the stored bond tensor BT [C, chi*d, d, chi] (K1's, stepped)
    from V0, as K1's own tail (``_power``).  Returns Y [chi*d, chi]."""
    C, P, d, chi = BT.shape
    BT5 = BT.reshape(C, chi, d, d, chi).permute(1, 2, 3, 4, 0).contiguous()
    return _power(BT5, V0, forward=forward, emit_y=True,
                  power_iters=power_iters, orth=orth).contiguous()


def k1a_plain(A_or_B, center_c, le, re, phil, phir, y1h, w, gls, *,
              forward: bool, loss: str = "KLD") -> torch.Tensor:
    """K1a in plain PyTorch: the gradient G [C, chi*d, d, chi] of this
    batch's KLD or MSE loss at the bond tensor of A_or_B and center_c (the
    KLD sign included, as _k1_grad_kernel emits -G, pallas_bond.py:521-524).
    ``gls`` [N]: the total log-scales, read by the MSE gradient only."""
    BT = _bond_tensor(A_or_B, center_c, forward)
    return _class_major(_grad(BT, le, re, phil, phir, y1h, w, gls, loss))


def k1b_plain(A_or_B, center_c, G, V0, eta, *, forward: bool,
              emit_y: bool = True, power_iters: int = 1, orth: str = "qr",
              bbopt: str = "TSGO") -> Tuple[torch.Tensor, torch.Tensor]:
    """K1b in plain PyTorch: the TSGO or GD step of the bond tensor against
    the reduced gradient G [C, chi*d, d, chi] (TSGO's norm is G's), then
    renormalisation and the power step.  Returns (BT [C, chi*d, d, chi],
    Y [chi*d, chi]) as ``k1_plain``."""
    C, chi, d, _ = center_c.shape
    # contiguous in K1's layout, so that its norm sums in K1's order
    G5 = G.reshape(C, chi, d, d, chi).permute(1, 2, 3, 4, 0).contiguous()
    BT = _step(_bond_tensor(A_or_B, center_c, forward), G5, eta, bbopt)
    Y = _power(BT, V0, forward=forward, emit_y=emit_y,
               power_iters=power_iters, orth=orth)
    return _class_major(BT), Y.contiguous()


def k1_plain(A_or_B, center_c, le, re, phil, phir, y1h, w, gls, V0, eta, *,
             forward: bool, emit_y: bool = True, power_iters: int = 1,
             orth: str = "qr", loss: str = "KLD", bbopt: str = "TSGO"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 in plain PyTorch, real or complex: the bond tensor, the gradient
    step (ops/bond_update.py) and q warm power steps.  ``gls`` [N]: the total
    log-scales le_ls + re_ls (read by the MSE gradient only).  Returns
    (BT [C, chi*d, d, chi], Y [chi*d, chi]); Y is the column-normalised
    iterate under orth="qr", orthonormal under "ns" and "tri" (K12cr's
    refresh, ``decomp.tri_newton``), and V0 itself when ``emit_y`` is False
    (a frozen bond)."""
    BT = _bond_tensor(A_or_B, center_c, forward)
    BT = _step(BT, _grad(BT, le, re, phil, phir, y1h, w, gls, loss), eta,
               bbopt)
    Y = _power(BT, V0, forward=forward, emit_y=emit_y,
               power_iters=power_iters, orth=orth)
    return _class_major(BT), Y.contiguous()


def k2_split_plain(BT, Q, cutoff, *, forward: bool, max_rank=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2-split in plain PyTorch: the split of BT [C, chi*d, d, chi]
    against the orthonormal basis Q [chi*d, chi] (ops/decomp.py's warm split
    of a frozen bond).  Returns (center_c', core', Qm), Qm [chi*d, chi] the
    masked isometry Q * mask that the environments advance through."""
    C, P, d, chi = BT.shape
    if forward:
        M = BT.permute(1, 2, 3, 0).reshape(P, d * chi * C)
        U, SVh, _ = warm_split_right(M, Q, chi, cutoff, refresh=False,
                                     max_rank=max_rank)
        center = SVh.reshape(chi, d, chi, C).permute(3, 0, 1, 2)
        Qm = U
    else:
        M = BT.permute(1, 0, 2, 3).reshape(P * C, d * chi)
        US, Vh, _ = warm_split_left(M, Q, chi, cutoff, refresh=False,
                                    max_rank=max_rank)
        center = US.reshape(chi, d, C, chi).permute(2, 0, 1, 3)
        Qm = Vh.conj().T.resolve_conj()
    return (center.contiguous(), _core_of(Qm, forward).contiguous(),
            Qm.contiguous())


def _core_of(Qm, forward: bool) -> torch.Tensor:
    """The emitted core [chi, d, chi] of the masked isometry: U = Qm
    forward, V = Qm^H backward."""
    P, chi = Qm.shape
    if forward:
        return Qm.reshape(chi, P // chi, chi)
    return Qm.conj().T.resolve_conj().reshape(chi, P // chi, chi)


def k2_env_plain(Qm, env, env_ls, phi, *, forward: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2-env in plain PyTorch: the scaled step of the advancing environment
    (``env``, ``env_ls``, ``phi``: le / phil forward, re / phir backward)
    through the masked isometry Qm.  Returns (env', env_ls')."""
    step = env_step_left_scaled if forward else env_step_right_scaled
    return step(env, env_ls, _core_of(Qm, forward), phi)


def k2_plain(BT, Q, env, env_ls, phi, cutoff, *, forward: bool,
             max_rank=None) -> Out4:
    """K2 in plain PyTorch: ``k2_split_plain`` then ``k2_env_plain``.
    Returns (center_c', core', env', env_ls')."""
    center, core, Qm = k2_split_plain(BT, Q, cutoff, forward=forward,
                                      max_rank=max_rank)
    return (center, core) + k2_env_plain(Qm, env, env_ls, phi,
                                         forward=forward)


def k12_plain(A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0,
              eta, cutoff, *, forward: bool, refresh: bool = True,
              power_iters: int = 1, max_rank=None, loss: str = "KLD",
              bbopt: str = "TSGO", opp_ls=None) -> Out5:
    """One bond step in plain PyTorch, with K12's operands: ``k1_plain``
    with the Newton-Schulz power step, then ``k2_plain`` against its basis.
    Returns (center_c', core', env', env_ls', Q')."""
    gls = env_ls + opp_ls if loss == "MSE" else env_ls
    BT, Q = k1_plain(A_or_B, center_c, le, re, phil, phir, y1h, w, gls, V0,
                     eta, forward=forward, emit_y=refresh,
                     power_iters=power_iters, orth="ns", loss=loss,
                     bbopt=bbopt)
    env, phi = (le, phil) if forward else (re, phir)
    return k2_plain(BT, Q, env, env_ls, phi, cutoff, forward=forward,
                    max_rank=max_rank) + (Q,)


def k12m_plain(A_blk, center_c, envx_blk, env0, env_ls0, phil_blk, phir_blk,
               y1h, w, V0_blk, eta, cutoff, *, forward: bool,
               refresh: bool = True, power_iters: int = 1, max_rank=None,
               bbopt: str = "TSGO") -> Out5:
    """Bb chained ``k12_plain`` steps with K12m's blocked operands (KLD).
    Returns (center_c', core_blk, env_blk, env_ls_blk, Q_blk)."""
    env, ls, center = env0, env_ls0, center_c
    outs = []
    for b in range(A_blk.shape[0]):
        le, re = (env, envx_blk[b]) if forward else (envx_blk[b], env)
        center, core, env, ls, Q = k12_plain(
            A_blk[b], center, le, re, ls, phil_blk[b], phir_blk[b], y1h, w,
            V0_blk[b], eta, cutoff, forward=forward, refresh=refresh,
            power_iters=power_iters, max_rank=max_rank, bbopt=bbopt)
        outs.append((core, env, ls, Q))
    core_b, env_b, ls_b, q_b = (torch.stack(x) for x in zip(*outs))
    return center, core_b, env_b, ls_b, q_b


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

#: An ``expect`` entry's marker for a real (float32) operand.
REAL = "real"


def _check_operands(dev: torch.device, expect,
                    dtype: torch.dtype = torch.float32) -> None:
    """Every operand on ``dev``, of its shape, contiguous, and of ``dtype``
    (the kernel's scalar type) unless its entry names float32 (labels,
    weights and log-scales are real in every kernel)."""
    for name, (t, shape, *real) in expect.items():
        want = torch.float32 if real else dtype
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, center_c on {dev}")
        if t.dtype != want:
            raise ValueError(f"{name} must be "
                             f"{str(want).replace('torch.', '')}, got "
                             f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _empty(dev: torch.device, *shape: int,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=dev)


def _launch_k12m(A_blk, center_c, envx_blk, env0, env_ls0, opp_ls, phil_blk,
                 phir_blk, y1h, w, V0_blk, eta, cutoff, *, forward: bool,
                 refresh: bool, power_iters: int, max_rank, loss: str,
                 bbopt: str, launch: Callable[..., None],
                 workspace_floats: Callable[[int, int, int, int], int],
                 dtype: torch.dtype = torch.float32) -> Out5:
    """Check K12m's (or K12mc's) operands, allocate its outputs and
    workspace on the operands' device, and hand everything to ``launch`` in
    the kernel's C argument order; ``dtype`` is the kernel's scalar type."""
    if A_blk.dim() != 4 or center_c.dim() != 4:
        raise ValueError(f"A_blk must be [Bb, chi, d, chi] and center_c "
                         f"[C, chi, d, chi]; got {tuple(A_blk.shape)} and "
                         f"{tuple(center_c.shape)}")
    Bb, chi, d, _ = A_blk.shape
    C = center_c.shape[0]
    N = env0.shape[0]
    expect = {
        "A_blk": (A_blk, (Bb, chi, d, chi)),
        "center_c": (center_c, (C, chi, d, chi)),
        "envx_blk": (envx_blk, (Bb, N, chi)),
        "env0": (env0, (N, chi)),
        "env_ls0": (env_ls0, (N,), REAL),
        "phil_blk": (phil_blk, (Bb, N, d)),
        "phir_blk": (phir_blk, (Bb, N, d)),
        "y1h": (y1h, (N, C), REAL),
        "w": (w, (N,), REAL),
        "V0_blk": (V0_blk, (Bb, chi * d, chi)),
    }
    if loss == "MSE":
        expect["opp_ls"] = (opp_ls, (N,), REAL)
    dev = center_c.device
    _check_operands(dev, expect, dtype)
    if Bb < 1 or power_iters < 1:
        raise ValueError(f"need Bb >= 1 and power_iters >= 1, got {Bb}, "
                         f"{power_iters}")
    center2 = _empty(dev, C, chi, d, chi, dtype=dtype)
    core_b = _empty(dev, Bb, chi, d, chi, dtype=dtype)
    env_b = _empty(dev, Bb, N, chi, dtype=dtype)
    ls_b = _empty(dev, Bb, N)
    q_b = _empty(dev, Bb, chi * d, chi, dtype=dtype)
    ws = _empty(dev, workspace_floats(C, chi, d, N))
    mr = float(chi) if max_rank is None else float(max_rank)
    launch(A_blk.data_ptr(), center_c.data_ptr(), envx_blk.data_ptr(),
           env0.data_ptr(), env_ls0.data_ptr(),
           opp_ls.data_ptr() if loss == "MSE" else None,
           phil_blk.data_ptr(), phir_blk.data_ptr(), y1h.data_ptr(),
           w.data_ptr(), V0_blk.data_ptr(), center2.data_ptr(),
           core_b.data_ptr(), env_b.data_ptr(), ls_b.data_ptr(),
           q_b.data_ptr(), ws.data_ptr(), Bb, C, chi, d, N, int(forward),
           int(refresh), int(power_iters), int(loss == "MSE"),
           int(bbopt == "GD"), float(eta), float(cutoff), mr)
    return center2, core_b, env_b, ls_b, q_b


def _launch_k1(A_or_B, center_c, le, re, phil, phir, y1h, w, gls, V0, eta,
               *, forward: bool, emit_y: bool, power_iters: int, orth: str,
               loss: str, bbopt: str, launch: Callable[..., None],
               workspace_floats: Callable[[int, int, int, int], int],
               dtype: torch.dtype = torch.float32
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check K1's (or K1c's) operands, allocate BT, Y and the workspace,
    and hand everything to ``launch`` in the kernel's C argument order."""
    if center_c.dim() != 4:
        raise ValueError(f"center_c must be [C, chi, d, chi], got "
                         f"{tuple(center_c.shape)}")
    C, chi, d, _ = center_c.shape
    N, P = le.shape[0], chi * d
    expect = {
        "A_or_B": (A_or_B, (chi, d, chi)),
        "center_c": (center_c, (C, chi, d, chi)),
        "le": (le, (N, chi)), "re": (re, (N, chi)),
        "phil": (phil, (N, d)), "phir": (phir, (N, d)),
        "y1h": (y1h, (N, C), REAL), "w": (w, (N,), REAL),
        "V0": (V0, (P, chi)),
    }
    if loss == "MSE":
        expect["gls"] = (gls, (N,), REAL)
    dev = center_c.device
    _check_operands(dev, expect, dtype)
    if power_iters < 1 or orth not in ("qr", "ns"):
        raise ValueError(f"need power_iters >= 1 and orth 'qr' or 'ns', got "
                         f"{power_iters}, {orth!r}")
    BT = _empty(dev, C, P, d, chi, dtype=dtype)
    Y = _empty(dev, P, chi, dtype=dtype)
    ws = _empty(dev, workspace_floats(C, chi, d, N))
    launch(A_or_B.data_ptr(), center_c.data_ptr(), le.data_ptr(),
           re.data_ptr(), gls.data_ptr() if loss == "MSE" else None,
           phil.data_ptr(), phir.data_ptr(), y1h.data_ptr(), w.data_ptr(),
           V0.data_ptr(), BT.data_ptr(), Y.data_ptr(), ws.data_ptr(), C, chi,
           d, N, int(forward), int(emit_y), int(power_iters),
           int(orth == "qr"), int(loss == "MSE"), int(bbopt == "GD"),
           float(eta))
    return BT, Y


def _launch_k2(BT, Q, env, env_ls, phi, cutoff, *, forward: bool, max_rank,
               launch: Callable[..., None],
               workspace_floats: Callable[[int, int, int, int], int],
               dtype: torch.dtype = torch.float32) -> Out4:
    """Check K2's (or K2c's) operands, allocate its outputs and workspace,
    and hand everything to ``launch`` in the kernel's C argument order."""
    if BT.dim() != 4:
        raise ValueError(f"BT must be [C, chi*d, d, chi], got "
                         f"{tuple(BT.shape)}")
    C, P, d, chi = BT.shape
    N = env.shape[0]
    expect = {
        "BT": (BT, (C, chi * d, d, chi)), "Q": (Q, (P, chi)),
        "env": (env, (N, chi)), "env_ls": (env_ls, (N,), REAL),
        "phi": (phi, (N, d)),
    }
    dev = BT.device
    _check_operands(dev, expect, dtype)
    center2 = _empty(dev, C, chi, d, chi, dtype=dtype)
    core = _empty(dev, chi, d, chi, dtype=dtype)
    env2 = _empty(dev, N, chi, dtype=dtype)
    ls2 = _empty(dev, N)
    ws = _empty(dev, workspace_floats(C, chi, d, N))
    mr = float(chi) if max_rank is None else float(max_rank)
    launch(BT.data_ptr(), Q.data_ptr(), env.data_ptr(), env_ls.data_ptr(),
           phi.data_ptr(), center2.data_ptr(), core.data_ptr(),
           env2.data_ptr(), ls2.data_ptr(), ws.data_ptr(), C, chi, d, N,
           int(forward), float(cutoff), mr)
    return center2, core, env2, ls2


def _launch_k1a(A_or_B, center_c, le, re, phil, phir, y1h, w, gls, *,
                forward: bool, loss: str, launch: Callable[..., None],
                workspace_floats: Callable[[int, int, int, int], int],
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Check K1a's operands, allocate G and the workspace, and hand
    everything to ``launch`` in the kernel's C argument order."""
    if center_c.dim() != 4:
        raise ValueError(f"center_c must be [C, chi, d, chi], got "
                         f"{tuple(center_c.shape)}")
    C, chi, d, _ = center_c.shape
    N, P = le.shape[0], chi * d
    expect = {
        "A_or_B": (A_or_B, (chi, d, chi)),
        "center_c": (center_c, (C, chi, d, chi)),
        "le": (le, (N, chi)), "re": (re, (N, chi)),
        "phil": (phil, (N, d)), "phir": (phir, (N, d)),
        "y1h": (y1h, (N, C), REAL), "w": (w, (N,), REAL),
    }
    if loss == "MSE":
        expect["gls"] = (gls, (N,), REAL)
    dev = center_c.device
    _check_operands(dev, expect, dtype)
    G = _empty(dev, C, P, d, chi, dtype=dtype)
    ws = _empty(dev, workspace_floats(C, chi, d, N))
    launch(A_or_B.data_ptr(), center_c.data_ptr(), le.data_ptr(),
           re.data_ptr(), gls.data_ptr() if loss == "MSE" else None,
           phil.data_ptr(), phir.data_ptr(), y1h.data_ptr(), w.data_ptr(),
           G.data_ptr(), ws.data_ptr(), C, chi, d, N, int(forward),
           int(loss == "MSE"))
    return G


def _launch_k1b(A_or_B, center_c, G, V0, eta, *, forward: bool,
                emit_y: bool, power_iters: int, orth: str, bbopt: str,
                launch: Callable[..., None],
                workspace_floats: Callable[[int, int, int, int], int],
                dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check K1b's operands, allocate BT, Y and the workspace (no batch
    terms), and hand everything to ``launch`` in the kernel's C argument
    order."""
    if center_c.dim() != 4:
        raise ValueError(f"center_c must be [C, chi, d, chi], got "
                         f"{tuple(center_c.shape)}")
    C, chi, d, _ = center_c.shape
    P = chi * d
    dev = center_c.device
    _check_operands(dev, {
        "A_or_B": (A_or_B, (chi, d, chi)),
        "center_c": (center_c, (C, chi, d, chi)),
        "G": (G, (C, P, d, chi)), "V0": (V0, (P, chi))}, dtype)
    if power_iters < 1 or orth not in ("qr", "ns"):
        raise ValueError(f"need power_iters >= 1 and orth 'qr' or 'ns', got "
                         f"{power_iters}, {orth!r}")
    BT = _empty(dev, C, P, d, chi, dtype=dtype)
    Y = _empty(dev, P, chi, dtype=dtype)
    ws = _empty(dev, workspace_floats(C, chi, d, 0))
    launch(A_or_B.data_ptr(), center_c.data_ptr(), G.data_ptr(),
           V0.data_ptr(), BT.data_ptr(), Y.data_ptr(), ws.data_ptr(), C, chi,
           d, int(forward), int(emit_y), int(power_iters), int(orth == "qr"),
           int(bbopt == "GD"), float(eta))
    return BT, Y


def _launch_k1_tail(BT, V0, *, forward: bool, power_iters: int, orth: str,
                    launch: Callable[..., None],
                    workspace_floats: Callable[[int, int, int, int], int],
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Check K1-tail's operands, allocate Y and the workspace (no batch
    terms), and hand everything to ``launch`` in the kernel's C argument
    order."""
    if BT.dim() != 4:
        raise ValueError(f"BT must be [C, chi*d, d, chi], got "
                         f"{tuple(BT.shape)}")
    C, P, d, chi = BT.shape
    dev = BT.device
    _check_operands(dev, {"BT": (BT, (C, chi * d, d, chi)),
                          "V0": (V0, (P, chi))}, dtype)
    if power_iters < 1 or orth not in ("qr", "ns"):
        raise ValueError(f"need power_iters >= 1 and orth 'qr' or 'ns', got "
                         f"{power_iters}, {orth!r}")
    Y = _empty(dev, P, chi, dtype=dtype)
    ws = _empty(dev, workspace_floats(C, chi, d, 0))
    launch(BT.data_ptr(), V0.data_ptr(), Y.data_ptr(), ws.data_ptr(), C, chi,
           d, int(forward), int(power_iters), int(orth == "qr"))
    return Y


def _launch_k2_split(BT, Q, cutoff, *, forward: bool, max_rank,
                     launch: Callable[..., None],
                     workspace_floats: Callable[[int, int, int, int], int],
                     dtype: torch.dtype = torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check K2-split's operands, allocate the center, core, Qm and the
    workspace (no batch terms), and hand everything to ``launch``."""
    if BT.dim() != 4:
        raise ValueError(f"BT must be [C, chi*d, d, chi], got "
                         f"{tuple(BT.shape)}")
    C, P, d, chi = BT.shape
    dev = BT.device
    _check_operands(dev, {"BT": (BT, (C, chi * d, d, chi)),
                          "Q": (Q, (P, chi))}, dtype)
    center2 = _empty(dev, C, chi, d, chi, dtype=dtype)
    core = _empty(dev, chi, d, chi, dtype=dtype)
    Qm = _empty(dev, P, chi, dtype=dtype)
    ws = _empty(dev, workspace_floats(C, chi, d, 0))
    mr = float(chi) if max_rank is None else float(max_rank)
    launch(BT.data_ptr(), Q.data_ptr(), center2.data_ptr(), core.data_ptr(),
           Qm.data_ptr(), ws.data_ptr(), C, chi, d, int(forward),
           float(cutoff), mr)
    return center2, core, Qm


def _launch_k2_env(Qm, env, env_ls, phi, *, forward: bool,
                   launch: Callable[..., None],
                   workspace_floats: Callable[[int, int, int, int], int],
                   dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check K2-env's operands, allocate env', env_ls' and the workspace
    (the batch factor only), and hand everything to ``launch``."""
    if Qm.dim() != 2 or env.dim() != 2:
        raise ValueError(f"Qm must be [chi*d, chi] and env [N, chi]; got "
                         f"{tuple(Qm.shape)} and {tuple(env.shape)}")
    P, chi = Qm.shape
    N, d = env.shape[0], P // chi
    dev = Qm.device
    _check_operands(dev, {"Qm": (Qm, (chi * d, chi)), "env": (env, (N, chi)),
                          "env_ls": (env_ls, (N,), REAL),
                          "phi": (phi, (N, d))}, dtype)
    env2 = _empty(dev, N, chi, dtype=dtype)
    ls2 = _empty(dev, N)
    ws = _empty(dev, workspace_floats(0, chi, d, N))
    launch(Qm.data_ptr(), env.data_ptr(), env_ls.data_ptr(), phi.data_ptr(),
           env2.data_ptr(), ls2.data_ptr(), ws.data_ptr(), chi, d, N,
           int(forward))
    return env2, ls2


def _cuda_launch(device: torch.device, entry: str,
                 workspace: str = "mpst_k12_workspace_floats"):
    """(launch, workspace_floats) for the built library's ``entry`` on
    ``device``, with the workspace size function ``workspace``."""
    from ..kernels.build import load_library
    lib = load_library()
    fn = getattr(lib, entry)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream

    def launch(*args):
        with torch.cuda.device(index):      # the stream's device is current
            rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{entry} failed: CUDA error {rc} "
                               f"({lib.mpst_error_string(rc).decode()})")

    return launch, getattr(lib, workspace)


#: Thread blocks in the cluster that runs K12m, and K12 (its Bb = 1), from
#: its times by cluster size on the card (chip_smoke.py's
#: [k12m-k12mc-cluster]).
K12M_CLUSTER = 16
#: Thread blocks in the cluster of K1a, from its times by cluster size on
#: the card (chip_smoke.py's [k1a-k1c-grad-cluster]).
K1A_CLUSTER = 16
#: Thread blocks in the clusters of K1 and K1b, from their times by cluster
#: size on the card (chip_smoke.py's [k1-k1b-cluster]).
K1_CLUSTER = 16
K1B_CLUSTER = 16
#: Thread blocks in the clusters of K2 and K2-split, from their times by
#: cluster size on the card (chip_smoke.py's [k2-k2split-cluster]).
K2_CLUSTER = 16
K2_SPLIT_CLUSTER = 16
#: The largest cluster a launch may ask for (Hopper's non-portable limit).
MAX_CLUSTER = 16
#: Rows of the batch each block of K2-env advances: its grid is
#: ceil(N / K2_ENV_ROWS) independent blocks, from its times by rows a block
#: on the card at N 100, 50 and 32 (chip_smoke.py's
#: [k2env-k1tail-redesign]).
K2_ENV_ROWS = 8
#: The most rows a K2-env block may take: a thread of its renormalisation
#: for each row (kMaxThreads).
MAX_ENV_ROWS = 512
#: Blocks of the cooperative grid that runs K1-tail, from its times by grid
#: size at chi 192, 256 and 320 on the card ([k2env-k1tail-redesign]); a
#: grid past what the card holds at once (``grid_occupancy``) is refused by
#: the card.
K1_TAIL_BLOCKS = 132
#: Each cluster kernel's occupancy query: the library entry and the kernel's
#: index there (csrc/bond_step.cu answers for the real cluster K12m, which
#: K12 launches too, K1a, K1, K1b, K2 and K2-split, csrc/bond_step_c.cu for
#: the complex kernels).
_OCCUPANCY = {"k12c": ("mpst_c_cluster_occupancy", 0),
              "k12cr": ("mpst_c_cluster_occupancy", 1),
              "k1c": ("mpst_c_cluster_occupancy", 2),
              "k1c_update": ("mpst_c_cluster_occupancy", 3),
              "k12m": ("mpst_cluster_occupancy", 0),
              "k12mc": ("mpst_c_cluster_occupancy", 4),
              "k1a": ("mpst_cluster_occupancy", 1),
              "k1c_grad": ("mpst_c_cluster_occupancy", 5),
              "k1": ("mpst_cluster_occupancy", 2),
              "k1b": ("mpst_cluster_occupancy", 3),
              "k2": ("mpst_cluster_occupancy", 4),
              "k2_split": ("mpst_cluster_occupancy", 5),
              "k2c": ("mpst_c_cluster_occupancy", 6),
              "k2c_split": ("mpst_c_cluster_occupancy", 7)}
#: The cluster kernels cluster_occupancy answers for.
CLUSTER_KERNELS = tuple(_OCCUPANCY)


def _cluster_size(cluster) -> int:
    """``cluster`` if it is an integer from 1 to MAX_CLUSTER, else
    ValueError (before any library load)."""
    if (isinstance(cluster, bool) or not isinstance(cluster, numbers.Integral)
            or not 1 <= cluster <= MAX_CLUSTER):
        raise ValueError(f"cluster must be an integer from 1 to "
                         f"{MAX_CLUSTER}, got {cluster!r}")
    return int(cluster)


def cluster_occupancy(kernel: str, cluster: int, chi: int) -> int:
    """How many clusters of ``cluster`` blocks of the cluster kernel
    ``kernel`` (one of CLUSTER_KERNELS) at bond width ``chi`` the current
    card holds at once (0: it cannot place one), from
    ``cudaOccupancyMaxActiveClusters``."""
    if kernel not in CLUSTER_KERNELS:
        raise ValueError(f"kernel must be one of {CLUSTER_KERNELS}, got "
                         f"{kernel!r}")
    n_blocks = _cluster_size(cluster)
    from ..kernels.build import load_library
    lib = load_library()
    entry, index = _OCCUPANCY[kernel]
    n = ctypes.c_int(0)
    rc = getattr(lib, entry)(index, n_blocks, int(chi), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cluster occupancy query failed: CUDA error {rc} "
                           f"({lib.mpst_error_string(rc).decode()})")
    return n.value


def _env_rows(rows) -> int:
    """``rows`` if it is an integer from 1 to MAX_ENV_ROWS, else ValueError
    (before any library load)."""
    if (isinstance(rows, bool) or not isinstance(rows, numbers.Integral)
            or not 1 <= rows <= MAX_ENV_ROWS):
        raise ValueError(f"rows must be an integer from 1 to "
                         f"{MAX_ENV_ROWS}, got {rows!r}")
    return int(rows)


def _grid_blocks(blocks) -> int:
    """``blocks`` if it is a positive integer, else ValueError (before any
    library load); whether the card holds that many at once is the
    launch's to say."""
    if (isinstance(blocks, bool) or not isinstance(blocks, numbers.Integral)
            or blocks < 1):
        raise ValueError(f"blocks must be a positive integer, got "
                         f"{blocks!r}")
    return int(blocks)


#: Each grid kernel's occupancy query: the library entry and the kernel's
#: index there.
_GRID_OCCUPANCY = {"k1_tail": ("mpst_grid_occupancy", 0),
                   "k1c_tail": ("mpst_c_grid_occupancy", 0)}
#: The grid kernels grid_occupancy answers for.
GRID_KERNELS = tuple(_GRID_OCCUPANCY)


def grid_occupancy(kernel: str) -> int:
    """How many blocks of the grid kernel ``kernel`` (one of GRID_KERNELS)
    the current card holds at once, the largest grid it launches: blocks a
    SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) times SMs."""
    if kernel not in GRID_KERNELS:
        raise ValueError(f"kernel must be one of {GRID_KERNELS}, got "
                         f"{kernel!r}")
    from ..kernels.build import load_library
    lib = load_library()
    entry, index = _GRID_OCCUPANCY[kernel]
    n = ctypes.c_int(0)
    rc = getattr(lib, entry)(index, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"grid occupancy query failed: CUDA error {rc} "
                           f"({lib.mpst_error_string(rc).decode()})")
    return n.value


def _k12m(entry: str, extra: tuple, *args, **kw) -> Out5:
    """K12m's operands (``_launch_k12m``'s) checked and launched through the
    library's ``entry``, with ``extra`` after K12m's C arguments (the
    cluster size)."""
    launch, wsf = _cuda_launch(args[1].device, entry)
    return _launch_k12m(*args, launch=lambda *a: launch(*a, *extra),
                        workspace_floats=wsf, **kw)


def _k12m_cluster(cluster, *args, **kw) -> Out5:
    """K12m's operands (``_launch_k12m``'s) launched over a thread-block
    cluster of ``cluster`` blocks, checked before the library loads; a
    cluster the card cannot place raises RuntimeError."""
    return _k12m("mpst_k12m_cluster_launch", (_cluster_size(cluster),),
                 *args, **kw)


@counted_launch("k12")
def k12_cuda(A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0, eta,
             cutoff, *, forward: bool, refresh: bool = True,
             power_iters: int = 1, max_rank=None, loss: str = "KLD",
             bbopt: str = "TSGO", opp_ls=None) -> Out5:
    """K12: one bond step as one launch of the cluster K12m at Bb = 1, over
    ``K12M_CLUSTER`` blocks."""
    env, envx = (le, re) if forward else (re, le)
    center2, core, env2, ls2, Q = _k12m_cluster(
        K12M_CLUSTER, A_or_B[None], center_c, envx[None], env, env_ls,
        opp_ls, phil[None], phir[None], y1h, w, V0[None], eta, cutoff,
        forward=forward, refresh=refresh, power_iters=power_iters,
        max_rank=max_rank, loss=loss, bbopt=bbopt)
    return center2, core[0], env2[0], ls2[0], Q[0]


@counted_launch("k12m")
def k12m_cuda(A_blk, center_c, envx_blk, env0, env_ls0, phil_blk, phir_blk,
              y1h, w, V0_blk, eta, cutoff, *, forward: bool,
              refresh: bool = True, power_iters: int = 1, max_rank=None,
              bbopt: str = "TSGO") -> Out5:
    """K12m: Bb consecutive bond steps (KLD) as one launch of a
    thread-block cluster of ``K12M_CLUSTER`` blocks."""
    return _k12m_cluster(
        K12M_CLUSTER, A_blk, center_c, envx_blk, env0, env_ls0, None,
        phil_blk, phir_blk, y1h, w, V0_blk, eta, cutoff, forward=forward,
        refresh=refresh, power_iters=power_iters, max_rank=max_rank,
        loss="KLD", bbopt=bbopt)


@counted_launch("k12m_block")
def k12m_block_cuda(A_blk, center_c, envx_blk, env0, env_ls0, phil_blk,
                    phir_blk, y1h, w, V0_blk, eta, cutoff, *, forward: bool,
                    refresh: bool = True, power_iters: int = 1,
                    max_rank=None, loss: str = "KLD", bbopt: str = "TSGO",
                    opp_ls=None) -> Out5:
    """K12m on one thread block, the reference ``k12_cuda`` and
    ``k12m_cuda`` are held against bit for bit (no route calls it); K12m's
    operands, and the MSE loss with ``opp_ls`` as K12's."""
    return _k12m(
        "mpst_k12m_launch", (), A_blk, center_c, envx_blk, env0, env_ls0,
        opp_ls, phil_blk, phir_blk, y1h, w, V0_blk, eta, cutoff,
        forward=forward, refresh=refresh, power_iters=power_iters,
        max_rank=max_rank, loss=loss, bbopt=bbopt)


def _k1(entry: str, extra: tuple, *args, **kw
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's operands (``_launch_k1``'s) checked and launched through the
    library's ``entry``, with ``extra`` after K1's C arguments (the cluster
    size)."""
    launch, wsf = _cuda_launch(args[1].device, entry)
    return _launch_k1(*args, launch=lambda *a: launch(*a, *extra),
                      workspace_floats=wsf, **kw)


@counted_launch("k1")
def k1_cuda(A_or_B, center_c, le, re, phil, phir, y1h, w, gls, V0, eta, *,
            forward: bool, emit_y: bool = True, power_iters: int = 1,
            orth: str = "qr", loss: str = "KLD", bbopt: str = "TSGO",
            cluster: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 as one launch of a thread-block cluster of ``cluster`` blocks
    (default ``K1_CLUSTER``); operands and results as ``k1_plain``'s.  A
    cluster the card cannot place raises RuntimeError."""
    n = _cluster_size(K1_CLUSTER if cluster is None else cluster)
    return _k1("mpst_k1_cluster_launch", (n,), A_or_B, center_c, le, re, phil,
               phir, y1h, w, gls, V0, eta, forward=forward, emit_y=emit_y,
               power_iters=power_iters, orth=orth, loss=loss, bbopt=bbopt)


@counted_launch("k1_block")
def k1_block_cuda(A_or_B, center_c, le, re, phil, phir, y1h, w, gls, V0,
                  eta, *, forward: bool, emit_y: bool = True,
                  power_iters: int = 1, orth: str = "qr", loss: str = "KLD",
                  bbopt: str = "TSGO") -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on one thread block, the reference ``k1_cuda`` is held against
    bit for bit (no route calls it); operands and results as
    ``k1_plain``'s."""
    return _k1("mpst_k1_launch", (), A_or_B, center_c, le, re, phil, phir,
               y1h, w, gls, V0, eta, forward=forward, emit_y=emit_y,
               power_iters=power_iters, orth=orth, loss=loss, bbopt=bbopt)


def _k2(entry: str, extra: tuple, *args, **kw) -> Out4:
    """K2's operands (``_launch_k2``'s) checked and launched through the
    library's ``entry``, with ``extra`` after K2's C arguments (the parts
    to run, the cluster size)."""
    launch, wsf = _cuda_launch(args[0].device, entry)
    return _launch_k2(*args, launch=lambda *a: launch(*a, *extra),
                      workspace_floats=wsf, **kw)


@counted_launch("k2")
def k2_cuda(BT, Q, env, env_ls, phi, cutoff, *, forward: bool,
            max_rank=None, cluster: Optional[int] = None) -> Out4:
    """K2 as one launch of a thread-block cluster of ``cluster`` blocks
    (default ``K2_CLUSTER``); operands and results as ``k2_plain``'s.  A
    cluster the card cannot place raises RuntimeError."""
    n = _cluster_size(K2_CLUSTER if cluster is None else cluster)
    return _k2("mpst_k2_cluster_launch", (n,), BT, Q, env, env_ls, phi,
               cutoff, forward=forward, max_rank=max_rank)


@counted_launch("k2_block")
def k2_block_cuda(BT, Q, env, env_ls, phi, cutoff, *, forward: bool,
                  max_rank=None) -> Out4:
    """K2 on one thread block, the reference ``k2_cuda`` is held against
    bit for bit (no route calls it); operands and results as
    ``k2_plain``'s."""
    return _k2("mpst_k2_launch", (), BT, Q, env, env_ls, phi, cutoff,
               forward=forward, max_rank=max_rank)


def _k1a(entry: str, extra: tuple, *args, **kw) -> torch.Tensor:
    """K1a's operands (``_launch_k1a``'s) checked and launched through the
    library's ``entry``, with ``extra`` after K1a's C arguments (the cluster
    size)."""
    launch, wsf = _cuda_launch(args[1].device, entry)
    return _launch_k1a(*args, launch=lambda *a: launch(*a, *extra),
                       workspace_floats=wsf, **kw)


@counted_launch("k1a")
def k1a_cuda(A_or_B, center_c, le, re, phil, phir, y1h, w, gls, *,
             forward: bool, loss: str = "KLD",
             cluster: Optional[int] = None) -> torch.Tensor:
    """K1a as one launch of a thread-block cluster of ``cluster`` blocks
    (default ``K1A_CLUSTER``); operands and result as ``k1a_plain``'s.  A
    cluster the card cannot place raises RuntimeError."""
    n = _cluster_size(K1A_CLUSTER if cluster is None else cluster)
    return _k1a("mpst_k1a_cluster_launch", (n,), A_or_B, center_c, le, re,
                phil, phir, y1h, w, gls, forward=forward, loss=loss)


@counted_launch("k1a_block")
def k1a_block_cuda(A_or_B, center_c, le, re, phil, phir, y1h, w, gls, *,
                   forward: bool, loss: str = "KLD") -> torch.Tensor:
    """K1a on one thread block, the reference ``k1a_cuda`` is held against
    bit for bit (no route calls it); operands and result as
    ``k1a_plain``'s."""
    return _k1a("mpst_k1a_launch", (), A_or_B, center_c, le, re, phil, phir,
                y1h, w, gls, forward=forward, loss=loss)


def _k1b(entry: str, extra: tuple, *args, **kw
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1b's operands (``_launch_k1b``'s) checked and launched through the
    library's ``entry``, with ``extra`` after K1b's C arguments (the
    cluster size)."""
    launch, wsf = _cuda_launch(args[1].device, entry)
    return _launch_k1b(*args, launch=lambda *a: launch(*a, *extra),
                       workspace_floats=wsf, **kw)


@counted_launch("k1b")
def k1b_cuda(A_or_B, center_c, G, V0, eta, *, forward: bool,
             emit_y: bool = True, power_iters: int = 1, orth: str = "qr",
             bbopt: str = "TSGO", cluster: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1b as one launch of a thread-block cluster of ``cluster`` blocks
    (default ``K1B_CLUSTER``); operands and results as ``k1b_plain``'s.  A
    cluster the card cannot place raises RuntimeError."""
    n = _cluster_size(K1B_CLUSTER if cluster is None else cluster)
    return _k1b("mpst_k1b_cluster_launch", (n,), A_or_B, center_c, G, V0, eta,
                forward=forward, emit_y=emit_y, power_iters=power_iters,
                orth=orth, bbopt=bbopt)


@counted_launch("k1b_block")
def k1b_block_cuda(A_or_B, center_c, G, V0, eta, *, forward: bool,
                   emit_y: bool = True, power_iters: int = 1,
                   orth: str = "qr", bbopt: str = "TSGO"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1b on one thread block, the reference ``k1b_cuda`` is held against
    bit for bit (no route calls it); operands and results as
    ``k1b_plain``'s."""
    return _k1b("mpst_k1b_launch", (), A_or_B, center_c, G, V0, eta,
                forward=forward, emit_y=emit_y, power_iters=power_iters,
                orth=orth, bbopt=bbopt)


def _k1_tail(entry: str, extra: tuple, *args, **kw) -> torch.Tensor:
    """K1-tail's operands (``_launch_k1_tail``'s) checked and launched
    through the library's ``entry``, with ``extra`` after K1-tail's C
    arguments (the grid size)."""
    launch, wsf = _cuda_launch(args[0].device, entry)
    return _launch_k1_tail(*args, launch=lambda *a: launch(*a, *extra),
                           workspace_floats=wsf, **kw)


@counted_launch("k1_tail")
def k1_tail_cuda(BT, V0, *, forward: bool, power_iters: int = 1,
                 orth: str = "qr", blocks: Optional[int] = None
                 ) -> torch.Tensor:
    """K1-tail as one launch of a cooperative grid of ``blocks`` blocks
    (default ``K1_TAIL_BLOCKS``); operands and result as
    ``k1_tail_plain``'s.  A grid the card cannot hold at once raises
    RuntimeError."""
    n = _grid_blocks(K1_TAIL_BLOCKS if blocks is None else blocks)
    return _k1_tail("mpst_k1_tail_grid_launch", (n,), BT, V0, forward=forward,
                    power_iters=power_iters, orth=orth)


@counted_launch("k1_tail_block")
def k1_tail_block_cuda(BT, V0, *, forward: bool, power_iters: int = 1,
                       orth: str = "qr") -> torch.Tensor:
    """K1-tail on one thread block, the reference ``k1_tail_cuda`` is held
    against bit for bit (no route calls it); operands and result as
    ``k1_tail_plain``'s."""
    return _k1_tail("mpst_k1_tail_launch", (), BT, V0, forward=forward,
                    power_iters=power_iters, orth=orth)


def _k2_split(entry: str, extra: tuple, *args, **kw
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2-split's operands (``_launch_k2_split``'s) checked and launched
    through the library's ``entry``, with ``extra`` after K2-split's C
    arguments (the cluster size)."""
    launch, wsf = _cuda_launch(args[0].device, entry)
    return _launch_k2_split(*args, launch=lambda *a: launch(*a, *extra),
                            workspace_floats=wsf, **kw)


@counted_launch("k2_split")
def k2_split_cuda(BT, Q, cutoff, *, forward: bool, max_rank=None,
                  cluster: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2-split as one launch of a thread-block cluster of ``cluster``
    blocks (default ``K2_SPLIT_CLUSTER``); operands and results as
    ``k2_split_plain``'s.  A cluster the card cannot place raises
    RuntimeError."""
    n = _cluster_size(K2_SPLIT_CLUSTER if cluster is None else cluster)
    return _k2_split("mpst_k2_split_cluster_launch", (n,), BT, Q, cutoff,
                     forward=forward, max_rank=max_rank)


@counted_launch("k2_split_block")
def k2_split_block_cuda(BT, Q, cutoff, *, forward: bool, max_rank=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2-split on one thread block, the reference ``k2_split_cuda`` is held
    against bit for bit (no route calls it); operands and results as
    ``k2_split_plain``'s."""
    return _k2_split("mpst_k2_split_launch", (), BT, Q, cutoff,
                     forward=forward, max_rank=max_rank)


def _k2_env(entry: str, extra: tuple, *args, **kw
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2-env's operands (``_launch_k2_env``'s) checked and launched through
    the library's ``entry``, with ``extra`` after K2-env's C arguments (the
    rows a block and the staging flag: 1 stages Qm and the kron factors in
    shared memory where they fit, 0 never)."""
    launch, wsf = _cuda_launch(args[0].device, entry)
    return _launch_k2_env(*args, launch=lambda *a: launch(*a, *extra),
                          workspace_floats=wsf, **kw)


@counted_launch("k2_env")
def k2_env_cuda(Qm, env, env_ls, phi, *, forward: bool,
                rows: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2-env as one launch of ceil(N / ``rows``) independent blocks of
    ``rows`` rows each (default ``K2_ENV_ROWS``), Qm and the blocks' kron
    factors staged in shared memory where they fit; operands and results as
    ``k2_env_plain``'s."""
    n = _env_rows(K2_ENV_ROWS if rows is None else rows)
    return _k2_env("mpst_k2_env_rows_launch", (n, 1), Qm, env, env_ls, phi,
                   forward=forward)


@counted_launch("k2_env_block")
def k2_env_block_cuda(Qm, env, env_ls, phi, *, forward: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2-env on one thread block, the reference ``k2_env_cuda`` is held
    against bit for bit (no route calls it); operands and results as
    ``k2_env_plain``'s."""
    return _k2_env("mpst_k2_env_launch", (), Qm, env, env_ls, phi,
                   forward=forward)


# --------------------------------------------------------------------------
# public bond steps
# --------------------------------------------------------------------------

def _check_route(orth: str, loss: str, bbopt: str) -> None:
    if orth not in ("qr", "ns"):
        raise ValueError(f"orth must be 'qr' or 'ns', got {orth!r}")
    if loss not in ("KLD", "MSE") or bbopt not in ("TSGO", "GD"):
        raise ValueError(
            f"loss={loss}/bbopt={bbopt}: the bond kernels cover "
            "{KLD, MSE} x {TSGO, GD}; other configurations take the unfused "
            "route of training/sweep.py")


def _device_of(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bond kernels run on cpu or cuda tensors, got "
                         f"{t.device}")
    return t.device.type


#: The four pieces of the dp and batch-tiled bond steps and the split
#: tail: (counter, plain, CUDA).  Their complex twins are
#: ``bond_kernels_c.PIECES``.
_PIECES = {"k1a": ("k1a", k1a_plain, k1a_cuda),
           "k1b": ("k1b", k1b_plain, k1b_cuda),
           "k2_split": ("k2_split", k2_split_plain, k2_split_cuda),
           "k2_env": ("k2_env", k2_env_plain, k2_env_cuda),
           "k1_tail": ("k1_tail", k1_tail_plain, k1_tail_cuda)}


def _piece(name: str, t: torch.Tensor, calls: int = 1) -> Callable:
    """The kernel ``name`` for operands like ``t``: the real piece or, for a
    complex ``t``, its complex twin; the CUDA wrapper on the card, or on the
    CPU the plain version (counted in PLAIN_CALLS as ``calls`` calls)."""
    if t.is_complex():
        from .bond_kernels_c import PIECES as table
    else:
        table = _PIECES
    counter, plain, cuda = table[name]
    if _device_of(t) == "cuda":
        return cuda
    count(PLAIN_CALLS, counter, calls)
    return plain


def split_tail_basis(tail: Callable, BT, V0, *, forward: bool,
                     power_iters: int, orth: str) -> torch.Tensor:
    """The basis Q of a refresh bond on the split-tail route, from its
    stepped bond tensor BT: ``power_iters`` calls of ``tail`` (K1-tail or
    K1c-tail, or a plain version) at q=1 chained from V0, each one power
    step as K1's, then the thin QR under orth="qr"
    (pallas_bond.py:1332-1363)."""
    Y = V0
    for _ in range(power_iters):
        Y = tail(BT, Y, forward=forward, power_iters=1, orth=orth)
    return _qr_orth(Y).contiguous() if orth == "qr" else Y


def qr_bond_step(A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0,
                 eta, cutoff, *, forward: bool, plain: bool,
                 power_iters: int = 1, max_rank=None, loss: str = "KLD",
                 bbopt: str = "TSGO", opp_ls=None, orth: str = "qr",
                 split_tail: bool = False) -> Out5:
    """A refresh bond through K1 and K2 (pallas_bond.py:1320-1372 without
    dp): K1, the thin QR of its Y (orth="qr"), then K2 against Q; with
    ``split_tail``, K1 without its power step and ``split_tail_basis``
    (orth "qr" or "ns").  ``plain`` selects the kernels' plain versions
    instead of the CUDA kernels; both orthonormalise with the same
    ``torch.linalg.qr``.  Returns (center_c', core', env', env_ls', Q')."""
    k1, k2 = (k1_plain, k2_plain) if plain else (k1_cuda, k2_cuda)
    gls = env_ls + opp_ls if loss == "MSE" else env_ls
    BT, Y = k1(A_or_B, center_c, le, re, phil, phir, y1h, w, gls, V0, eta,
               forward=forward, emit_y=not split_tail,
               power_iters=power_iters, orth=orth, loss=loss, bbopt=bbopt)
    if split_tail:
        Q = split_tail_basis(k1_tail_plain if plain else k1_tail_cuda, BT,
                             V0, forward=forward, power_iters=power_iters,
                             orth=orth)
    else:
        Q = _qr_orth(Y).contiguous()
    env, phi = (le, phil) if forward else (re, phir)
    return k2(BT, Q, env, env_ls, phi, cutoff, forward=forward,
              max_rank=max_rank) + (Q,)


def bond_step(A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0,
              eta, cutoff, *, forward: bool, refresh: bool = True,
              axis_name: str = None, power_iters: int = 1, orth: str = "qr",
              max_rank=None, stream_tile: Optional[int] = None,
              loss: str = "KLD", bbopt: str = "TSGO", opp_ls=None,
              split_tail: Optional[bool] = None) -> Out5:
    """One bond step: K1 -> QR -> K2 for a refresh bond under orth="qr",
    else one K12; on the split-tail route a refresh bond runs K1 without its
    power step, ``power_iters`` K1-tail launches, the QR under orth="qr",
    then K2.

    backward (forward=False): A_or_B = cores[j]; advances the right
    environment (re, env_ls) through the new V with phir.  forward:
    A_or_B = cores[j+1]; advances the left environment (le, env_ls) through
    the new U with phil.  ``opp_ls`` is the opposite side's log-scale, which
    the MSE gradient needs.  center_c: [C, chi, d, chi].  Returns
    (center_c', core', env', env_ls', Q').

    ``stream_tile``: run the batch in tiles of this many rows
    (pallas_bond.py:1150-1232): N is padded to a multiple of the tile with
    copies of row 0 at weight 0, the tiles' K1a gradients are summed in tile
    order, one K1b (-> QR) -> K2-split follows, then K2-env on each tile;
    the pad rows' environments are dropped.  The data-parallel bond step is
    ``bond_step_dp``: the port has no shard_map, so ``axis_name`` is
    refused.

    ``split_tail``: True takes the split-tail route on a refresh bond
    (pallas_bond.py:1332-1351), False never, None where ``splits_tail``
    says so (chi >= SPLIT_TAIL_CHI); a frozen bond ignores it."""
    if axis_name is not None:
        raise ValueError("the port's data-parallel bond step is "
                         "bond_step_dp(mesh, ...), one process driving the "
                         "mesh's devices: it takes no axis_name")
    _check_route(orth, loss, bbopt)
    args = (A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0, eta,
            cutoff)
    kw = dict(forward=forward, power_iters=power_iters, max_rank=max_rank,
              loss=loss, bbopt=bbopt, opp_ls=opp_ls)
    if stream_tile is not None:
        return _bond_step_streamed(*args, refresh=refresh, orth=orth,
                                   stream_tile=stream_tile,
                                   split_tail=split_tail, **kw)
    cuda = _device_of(center_c) == "cuda"
    tail = refresh and splits_tail(center_c.shape[1], split_tail)
    if refresh and (orth == "qr" or tail):
        if not cuda:
            count(PLAIN_CALLS, "k1")
            count(PLAIN_CALLS, "k2")
            if tail:
                count(PLAIN_CALLS, "k1_tail", power_iters)
        return qr_bond_step(*args, plain=not cuda, orth=orth, split_tail=tail,
                            **kw)
    if cuda:
        return k12_cuda(*args, refresh=refresh, **kw)
    count(PLAIN_CALLS, "k12")
    return k12_plain(*args, refresh=refresh, **kw)


def bond_step_dp(mesh, A_or_B, center_c, le, re, env_ls, phil, phir, y1h,
                 w, V0, eta, cutoff, *, forward: bool, refresh: bool = True,
                 power_iters: int = 1, orth: str = "qr", max_rank=None,
                 loss: str = "KLD", bbopt: str = "TSGO", opp_ls=None,
                 split_tail: Optional[bool] = None):
    """One bond step on a data-parallel ``mesh`` (parallel/mesh.py), the
    JAX bond step with ``axis_name`` (pallas_bond.py:1320-1372), real or
    complex: complex64 operands run the complex pieces (K1c-grad,
    K1c-update, K2c-split, K2c-env, KLD + TSGO only) through the same chain,
    with the realified QR (``bond_step_c_dp``).

    A_or_B, center_c and V0 are lists with one tensor per replica
    (``mesh.replicas``); le, re, env_ls, phil, phir, y1h, w and opp_ls
    lists with one tensor per shard, operands as ``bond_step``'s.  K1a runs
    on every shard, ``mesh.all_reduce`` sums the gradients (the one
    cross-device transfer of the bond), K1b, the QR of Y under orth="qr"
    and K2-split run once per replica, K2-env on every shard.  On the
    split-tail route (``split_tail`` as ``bond_step``'s) K1b runs without
    its power step and ``power_iters`` K1-tail launches follow it.  Returns
    (center_c', core', env', env_ls', Q'): center_c', core' and Q' per
    replica, env' and env_ls' per shard."""
    _check_route(orth, loss, bbopt)
    if center_c[0].is_complex():
        from .bond_kernels_c import _check_kld_tsgo
        _check_kld_tsgo(loss, bbopt)
    on = mesh.to_shards
    A_s, c_s = on(A_or_B), on(center_c)
    G = mesh.all_reduce([
        _piece("k1a", c_s[s])(
            A_s[s], c_s[s], le[s], re[s], phil[s], phir[s], y1h[s], w[s],
            env_ls[s] + opp_ls[s] if loss == "MSE" else env_ls[s],
            forward=forward, loss=loss)
        for s in range(len(mesh))])
    tail = refresh and splits_tail(center_c[0].shape[1], split_tail)
    reps = []
    for A, center, g, v0 in zip(A_or_B, center_c, G, V0):
        BT, Y = _piece("k1b", center)(
            A, center, g, v0, eta, forward=forward,
            emit_y=refresh and not tail, power_iters=power_iters, orth=orth,
            bbopt=bbopt)
        if tail:
            Q = split_tail_basis(_piece("k1_tail", BT, calls=power_iters),
                                 BT, v0, forward=forward,
                                 power_iters=power_iters, orth=orth)
        else:
            Q = _qr_orth(Y).contiguous() if refresh and orth == "qr" else Y
        reps.append(_piece("k2_split", BT)(BT, Q, cutoff, forward=forward,
                                           max_rank=max_rank) + (Q,))
    center2, core, Qm, Q = (list(r) for r in zip(*reps))
    env, phi = (le, phil) if forward else (re, phir)
    Qm_s = on(Qm)
    env2, ls2 = (list(r) for r in zip(*(
        _piece("k2_env", Qm_s[s])(Qm_s[s], env[s], env_ls[s], phi[s],
                                  forward=forward)
        for s in range(len(mesh)))))
    return center2, core, env2, ls2, Q


def _bond_step_streamed(A_or_B, center_c, le, re, env_ls, phil, phir, y1h,
                        w, V0, eta, cutoff, *, stream_tile: int,
                        opp_ls=None, **kw) -> Out5:
    """``bond_step(stream_tile=)``: ``bond_step_dp`` on a mesh of the
    batch's row tiles, all on center_c's device (its sum of the gradients
    is the tile-order sum G0 + G1 + ... of pallas_bond.py:1188-1200)."""
    from ..parallel.mesh import Mesh
    if stream_tile < 1:
        raise ValueError(f"stream_tile must be >= 1, got {stream_tile}")
    N = le.shape[0]
    pad = -N % stream_tile

    def tiles(x):
        # pad rows copy row 0, so their KLD weights stay finite at w = 0
        if pad:
            x = torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])
        return list(x.split(stream_tile))

    mesh = Mesh([center_c.device] * ((N + pad) // stream_tile))
    center2, core, env2, ls2, Q = bond_step_dp(
        mesh, [A_or_B], [center_c], tiles(le), tiles(re), tiles(env_ls),
        tiles(phil), tiles(phir), tiles(y1h),
        list(torch.cat([w, w.new_zeros(pad)]).split(stream_tile)), [V0], eta,
        cutoff, opp_ls=None if opp_ls is None else tiles(opp_ls), **kw)
    return (center2[0], core[0], torch.cat(env2)[:N], torch.cat(ls2)[:N],
            Q[0])


def bond_block_steps(A_blk, center_c, envx_blk, env0, env_ls0, phil_blk,
                     phir_blk, y1h, w, V0_blk, eta, cutoff, *,
                     forward: bool, refresh: bool = True,
                     power_iters: int = 1, orth: str = "ns", max_rank=None,
                     bbopt: str = "TSGO") -> Out5:
    """Bb consecutive bond updates (K12m, KLD loss): Newton-Schulz refresh
    bonds, or frozen bonds under either orth.

    A_blk [Bb, chi, d, chi]: the static cores in update order (backward:
    cores[j], j descending; forward: cores[j+1], j ascending); envx_blk
    [Bb, N, chi]: the opposite-side environments (backward LE[j], forward
    RE[j+2]); env0/env_ls0: the advancing environment entering the block.
    Returns (center_c', core_blk, env_blk, env_ls_blk, Q_blk), per-bond
    emissions in update order."""
    _check_route(orth, "KLD", bbopt)
    if refresh and orth != "ns":
        raise ValueError("K12m refreshes with the Newton-Schulz polar only; "
                         "orth='qr' refresh bonds run bond_step")
    kw = dict(forward=forward, refresh=refresh, power_iters=power_iters,
              max_rank=max_rank, bbopt=bbopt)
    args = (A_blk, center_c, envx_blk, env0, env_ls0, phil_blk, phir_blk,
            y1h, w, V0_blk, eta, cutoff)
    if _device_of(center_c) == "cuda":
        return k12m_cuda(*args, **kw)
    count(PLAIN_CALLS, "k12m")
    return k12m_plain(*args, **kw)

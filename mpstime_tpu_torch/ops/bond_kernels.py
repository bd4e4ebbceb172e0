"""The fused bond step, K12, and its multi-bond block, K12m (counterpart of
``mpstime_tpu/ops/pallas_bond.py``).

``bond_step`` and ``bond_block_steps`` keep the signatures of the JAX
package's (pallas_bond.py:1235, :1062).  Each dispatches on the device of
the tensors it is given:

  * CUDA tensors launch the hand-written kernel (csrc/bond_step.cu), built
    at first use, or raise.  There is no fallback.
  * CPU tensors take the kernel's plain PyTorch version, ``k12_plain`` /
    ``k12m_plain``, built from the ported split, update and environment
    functions.

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` the dispatches to the
plain versions, so a run can show which path it took.  Operand layouts are
the JAX kernels': the class-major center [C, chi, d, chi], environments
[N, chi], conjugated features [N, d], subspace caches [chi*d, chi].
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .bond_update import apply_update
from .decomp import warm_split_left, warm_split_right
from .env import env_step_left_scaled, env_step_right_scaled

#: Kernel launches per kernel since the last reset_counts().
LAUNCHES: Dict[str, int] = {"k12": 0, "k12m": 0}
#: Dispatches to each kernel's plain version since the last reset_counts().
PLAIN_CALLS: Dict[str, int] = {"k12": 0, "k12m": 0}

Out5 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
             torch.Tensor]


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def k12_plain(A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0,
              eta, cutoff, *, forward: bool, refresh: bool = True,
              power_iters: int = 1, max_rank=None, loss: str = "KLD",
              bbopt: str = "TSGO", opp_ls=None) -> Out5:
    """One bond step in plain PyTorch, with K12's operands: the gradient
    step (ops/bond_update.py), the warm split with the Newton-Schulz polar
    route (ops/decomp.py) and the scaled environment step (ops/env.py).
    Returns (center_c', core', env', env_ls', Q')."""
    C, chi, d, _ = center_c.shape
    gls = env_ls + opp_ls if loss == "MSE" else env_ls
    if forward:
        BT = torch.einsum("caim,mkb->aikbc", center_c, A_or_B)
    else:
        BT = torch.einsum("aim,cmkb->aikbc", A_or_B, center_c)
    _, BT = apply_update(BT, le, re, phil, phir, y1h, w, gls, eta=eta,
                         loss=loss, bbopt=bbopt)
    kw = dict(q=power_iters, refresh=refresh, max_rank=max_rank, orth="ns")
    if forward:
        U, SVh, Q = warm_split_right(BT.reshape(chi * d, d * chi * C), V0,
                                     chi, cutoff, **kw)
        core = U.reshape(chi, d, chi)
        center = SVh.reshape(chi, d, chi, C).permute(3, 0, 1, 2)
        env2, ls2 = env_step_left_scaled(le, env_ls, core, phil)
    else:
        M = BT.permute(0, 1, 4, 2, 3).reshape(chi * d * C, d * chi)
        US, Vh, Q = warm_split_left(M, V0, chi, cutoff, **kw)
        center = US.reshape(chi, d, C, chi).permute(2, 0, 1, 3)
        core = Vh.reshape(chi, d, chi)
        env2, ls2 = env_step_right_scaled(re, env_ls, core, phir)
    return (center.contiguous(), core.contiguous(), env2, ls2,
            Q.contiguous())


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

def _launch_k12m(A_blk, center_c, envx_blk, env0, env_ls0, opp_ls, phil_blk,
                 phir_blk, y1h, w, V0_blk, eta, cutoff, *, forward: bool,
                 refresh: bool, power_iters: int, max_rank, loss: str,
                 bbopt: str, launch: Callable[..., None],
                 workspace_floats: Callable[[int, int, int, int], int]
                 ) -> Out5:
    """Check K12m's operands, allocate its outputs and workspace on the
    operands' device, and hand everything to ``launch`` in the kernel's C
    argument order."""
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
        "env_ls0": (env_ls0, (N,)),
        "phil_blk": (phil_blk, (Bb, N, d)),
        "phir_blk": (phir_blk, (Bb, N, d)),
        "y1h": (y1h, (N, C)),
        "w": (w, (N,)),
        "V0_blk": (V0_blk, (Bb, chi * d, chi)),
    }
    if loss == "MSE":
        expect["opp_ls"] = (opp_ls, (N,))
    dev = center_c.device
    for name, (t, shape) in expect.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, center_c on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Bb < 1 or power_iters < 1:
        raise ValueError(f"need Bb >= 1 and power_iters >= 1, got {Bb}, "
                         f"{power_iters}")
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    center2 = empty(C, chi, d, chi)
    core_b = empty(Bb, chi, d, chi)
    env_b = empty(Bb, N, chi)
    ls_b = empty(Bb, N)
    q_b = empty(Bb, chi * d, chi)
    ws = empty(workspace_floats(C, chi, d, N))
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


def _cuda_launch(device: torch.device):
    """(launch, workspace_floats) for the built library on ``device``."""
    from ..kernels.build import load_library
    lib = load_library()
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream

    def launch(*args):
        with torch.cuda.device(index):      # the stream's device is current
            rc = lib.mpst_k12m_launch(*args, stream)
        if rc != 0:
            raise RuntimeError(f"K12m launch failed: CUDA error {rc} "
                               f"({lib.mpst_error_string(rc).decode()})")

    return launch, lib.mpst_k12_workspace_floats


def k12_cuda(A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0, eta,
             cutoff, *, forward: bool, refresh: bool = True,
             power_iters: int = 1, max_rank=None, loss: str = "KLD",
             bbopt: str = "TSGO", opp_ls=None) -> Out5:
    """K12: one bond step as one launch of the block kernel at Bb = 1."""
    launch, wsf = _cuda_launch(center_c.device)
    env, envx = (le, re) if forward else (re, le)
    center2, core, env2, ls2, Q = _launch_k12m(
        A_or_B[None], center_c, envx[None], env, env_ls, opp_ls, phil[None],
        phir[None], y1h, w, V0[None], eta, cutoff, forward=forward,
        refresh=refresh, power_iters=power_iters, max_rank=max_rank,
        loss=loss, bbopt=bbopt, launch=launch, workspace_floats=wsf)
    LAUNCHES["k12"] += 1
    return center2, core[0], env2[0], ls2[0], Q[0]


def k12m_cuda(A_blk, center_c, envx_blk, env0, env_ls0, phil_blk, phir_blk,
              y1h, w, V0_blk, eta, cutoff, *, forward: bool,
              refresh: bool = True, power_iters: int = 1, max_rank=None,
              bbopt: str = "TSGO") -> Out5:
    """K12m: Bb consecutive bond steps (KLD) as one launch."""
    launch, wsf = _cuda_launch(center_c.device)
    out = _launch_k12m(
        A_blk, center_c, envx_blk, env0, env_ls0, None, phil_blk, phir_blk,
        y1h, w, V0_blk, eta, cutoff, forward=forward, refresh=refresh,
        power_iters=power_iters, max_rank=max_rank, loss="KLD", bbopt=bbopt,
        launch=launch, workspace_floats=wsf)
    LAUNCHES["k12m"] += 1
    return out


# --------------------------------------------------------------------------
# public bond steps
# --------------------------------------------------------------------------

def _check_route(refresh: bool, orth: str, loss: str, bbopt: str,
                 axis_name, stream_tile) -> None:
    if axis_name is not None or stream_tile is not None:
        raise NotImplementedError(
            "the data-parallel and N-streaming bond steps (kernels K1a, K1b, "
            "K2-split, K2-env) are ROADMAP.md queue 2 items 6-9")
    if refresh and orth != "ns":
        raise NotImplementedError(
            f"orth={orth!r} refresh bonds run K1 -> QR -> K2, which are "
            "ROADMAP.md queue 2 items 3-4; use orth='ns'")
    if loss not in ("KLD", "MSE") or bbopt not in ("TSGO", "GD"):
        raise NotImplementedError(
            f"loss={loss}/bbopt={bbopt}: the fused bond step covers "
            "{KLD, MSE} x {TSGO, GD}")


def _device_of(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bond kernels run on cpu or cuda tensors, got "
                         f"{t.device}")
    return t.device.type


def bond_step(A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0,
              eta, cutoff, *, forward: bool, refresh: bool = True,
              axis_name: str = None, power_iters: int = 1, orth: str = "qr",
              max_rank=None, stream_tile: Optional[int] = None,
              loss: str = "KLD", bbopt: str = "TSGO", opp_ls=None) -> Out5:
    """One fused bond step (K12).

    backward (forward=False): A_or_B = cores[j]; advances the right
    environment (re, env_ls) through the new V with phir.  forward:
    A_or_B = cores[j+1]; advances the left environment (le, env_ls) through
    the new U with phil.  ``opp_ls`` is the opposite side's log-scale, which
    the MSE gradient needs.  center_c: [C, chi, d, chi].  Returns
    (center_c', core', env', env_ls', Q')."""
    _check_route(refresh, orth, loss, bbopt, axis_name, stream_tile)
    kw = dict(forward=forward, refresh=refresh, power_iters=power_iters,
              max_rank=max_rank, loss=loss, bbopt=bbopt, opp_ls=opp_ls)
    args = (A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0, eta,
            cutoff)
    if _device_of(center_c) == "cuda":
        return k12_cuda(*args, **kw)
    PLAIN_CALLS["k12"] += 1
    return k12_plain(*args, **kw)


def bond_block_steps(A_blk, center_c, envx_blk, env0, env_ls0, phil_blk,
                     phir_blk, y1h, w, V0_blk, eta, cutoff, *,
                     forward: bool, refresh: bool = True,
                     power_iters: int = 1, orth: str = "ns", max_rank=None,
                     bbopt: str = "TSGO") -> Out5:
    """Bb consecutive bond updates (K12m, KLD loss).

    A_blk [Bb, chi, d, chi]: the static cores in update order (backward:
    cores[j], j descending; forward: cores[j+1], j ascending); envx_blk
    [Bb, N, chi]: the opposite-side environments (backward LE[j], forward
    RE[j+2]); env0/env_ls0: the advancing environment entering the block.
    Returns (center_c', core_blk, env_blk, env_ls_blk, Q_blk), per-bond
    emissions in update order."""
    _check_route(refresh, orth, "KLD", bbopt, None, None)
    kw = dict(forward=forward, refresh=refresh, power_iters=power_iters,
              max_rank=max_rank, bbopt=bbopt)
    args = (A_blk, center_c, envx_blk, env0, env_ls0, phil_blk, phir_blk,
            y1h, w, V0_blk, eta, cutoff)
    if _device_of(center_c) == "cuda":
        return k12m_cuda(*args, **kw)
    PLAIN_CALLS["k12m"] += 1
    return k12m_plain(*args, **kw)

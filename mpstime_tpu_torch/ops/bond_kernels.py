"""The fused bond step, K12, its multi-bond block, K12m, and the two halves
K1 and K2 of the bond step around an outside QR (counterpart of
``mpstime_tpu/ops/pallas_bond.py``).

``bond_step`` and ``bond_block_steps`` keep the signatures of the JAX
package's (pallas_bond.py:1235, :1062).  A refresh bond under orth="qr" runs
K1 -> ``torch.linalg.qr`` -> K2 (pallas_bond.py:1320-1372); every other bond
runs K12.  Each kernel dispatches on the device of the tensors it is given:

  * CUDA tensors launch the hand-written kernel (csrc/bond_step.cu), built
    at first use, or raise.  There is no fallback.
  * CPU tensors take the kernel's plain PyTorch version (``k12_plain``,
    ``k12m_plain``, ``k1_plain``, ``k2_plain``), built from the ported
    update, split and environment functions.

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` the dispatches to the
plain versions, so a run can show which path it took.  Operand layouts are
the JAX kernels': the class-major center [C, chi, d, chi], environments
[N, chi], conjugated features [N, d], subspace caches [chi*d, chi], and K1's
bond tensor [C, chi*d, d, chi].
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .bond_update import apply_update
from .decomp import _qr_orth, warm_iterate, warm_split_left, warm_split_right
from .env import env_step_left_scaled, env_step_right_scaled

#: Kernel launches per kernel since the last reset_counts().
#: The complex kernels (ops/bond_kernels_c.py) count here too.
LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("k12", "k12m", "k1", "k2", "k12c", "k12mc", "k1c", "k2c", "k12cr"), 0)
#: Dispatches to each kernel's plain version since the last reset_counts().
PLAIN_CALLS: Dict[str, int] = dict(LAUNCHES)

Out5 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
             torch.Tensor]
Out4 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

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
    C, chi, d, _ = center_c.shape
    if forward:
        BT = torch.einsum("caim,mkb->aikbc", center_c, A_or_B)
    else:
        BT = torch.einsum("aim,cmkb->aikbc", A_or_B, center_c)
    # apply_update takes the features unconjugated (bond_update.py)
    _, BT = apply_update(BT, le, re, phil.conj(), phir.conj(), y1h, w, gls,
                         eta=eta, loss=loss, bbopt=bbopt)
    Y = V0
    if emit_y:
        if forward:
            M = BT.reshape(chi * d, d * chi * C)
            Y = warm_iterate(lambda Yp: M @ (M.conj().T @ Yp), V0,
                             power_iters, orth)
        else:
            M = BT.permute(0, 1, 4, 2, 3).reshape(chi * d * C, d * chi)
            Y = warm_iterate(lambda Yp: M.conj().T @ (M @ Yp), V0,
                             power_iters, orth)
    BTk = BT.permute(4, 0, 1, 2, 3).reshape(C, chi * d, d, chi)
    return BTk.contiguous(), Y.contiguous()


def k2_plain(BT, Q, env, env_ls, phi, cutoff, *, forward: bool,
             max_rank=None) -> Out4:
    """K2 in plain PyTorch: the split of BT [C, chi*d, d, chi] against the
    orthonormal basis Q [chi*d, chi] (ops/decomp.py's warm split of a frozen
    bond) and the scaled step of the advancing environment (``env``,
    ``env_ls``, ``phi``: le / phil forward, re / phir backward).  Returns
    (center_c', core', env', env_ls')."""
    C, P, d, chi = BT.shape
    if forward:
        M = BT.permute(1, 2, 3, 0).reshape(P, d * chi * C)
        U, SVh, _ = warm_split_right(M, Q, chi, cutoff, refresh=False,
                                     max_rank=max_rank)
        core = U.reshape(chi, d, chi)
        center = SVh.reshape(chi, d, chi, C).permute(3, 0, 1, 2)
        env2, ls2 = env_step_left_scaled(env, env_ls, core, phi)
    else:
        M = BT.permute(1, 0, 2, 3).reshape(P * C, d * chi)
        US, Vh, _ = warm_split_left(M, Q, chi, cutoff, refresh=False,
                                    max_rank=max_rank)
        center = US.reshape(chi, d, C, chi).permute(2, 0, 1, 3)
        core = Vh.reshape(chi, d, chi)
        env2, ls2 = env_step_right_scaled(env, env_ls, core, phi)
    return center.contiguous(), core.contiguous(), env2, ls2


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


def k12_cuda(A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0, eta,
             cutoff, *, forward: bool, refresh: bool = True,
             power_iters: int = 1, max_rank=None, loss: str = "KLD",
             bbopt: str = "TSGO", opp_ls=None) -> Out5:
    """K12: one bond step as one launch of the block kernel at Bb = 1."""
    launch, wsf = _cuda_launch(center_c.device, "mpst_k12m_launch")
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
    launch, wsf = _cuda_launch(center_c.device, "mpst_k12m_launch")
    out = _launch_k12m(
        A_blk, center_c, envx_blk, env0, env_ls0, None, phil_blk, phir_blk,
        y1h, w, V0_blk, eta, cutoff, forward=forward, refresh=refresh,
        power_iters=power_iters, max_rank=max_rank, loss="KLD", bbopt=bbopt,
        launch=launch, workspace_floats=wsf)
    LAUNCHES["k12m"] += 1
    return out


def k1_cuda(A_or_B, center_c, le, re, phil, phir, y1h, w, gls, V0, eta, *,
            forward: bool, emit_y: bool = True, power_iters: int = 1,
            orth: str = "qr", loss: str = "KLD", bbopt: str = "TSGO"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 as one launch; operands and results as ``k1_plain``'s."""
    launch, wsf = _cuda_launch(center_c.device, "mpst_k1_launch")
    out = _launch_k1(A_or_B, center_c, le, re, phil, phir, y1h, w, gls, V0,
                     eta, forward=forward, emit_y=emit_y,
                     power_iters=power_iters, orth=orth, loss=loss,
                     bbopt=bbopt, launch=launch, workspace_floats=wsf)
    LAUNCHES["k1"] += 1
    return out


def k2_cuda(BT, Q, env, env_ls, phi, cutoff, *, forward: bool,
            max_rank=None) -> Out4:
    """K2 as one launch; operands and results as ``k2_plain``'s."""
    launch, wsf = _cuda_launch(BT.device, "mpst_k2_launch")
    out = _launch_k2(BT, Q, env, env_ls, phi, cutoff, forward=forward,
                     max_rank=max_rank, launch=launch, workspace_floats=wsf)
    LAUNCHES["k2"] += 1
    return out


# --------------------------------------------------------------------------
# public bond steps
# --------------------------------------------------------------------------

def _check_route(orth: str, loss: str, bbopt: str, axis_name,
                 stream_tile) -> None:
    if axis_name is not None or stream_tile is not None:
        raise NotImplementedError(
            "the data-parallel and N-streaming bond steps (kernels K1a, K1b, "
            "K2-split, K2-env) are ROADMAP.md queue 2 items 6-9")
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


def qr_bond_step(A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0,
                 eta, cutoff, *, forward: bool, plain: bool,
                 power_iters: int = 1, max_rank=None, loss: str = "KLD",
                 bbopt: str = "TSGO", opp_ls=None) -> Out5:
    """A refresh bond under orth="qr": K1, the thin QR of its Y, then K2
    against Q (pallas_bond.py:1320-1372, without the split tail and dp).
    ``plain`` selects the kernels' plain versions instead of the CUDA
    kernels; both orthonormalise with the same ``torch.linalg.qr``.
    Returns (center_c', core', env', env_ls', Q')."""
    k1, k2 = (k1_plain, k2_plain) if plain else (k1_cuda, k2_cuda)
    gls = env_ls + opp_ls if loss == "MSE" else env_ls
    BT, Y = k1(A_or_B, center_c, le, re, phil, phir, y1h, w, gls, V0, eta,
               forward=forward, power_iters=power_iters, orth="qr",
               loss=loss, bbopt=bbopt)
    Q = _qr_orth(Y).contiguous()
    env, phi = (le, phil) if forward else (re, phir)
    return k2(BT, Q, env, env_ls, phi, cutoff, forward=forward,
              max_rank=max_rank) + (Q,)


def bond_step(A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0,
              eta, cutoff, *, forward: bool, refresh: bool = True,
              axis_name: str = None, power_iters: int = 1, orth: str = "qr",
              max_rank=None, stream_tile: Optional[int] = None,
              loss: str = "KLD", bbopt: str = "TSGO", opp_ls=None) -> Out5:
    """One bond step: K1 -> QR -> K2 for a refresh bond under orth="qr",
    else one K12.

    backward (forward=False): A_or_B = cores[j]; advances the right
    environment (re, env_ls) through the new V with phir.  forward:
    A_or_B = cores[j+1]; advances the left environment (le, env_ls) through
    the new U with phil.  ``opp_ls`` is the opposite side's log-scale, which
    the MSE gradient needs.  center_c: [C, chi, d, chi].  Returns
    (center_c', core', env', env_ls', Q')."""
    _check_route(orth, loss, bbopt, axis_name, stream_tile)
    args = (A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0, eta,
            cutoff)
    kw = dict(forward=forward, power_iters=power_iters, max_rank=max_rank,
              loss=loss, bbopt=bbopt, opp_ls=opp_ls)
    cuda = _device_of(center_c) == "cuda"
    if refresh and orth == "qr":
        if not cuda:
            PLAIN_CALLS["k1"] += 1
            PLAIN_CALLS["k2"] += 1
        return qr_bond_step(*args, plain=not cuda, **kw)
    if cuda:
        return k12_cuda(*args, refresh=refresh, **kw)
    PLAIN_CALLS["k12"] += 1
    return k12_plain(*args, refresh=refresh, **kw)


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
    _check_route(orth, "KLD", bbopt, None, None)
    if refresh and orth != "ns":
        raise ValueError("K12m refreshes with the Newton-Schulz polar only; "
                         "orth='qr' refresh bonds run bond_step")
    kw = dict(forward=forward, refresh=refresh, power_iters=power_iters,
              max_rank=max_rank, bbopt=bbopt)
    args = (A_blk, center_c, envx_blk, env0, env_ls0, phil_blk, phir_blk,
            y1h, w, V0_blk, eta, cutoff)
    if _device_of(center_c) == "cuda":
        return k12m_cuda(*args, **kw)
    PLAIN_CALLS["k12m"] += 1
    return k12m_plain(*args, **kw)

"""DMRG-style two-site sweeps (counterpart of
``mpstime_tpu/training/sweep.py``, the real ``randomized_warm`` route).

One full sweep is a backward half-sweep (bonds T-2..0) then a forward one
(0..T-2), reference RealRealHighDimension.jl:726-804.  JAX's ``lax.scan``
over bonds and ``fori_loop`` over sweeps become Python loops.  Within a
half-sweep every read touches only the pre-half-sweep cores, so the cores,
environments and subspace caches stream in bond order and the new cores,
environments and caches are stacked in the same order; the running
environment is the carry.  Each half-sweep's environment emissions are the
exact environments the next half-sweep consumes.

Every bond runs the fused bond step: one K12m launch per block of ``BB``
consecutive bonds plus one remainder block (KLD), or one K12 launch per bond
(MSE, whose gradient needs per-bond opposite-side log-scales).  On CUDA
tensors these are the hand-written kernels; on CPU tensors their plain
versions (ops/bond_kernels.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..options import torch_dtype
from ..ops.bond_kernels import bond_block_steps, bond_step
from ..ops.decomp import warm_sketch_init
from ..ops.env import boundary_env, build_left_envs

BOND_BLOCK: Optional[int] = None
"""Override for the multi-bond block size (K12m): None = auto (the largest
of 8/6/4/3/2 that is at most T-1), 1 = one K12 launch per bond."""


def _auto_block(T: int) -> int:
    """Block size for the K12m route."""
    if BOND_BLOCK is not None:
        return max(1, min(int(BOND_BLOCK), T - 1))
    for Bb in (8, 6, 4, 3, 2):
        if Bb <= T - 1:
            return Bb
    return 1


def _ineligible_reasons(dtype, loss, bbopt, update_iters, rescale,
                        svd_alg, device) -> list:
    reasons = []
    if svd_alg != "randomized_warm":
        reasons.append(f"svd_alg={svd_alg!r} (the unfused splits gram_eigh, "
                       "svd, randomized, lean and ritz are ROADMAP.md queue 1 "
                       "items 10 and 14)")
    if int(update_iters) != 1:
        reasons.append(f"update_iters={update_iters} (ROADMAP.md queue 1 "
                       "item 10)")
    if tuple(rescale) != (False, True):
        reasons.append(f"rescale={tuple(rescale)} (ROADMAP.md queue 1 item "
                       "10)")
    if loss not in ("KLD", "MSE") or bbopt not in ("TSGO", "GD"):
        reasons.append(f"loss={loss}/bbopt={bbopt} (the mixed loss and CGD "
                       "are ROADMAP.md queue 1 item 10)")
    dt = dtype if isinstance(dtype, torch.dtype) else torch_dtype(dtype)
    dev = torch.device(device).type
    if dev not in ("cuda", "cpu"):
        reasons.append(f"device={dev} (cpu or cuda)")
    # the plain versions are dtype-generic, so the CPU also runs float64
    if not (dt == torch.float32 or (dt == torch.float64 and dev == "cpu")):
        reasons.append(f"dtype={dt} (the CUDA bond kernels are float32 and "
                       "the CPU also runs float64; complex is ROADMAP.md "
                       "queue 1 item 14)")
    return reasons


def _kernel_eligible(dtype, loss, bbopt, update_iters, rescale, svd_alg,
                     device) -> bool:
    """Whether the fused bond step (K12 / K12m) covers a configuration: real
    float32, {KLD, MSE} x {TSGO, GD}, one update iteration,
    rescale=(False, True), svd_alg="randomized_warm", on a CUDA device.  A
    CPU device runs the same route through the kernels' plain versions (the
    counterpart of the JAX package's Pallas interpret mode), in float32 or
    float64."""
    return not _ineligible_reasons(dtype, loss, bbopt, update_iters, rescale,
                                   svd_alg, device)


def pallas_route_notice(dtype, loss, bbopt, update_iters, rescale, svd_alg,
                        device, track_cost: bool = False) -> Optional[str]:
    """One line on why a configuration will NOT run on the CUDA bond
    kernels (None if it will, or if the device is not a GPU)."""
    if torch.device(device).type != "cuda":
        return None
    reasons = _ineligible_reasons(dtype, loss, bbopt, update_iters, rescale,
                                  svd_alg, device)
    if track_cost:
        reasons.append("track_cost=True (per-bond loss trace)")
    if not reasons:
        return None
    return ("[mpstime_tpu_torch] note: this configuration cannot run on the "
            "CUDA bond kernels: " + "; ".join(reasons))


def init_subspaces(T: int, chi: int, d: int, dtype, device="cpu"):
    """Cold-start per-bond subspace caches: VB[j] [d*chi, chi] (right
    subspace of backward bond j), UF[j] [chi*d, chi] (left subspace of
    forward bond j), j = 0..T-2."""
    v = warm_sketch_init(d * chi, chi, dtype, device)
    u = warm_sketch_init(chi * d, chi, dtype, device)
    return (v.expand((T - 1,) + v.shape).contiguous(),
            u.expand((T - 1,) + u.shape).contiguous())


def init_left_env_state(cores: torch.Tensor, phis_c: torch.Tensor):
    """(LE [T, N, chi], LE_ls [T, N]) for the first backward pass:
    LE[t] = contraction of sites 0..t-1 (LE[0] = boundary)."""
    LE, LE_ls = build_left_envs(cores, phis_c)
    return LE[:-1], LE_ls[:-1]


def _half_sweep(carry, xs, BB: int, step, block):
    """Run one half-sweep over the bonds of ``xs`` (per-bond stacks in
    update order): blocks of BB bonds through ``block`` plus one remainder
    block, or every bond through ``step`` when BB == 1.  Returns the final
    carry and the per-bond emissions (core, env, env_ls, Q) stacked in
    update order."""
    nb = xs[0].shape[0]
    outs = []
    if BB > 1:
        for s in range(0, nb, BB):
            carry, ys = block(carry, [x[s:s + BB] for x in xs])
            outs.append(ys)
    else:
        for j in range(nb):
            carry, ys = step(carry, [x[j] for x in xs])
            outs.append(tuple(y[None] for y in ys))
    return carry, [torch.cat(y) for y in zip(*outs)]


def _sweep_core(cores, center, LE, LE_ls, VB, UF, phis_c, y_onehot,
                class_weight, eta, cutoff, *, loss: str, bbopt: str,
                update_iters: int, rescale: Tuple[bool, bool], svd_alg: str,
                power_iters: int = 1, orth: str = "ns",
                refresh: bool = True, max_rank=None):
    """One full sweep; center at site T-1 on entry and exit.

    LE [T, N, chi] / LE_ls [T, N]: left environments of the current cores
    (slot t = sites 0..t-1).  VB/UF: the warm-split subspace caches.
    Returns (cores, center, LE', LE_ls', VB', UF'), LE' being exactly what
    the next sweep needs."""
    T, chi, d, _ = cores.shape
    N = phis_c.shape[1]
    dev = cores.device
    reasons = _ineligible_reasons(cores.dtype, loss, bbopt, update_iters,
                                  rescale, svd_alg, dev)
    if reasons:
        raise NotImplementedError(
            "this configuration has no fused bond step in the port: "
            + "; ".join(reasons))
    kw = dict(refresh=refresh, power_iters=power_iters, orth=orth,
              max_rank=max_rank, bbopt=bbopt)
    # MSE bonds need per-bond opposite-side log-scales, which the block
    # kernel does not carry: they run one K12 per bond
    BB = _auto_block(T) if loss == "KLD" else 1
    center = center.permute(3, 0, 1, 2).contiguous()   # class-major
    e0 = boundary_env(N, chi, cores.dtype, dev)
    ls0 = torch.zeros((N,), dtype=phis_c.real.dtype, device=dev)

    # ---------------- backward half-sweep (center T-1 -> 0) ----------------
    # update order jj = 0..T-2 is bond j = T-2-jj
    fl = lambda a: torch.flip(a, (0,))                 # noqa: E731
    xs_b = [fl(cores[:T - 1]), fl(LE[:T - 1]), fl(phis_c[:T - 1]),
            fl(phis_c[1:T]), fl(VB), fl(LE_ls[:T - 1])]

    def backward_step(carry, x):
        center, re_v, re_ls = carry
        A, le, phl, phr, vb, le_ls = x
        center, V, v2, ls2, Qv = bond_step(
            A, center, le, re_v, re_ls, phl, phr, y_onehot, class_weight, vb,
            eta, cutoff, forward=False, loss=loss, opp_ls=le_ls, **kw)
        return (center, v2, ls2), (V, v2, ls2, Qv)

    def backward_block(carry, x):
        center, re_v, re_ls = carry
        A, le, phl, phr, vb, _ = x
        center, V, env_b, ls_b, Qv = bond_block_steps(
            A, center, le, re_v, re_ls, phl, phr, y_onehot, class_weight, vb,
            eta, cutoff, forward=False, **kw)
        return (center, env_b[-1], ls_b[-1]), (V, env_b, ls_b, Qv)

    (center, _, _), (V, re_e, re_ls_e, qv) = _half_sweep(
        (center, e0, ls0), xs_b, BB, backward_step, backward_block)
    # new cores[1..T-1] (emitted for j = T-2..0 -> slots T-1..1)
    cores_mid = torch.cat([cores[:1], fl(V)])
    VB = fl(qv)
    # RE stack for the forward pass: the emissions are RE[j+1]; forward bond
    # j reads RE[j+2], i.e. slots 2..T-1 plus the boundary at slot T
    xs_re = torch.cat([fl(re_e)[1:], e0[None]])
    xs_re_ls = torch.cat([fl(re_ls_e)[1:], ls0[None]])

    # ---------------- forward half-sweep (center 0 -> T-1) -----------------
    xs_f = [cores_mid[1:T].contiguous(), xs_re, phis_c[:T - 1],
            phis_c[1:T], UF, xs_re_ls]

    def forward_step(carry, x):
        center, le_v, le_ls = carry
        B, re, phl, phr, uf, re_ls = x
        center, U, v2, ls2, Qu = bond_step(
            B, center, le_v, re, le_ls, phl, phr, y_onehot, class_weight, uf,
            eta, cutoff, forward=True, loss=loss, opp_ls=re_ls, **kw)
        return (center, v2, ls2), (U, v2, ls2, Qu)

    def forward_block(carry, x):
        center, le_v, le_ls = carry
        B, re, phl, phr, uf, _ = x
        center, U, env_b, ls_b, Qu = bond_block_steps(
            B, center, re, le_v, le_ls, phl, phr, y_onehot, class_weight, uf,
            eta, cutoff, forward=True, **kw)
        return (center, env_b[-1], ls_b[-1]), (U, env_b, ls_b, Qu)

    (center, _, _), (U, le_e, le_ls_e, UF) = _half_sweep(
        (center, e0, ls0), xs_f, BB, forward_step, forward_block)
    cores_out = torch.cat([U, cores_mid[T - 1:]])
    # LE stack for the next backward pass: slot 0 = boundary, slots 1..T-1
    # from the forward emissions (exact environments of cores_out)
    LE_out = torch.cat([e0[None], le_e])
    LE_ls_out = torch.cat([ls0[None], le_ls_e])
    center = center.permute(1, 2, 3, 0).contiguous()
    return cores_out, center, LE_out, LE_ls_out, VB, UF


def full_sweeps(cores: torch.Tensor, center: torch.Tensor,
                phis_c: torch.Tensor, y_onehot: torch.Tensor,
                class_weight: torch.Tensor, eta, cutoff, *, nsweeps: int,
                loss: str, bbopt: str, update_iters: int,
                rescale: Tuple[bool, bool], svd_alg: str,
                power_iters: int = 1, orth: str = "ns",
                refresh_every: int = 1, max_rank=None,
                on_sweep: Optional[Callable[[int, torch.Tensor, torch.Tensor],
                                            bool]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nsweeps`` full sweeps; the left environments and the per-bond
    subspace caches persist across them.

    ``refresh_every=K``: refresh the subspaces (power step + polar) on
    sweeps 0, K, 2K, ...; in between, split against the frozen cached bases.
    ``on_sweep(i, cores, center)`` runs after each sweep (logging, timing);
    returning True stops the loop early."""
    T, chi, d, _ = cores.shape
    LE, LE_ls = init_left_env_state(cores, phis_c)
    VB, UF = init_subspaces(T, chi, d, torch.empty(0, dtype=cores.dtype)
                            .numpy().dtype, cores.device)
    for i in range(nsweeps):
        cores, center, LE, LE_ls, VB, UF = _sweep_core(
            cores, center, LE, LE_ls, VB, UF, phis_c, y_onehot, class_weight,
            eta, cutoff, loss=loss, bbopt=bbopt, update_iters=update_iters,
            rescale=rescale, svd_alg=svd_alg, power_iters=power_iters,
            orth=orth, refresh=i % refresh_every == 0, max_rank=max_rank)
        if on_sweep is not None and on_sweep(i, cores, center):
            break
    return cores, center

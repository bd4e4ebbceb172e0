"""DMRG-style two-site sweeps (counterpart of
``mpstime_tpu/training/sweep.py``, its real and complex routes).

One full sweep is a backward half-sweep (bonds T-2..0) then a forward one
(0..T-2), reference RealRealHighDimension.jl:726-804.  JAX's ``lax.scan``
over bonds and ``fori_loop`` over sweeps become Python loops.  Within a
half-sweep every read touches only the pre-half-sweep cores, so the cores,
environments and subspace caches stream in bond order and the new cores,
environments and caches are stacked in the same order; the running
environment is the carry.  Each half-sweep's environment emissions are the
exact environments the next half-sweep consumes.

Three routes, chosen per configuration as the JAX package chooses between
its Pallas kernels and XLA (``_ineligible_reasons``, ``_ritz_fused``):

  * the bond-kernel route (real float32 with {KLD, MSE} x {TSGO, GD}, or
    complex64 with KLD + TSGO; one update iteration, rescale (False, True),
    svd_alg "randomized_warm", no cost tracking): one K12m (K12mc) launch
    per block of ``BB`` consecutive bonds plus one remainder block (KLD;
    Newton-Schulz refresh or frozen sweeps, and for complex no refresh
    block at q > 1), else one ``bond_step`` (``bond_step_c``) per bond,
    which runs K12 (K12c) or, for a refresh bond under orth="qr", K1 -> QR
    -> K2 (K1c -> QR -> K2c); a refresh sweep whose chi takes the split-tail
    route (``bond_kernels.SPLIT_TAIL_CHI``) runs bond by bond, K1 ->
    K1-tail launches (-> QR) -> K2.  On CUDA tensors these are the hand-written
    kernels; on CPU tensors their plain versions (ops/bond_kernels.py,
    ops/bond_kernels_c.py), the counterpart of Pallas interpret mode;
  * the fused ritz route (svd_alg "randomized_warm_ritz" on the same
    complex64 terms, in a sweep whose rotation is "jacobi" or
    "jacobi_warm"): one K12cr per bond (``bond_step_c_ritz``), sweep.py:
    319-329;
  * the unfused route, every other configuration, in plain PyTorch on
    the tensors' own device: ``apply_update`` (ops/bond_update.py), the warm
    split, the ritz split or ``split_bond_*`` (ops/decomp.py), then the
    scaled environment step (ops/env.py), as the JAX package's XLA bond
    step (sweep.py:433-455, :576-597).

Under a data-parallel mesh (``mesh=``, parallel/mesh.py) the batch state
(features, labels, weights, environments and their log-scales) is a list
with one tensor per shard and the replicated state (cores, center, subspace
caches) a list with one tensor per replica.  The bond-kernel route then runs
every bond as ``bond_step_dp`` (K1a -> one sum over the shards -> K1b -> QR
-> K2-split -> K2-env), or for complex64 ``bond_step_c_dp`` (K1c-grad ->
sum -> K1c-update -> realified QR -> K2c-split -> K2c-env; no K12m or K12mc
blocks, sweep.py:469), ritz fits take the unfused route (no K12cr,
sweep.py:327), and the unfused route sums the shards' losses and gradients
in ``apply_update``; each is one ``mesh.all_reduce`` per bond update.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Tuple

import torch

from ..options import torch_dtype
from ..ops.bond_kernels import (bond_block_steps, bond_step, bond_step_dp,
                                splits_tail)
from ..ops.bond_kernels_c import (bond_block_steps_c, bond_step_c,
                                  bond_step_c_dp, bond_step_c_ritz)
from ..ops.bond_update import apply_update
from ..ops.decomp import (_np_dtype, split_bond_left, split_bond_right,
                          warm_ritz_split_left, warm_ritz_split_right,
                          warm_sketch_init, warm_split_left, warm_split_right)
from ..ops.env import (boundary_env, build_left_envs, env_step_left_scaled,
                       env_step_right_scaled)

RITZ = "randomized_warm_ritz"
#: The warm splits, which carry per-bond subspace caches across sweeps.
WARM_ALGS = ("randomized_warm", RITZ)

BOND_BLOCK: Optional[int] = None
"""Override for the multi-bond block size (K12m / K12mc): None = auto (the
largest of 8/6/4/3/2 that is at most T-1 and the cap), 1 = one bond_step
per bond."""


def _as_torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else torch_dtype(dtype)


def _auto_block(T: int, cap: int = 8) -> int:
    """Block size for the K12m route; the complex route caps it at 4, as
    the JAX package does (sweep.py:467-468)."""
    if BOND_BLOCK is not None:
        return max(1, min(int(BOND_BLOCK), T - 1))
    for Bb in (8, 6, 4, 3, 2):
        if Bb <= min(cap, T - 1):
            return Bb
    return 1


def _ineligible_reasons(dtype, loss, bbopt, update_iters, rescale,
                        svd_alg, track_cost: bool = False) -> list:
    """Why a configuration takes the unfused route rather than the bond
    kernels (empty: the kernels), the counterpart of the JAX package's
    ``_pallas_eligible`` (sweep.py:125-165).  The ritz route's fused sweeps
    are ``_ritz_fused``'s."""
    dt = _as_torch_dtype(dtype)
    reasons = []
    if track_cost:
        reasons.append("track_cost=True (per-bond loss trace)")
    if svd_alg != "randomized_warm":
        reasons.append(f"svd_alg={svd_alg!r} (the kernels run "
                       "'randomized_warm')")
    if int(update_iters) != 1:
        reasons.append(f"update_iters={update_iters} (the kernels run one)")
    if tuple(rescale) != (False, True):
        reasons.append(f"rescale={tuple(rescale)} (the kernels run "
                       "(False, True))")
    if dt.is_complex:
        if (loss, bbopt) != ("KLD", "TSGO"):
            reasons.append(f"loss={loss}/bbopt={bbopt} (the complex kernels "
                           "cover KLD+TSGO only)")
        if dt != torch.complex64:
            reasons.append(f"dtype={dt} (the kernels are float32/complex64)")
        return reasons
    if loss not in ("KLD", "MSE") or bbopt not in ("TSGO", "GD"):
        reasons.append(f"loss={loss}/bbopt={bbopt} (the kernels cover "
                       "{KLD, MSE} x {TSGO, GD})")
    if dt != torch.float32:
        reasons.append(f"dtype={dt} (the kernels are float32/complex64)")
    return reasons


def _kernel_eligible(dtype, loss, bbopt, update_iters, rescale, svd_alg,
                     track_cost: bool = False) -> bool:
    """Whether the sweep takes the bond-kernel route (on CUDA the kernels,
    on the CPU their plain versions) rather than the unfused route."""
    return not _ineligible_reasons(dtype, loss, bbopt, update_iters, rescale,
                                   svd_alg, track_cost)


def _ritz_fused(dtype, loss, bbopt, update_iters, rescale, svd_alg,
                ritz_rot: str, track_cost: bool = False) -> bool:
    """Whether a sweep of the ritz route runs one K12cr per bond
    (sweep.py:319-348): complex64 with the warm kernels' terms (KLD + TSGO,
    one update iteration, rescale (False, True), no cost tracking) and a
    Jacobi rotation.  Other ritz sweeps take the unfused route."""
    dt = _as_torch_dtype(dtype)
    return (svd_alg == RITZ and ritz_rot in ("jacobi", "jacobi_warm")
            and dt.is_complex
            and not _ineligible_reasons(dt, loss, bbopt, update_iters,
                                        rescale, "randomized_warm",
                                        track_cost))


def pallas_route_notice(dtype, loss, bbopt, update_iters, rescale, svd_alg,
                        device, track_cost: bool = False,
                        ritz_track_rot: str = "jacobi") -> Optional[str]:
    """One line on why a configuration will NOT run on the CUDA bond
    kernels (None if it will, or if the device is not a GPU).  A complex
    ritz fit whose tracked sweeps run K12cr counts as running on them, as
    in the JAX package (sweep.py:190-206): only its exact sweeps take the
    unfused route."""
    if torch.device(device).type != "cuda":
        return None
    dt = _as_torch_dtype(dtype)
    if svd_alg == RITZ and dt.is_complex:
        reasons = _ineligible_reasons(dt, loss, bbopt, update_iters, rescale,
                                      "randomized_warm", track_cost)
        if ritz_track_rot != "jacobi":
            reasons.insert(0, f"ritz_rot_track={ritz_track_rot!r} (the ritz "
                           "route's tracked sweeps run K12cr only with the "
                           "'jacobi' tracker)")
    else:
        reasons = _ineligible_reasons(dt, loss, bbopt, update_iters,
                                      rescale, svd_alg, track_cost)
    if not reasons:
        return None
    return ("[mpstime_tpu_torch] note: this configuration takes the unfused "
            "route (plain PyTorch on the card), not the CUDA bond kernels: "
            + "; ".join(reasons))


def init_subspaces(T: int, chi: int, d: int, dtype, device="cuda"):
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


Stacks = Dict[str, torch.Tensor]


def _m(f, *xs):
    """f over matching parts: over the shards or replicas when the operands
    are lists (a mesh's placed state, transposing tuple results into a tuple
    of lists), else f itself."""
    if not isinstance(xs[0], list):
        return f(*xs)
    out = [f(*a) for a in zip(*xs)]
    return tuple(map(list, zip(*out))) if isinstance(out[0], tuple) else out


def _first(x):
    """A tensor, or the first part of a placed list."""
    return x[0] if isinstance(x, list) else x


def _cat(*xs):
    return _m(lambda *ts: torch.cat(ts), *xs)


def _rows(x, a, b):
    return _m(lambda t: t[a:b], x)


def _flip(x):
    return _m(lambda t: torch.flip(t, (0,)), x)


def _half_sweep(carry, xs: Stacks, BB: int, step, block):
    """Run one half-sweep over the bonds of ``xs`` (per-bond stacks in
    update order): blocks of BB bonds through ``block`` plus one remainder
    block, or every bond through ``step`` when BB == 1.  Returns the final
    carry and the per-bond emissions stacked in update order."""
    nb = _first(next(iter(xs.values()))).shape[0]
    outs = []
    if BB > 1:
        for s in range(0, nb, BB):
            carry, ys = block(carry, {k: _rows(v, s, s + BB)
                                      for k, v in xs.items()})
            outs.append(ys)
    else:
        for j in range(nb):
            carry, ys = step(carry, {k: _m(lambda t: t[j], v)
                                     for k, v in xs.items()})
            outs.append({k: _m(lambda t: t[None], y) for k, y in ys.items()})
    return carry, {k: _cat(*[o[k] for o in outs]) for k in outs[0]}


def _sweep_core(cores, center, LE, LE_ls, VB, UF, phis_c, y_onehot,
                class_weight, eta, cutoff, *, loss: str, bbopt: str,
                update_iters: int, rescale: Tuple[bool, bool], svd_alg: str,
                power_iters: int = 1, orth: str = "qr",
                refresh: bool = True, ritz_rot: str = "eigh", max_rank=None,
                track_cost: bool = False, mesh=None):
    """One full sweep; center at site T-1 on entry and exit.

    LE [T, N, chi] / LE_ls [T, N]: left environments of the current cores
    (slot t = sites 0..t-1).  VB/UF: the warm splits' subspace caches (None
    unless svd_alg is one of ``WARM_ALGS``).  ``ritz_rot``: the ritz
    route's eigen-rotation for this sweep ("eigh", "eigh_r", "track",
    "jacobi", "jacobi_warm"; ignored off that route).  ``mesh``: a
    data-parallel mesh; the batch operands and LE, LE_ls are then lists
    over its shards, cores, center, VB and UF lists over its replicas.
    Returns (cores, center, LE', LE_ls', VB', UF', costs), LE' being exactly
    what the next sweep needs; costs is the per-bond loss [2(T-1)] in update
    order (backward bonds T-2..0, then forward 0..T-2) when ``track_cost``,
    else None."""
    T, chi, d, _ = _first(cores).shape
    C = _first(center).shape[3]
    dtype = _first(cores).dtype
    dev = _first(cores).device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sweeps run on cpu or cuda, got {dev}")
    cplx = dtype.is_complex
    kernels = not _ineligible_reasons(dtype, loss, bbopt, update_iters,
                                      rescale, svd_alg, track_cost)
    # no K12cr under a mesh: ritz fits run the unfused route (sweep.py:327)
    ritz_fused = mesh is None and _ritz_fused(
        dtype, loss, bbopt, update_iters, rescale, svd_alg, ritz_rot,
        track_cost)
    fused = ritz_fused or kernels
    warm = svd_alg in WARM_ALGS
    on_shards = mesh.to_shards if mesh is not None else (lambda v: v)
    e0 = _m(lambda p: boundary_env(p.shape[1], chi, dtype, p.device), phis_c)
    ls0 = _m(lambda p: torch.zeros((p.shape[1],), dtype=p.real.dtype,
                                   device=p.device), phis_c)

    def fused_steps(forward: bool):
        kw = dict(refresh=refresh, power_iters=power_iters, max_rank=max_rank)
        # the complex kernels are KLD + TSGO only (the route choice above);
        # K12cr refreshes with tri-Newton whatever the orth
        if ritz_fused:
            kw["rot"] = ritz_rot
            step_fn, block_fn = bond_step_c_ritz, None
        else:
            kw["orth"] = orth
            step_fn, block_fn = ((bond_step_c, bond_block_steps_c) if cplx
                                 else (bond_step, bond_block_steps))
            if mesh is not None:
                step_fn = partial(bond_step_c_dp if cplx else bond_step_dp,
                                  mesh)
        block_kw = {} if cplx else dict(bbopt=bbopt)

        def step(carry, x):
            center, env, ls = carry
            le, re = (env, x["envx"]) if forward else (x["envx"], env)
            real_kw = {} if cplx else dict(loss=loss, bbopt=bbopt,
                                           opp_ls=x["envx_ls"])
            center, core, v2, ls2, Q = step_fn(
                x["core"], center, le, re, ls, x["phl"], x["phr"], y_onehot,
                class_weight, x["q"], eta, cutoff, forward=forward, **kw,
                **real_kw)
            return (center, v2, ls2), dict(core=core, env=v2, ls=ls2, q=Q)

        def block(carry, x):
            center, env, ls = carry
            center, core, env_b, ls_b, Q = block_fn(
                x["core"], center, x["envx"], env, ls, x["phl"], x["phr"],
                y_onehot, class_weight, x["q"], eta, cutoff, forward=forward,
                **kw, **block_kw)
            return (center, env_b[-1], ls_b[-1]), dict(core=core, env=env_b,
                                                       ls=ls_b, q=Q)
        return step, block

    wsl, wsr = ((warm_ritz_split_left, warm_ritz_split_right)
                if svd_alg == RITZ else (warm_split_left, warm_split_right))

    def unfused_step(forward: bool):
        split_kw = dict(max_rank=max_rank, orth=orth)
        warm_kw = dict(q=power_iters, refresh=refresh, **split_kw)
        if svd_alg == RITZ:
            warm_kw["rot"] = ritz_rot

        def split(BT, q=None):
            """(center, core, q') of one replica's stepped bond tensor."""
            if forward:
                M = BT.reshape(chi * d, d * chi * C)
                if warm:
                    U, SVh, q = wsr(M, q, chi, cutoff, **warm_kw)
                else:
                    U, SVh = split_bond_right(M, chi, cutoff, svd_alg,
                                              **split_kw)
                return SVh.reshape(chi, d, chi, C), U.reshape(chi, d, chi), q
            # rows (a, i, c): the label stays on the sweep side (:166-169)
            M = BT.permute(0, 1, 4, 2, 3).reshape(chi * d * C, d * chi)
            if warm:
                US, Vh, q = wsl(M, q, chi, cutoff, **warm_kw)
            else:
                US, Vh = split_bond_left(M, chi, cutoff, svd_alg, **split_kw)
            return (US.reshape(chi, d, C, chi).permute(0, 1, 3, 2),
                    Vh.reshape(chi, d, chi), q)

        def step(carry, x):
            center, env, ls = carry
            le, re = (env, x["envx"]) if forward else (x["envx"], env)
            if forward:
                BT = _m(lambda c, B: torch.einsum("aimc,mkb->aikbc", c, B),
                        center, x["core"])
            else:
                BT = _m(lambda A, c: torch.einsum("aim,mkbc->aikbc", A, c),
                        x["core"], center)
            cost, BT = apply_update(
                BT, le, re, _m(torch.conj, x["phl"]),
                _m(torch.conj, x["phr"]), y_onehot, class_weight,
                _m(torch.add, ls, x["envx_ls"]), eta=eta, loss=loss,
                bbopt=bbopt, update_iters=update_iters, rescale=rescale,
                mesh=mesh)
            center, core, q = _m(split, BT, *([x["q"]] if warm else []))
            if forward:
                v2, ls2 = _m(env_step_left_scaled, env, ls, on_shards(core),
                             x["phl"])
            else:
                v2, ls2 = _m(env_step_right_scaled, env, ls, on_shards(core),
                             x["phr"])
            ys = dict(core=core, env=v2, ls=ls2)
            if warm:
                ys["q"] = q
            if track_cost:
                ys["cost"] = cost
            return (center, v2, ls2), ys
        return step, None

    if fused:
        # K12m blocks carry no per-bond opposite-side log-scales (MSE) and
        # refresh with the Newton-Schulz polar only; complex blocks hold at
        # most 4 bonds and refresh only at q = 1 (sweep.py:467-475); K12cr
        # runs bond by bond, a mesh's bonds one bond_step_dp each, and a
        # refresh sweep on the split-tail route (chi >= SPLIT_TAIL_CHI)
        # bond_step by bond_step, as the JAX sweep's blocks of 1 there
        blocks = (loss == "KLD" and (orth == "ns" or not refresh)
                  and not (cplx and refresh and power_iters > 1)
                  and not (refresh and splits_tail(chi))
                  and not ritz_fused and mesh is None)
        BB = _auto_block(T, cap=4 if cplx else 8) if blocks else 1
        steps = fused_steps
        center = _m(lambda c: c.permute(3, 0, 1, 2).contiguous(), center)
    else:
        BB, steps = 1, unfused_step

    # ---------------- backward half-sweep (center T-1 -> 0) ----------------
    # update order jj = 0..T-2 is bond j = T-2-jj
    xs_b = dict(core=_flip(_rows(cores, 0, T - 1)),
                envx=_flip(_rows(LE, 0, T - 1)),
                phl=_flip(_rows(phis_c, 0, T - 1)),
                phr=_flip(_rows(phis_c, 1, T)),
                envx_ls=_flip(_rows(LE_ls, 0, T - 1)))
    if warm:
        xs_b["q"] = _flip(VB)
    (center, _, _), ys_b = _half_sweep((center, e0, ls0), xs_b, BB,
                                       *steps(False))
    # new cores[1..T-1] (emitted for j = T-2..0 -> slots T-1..1)
    cores_mid = _cat(_rows(cores, 0, 1), _flip(ys_b["core"]))
    if warm:
        VB = _flip(ys_b["q"])
    # RE stack for the forward pass: the emissions are RE[j+1]; forward bond
    # j reads RE[j+2], i.e. slots 2..T-1 plus the boundary at slot T
    xs_f = dict(core=_m(torch.Tensor.contiguous, _rows(cores_mid, 1, T)),
                envx=_cat(_rows(_flip(ys_b["env"]), 1, T),
                          _m(lambda e: e[None], e0)),
                phl=_rows(phis_c, 0, T - 1), phr=_rows(phis_c, 1, T),
                envx_ls=_cat(_rows(_flip(ys_b["ls"]), 1, T),
                             _m(lambda e: e[None], ls0)))
    if warm:
        xs_f["q"] = UF

    # ---------------- forward half-sweep (center 0 -> T-1) -----------------
    (center, _, _), ys_f = _half_sweep((center, e0, ls0), xs_f, BB,
                                       *steps(True))
    cores_out = _cat(ys_f["core"], _rows(cores_mid, T - 1, T))
    if warm:
        UF = ys_f["q"]
    # LE stack for the next backward pass: slot 0 = boundary, slots 1..T-1
    # from the forward emissions (exact environments of cores_out)
    LE_out = _cat(_m(lambda e: e[None], e0), ys_f["env"])
    LE_ls_out = _cat(_m(lambda e: e[None], ls0), ys_f["ls"])
    if fused:
        center = _m(lambda c: c.permute(1, 2, 3, 0), center)
    costs = (torch.cat([ys_b["cost"], ys_f["cost"]]) if track_cost
             else None)
    return (cores_out, _m(torch.Tensor.contiguous, center), LE_out,
            LE_ls_out, VB, UF, costs)


def sweep_schedule(i: int, svd_alg: str, refresh_every: int = 1,
                   ritz_exact_sweeps: int = -1, ritz_exact_rot: str = "eigh",
                   ritz_track_rot: str = "track") -> Tuple[bool, str]:
    """(refresh, ritz_rot) of sweep ``i`` (sweep.py:837-870, fit.py:298-
    304): the warm subspaces refresh on sweeps 0, K, 2K, ... of
    ``refresh_every=K``; a ritz sweep is tracked (``ritz_track_rot``) iff
    0 <= ritz_exact_sweeps <= i, else exact (``ritz_exact_rot``), so -1
    means exact on every sweep and 0 tracked from the first."""
    tracked = svd_alg == RITZ and 0 <= ritz_exact_sweeps <= i
    return (i % refresh_every == 0,
            ritz_track_rot if tracked else ritz_exact_rot)


def _init_state(cores, phis_c, svd_alg: str, mesh=None):
    """(LE, LE_ls, VB, UF) for a first sweep: the left environments of
    ``cores`` (per shard under a mesh) and, for the warm splits, cold-start
    subspace caches (per replica), else None."""
    T, chi, d, _ = _first(cores).shape
    on_shards = mesh.to_shards if mesh is not None else (lambda v: v)
    LE, LE_ls = _m(init_left_env_state, on_shards(cores), phis_c)
    VB = UF = None
    if svd_alg in WARM_ALGS:
        VB, UF = _m(lambda c: init_subspaces(T, chi, d, _np_dtype(c),
                                             c.device), cores)
    return LE, LE_ls, VB, UF


def full_sweeps(cores, center, phis_c, y_onehot, class_weight, eta, cutoff,
                *, nsweeps: int, loss: str, bbopt: str, update_iters: int,
                rescale: Tuple[bool, bool], svd_alg: str,
                power_iters: int = 1, orth: str = "qr",
                refresh_every: int = 1, ritz_exact_sweeps: int = -1,
                ritz_exact_rot: str = "eigh", ritz_track_rot: str = "track",
                max_rank=None, track_cost: bool = False,
                on_sweep: Optional[Callable[..., bool]] = None, mesh=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nsweeps`` full sweeps; the left environments and the per-bond
    subspace caches persist across them.

    ``refresh_every=K``: refresh the subspaces (power step + orthogonal
    basis) on sweeps 0, K, 2K, ...; in between, split against the frozen
    cached bases.  The ritz route's rotation follows ``sweep_schedule``.
    ``on_sweep(i, cores, center, costs)`` runs after each sweep (logging,
    timing; ``costs`` is the per-bond loss trace when ``track_cost``, else
    None); returning True stops the loop early.  ``mesh``: a data-parallel
    mesh, with cores and center placed by ``parallel.replicate`` and the
    batch tensors by ``parallel.shard_train_arrays``; the returned cores and
    center (and on_sweep's) are then the copies on its first device."""
    LE, LE_ls, VB, UF = _init_state(cores, phis_c, svd_alg, mesh)
    for i in range(nsweeps):
        refresh, rot = sweep_schedule(i, svd_alg, refresh_every,
                                      ritz_exact_sweeps, ritz_exact_rot,
                                      ritz_track_rot)
        cores, center, LE, LE_ls, VB, UF, costs = _sweep_core(
            cores, center, LE, LE_ls, VB, UF, phis_c, y_onehot, class_weight,
            eta, cutoff, loss=loss, bbopt=bbopt, update_iters=update_iters,
            rescale=rescale, svd_alg=svd_alg, power_iters=power_iters,
            orth=orth, refresh=refresh, ritz_rot=rot, max_rank=max_rank,
            track_cost=track_cost, mesh=mesh)
        if on_sweep is not None and on_sweep(i, _first(cores), _first(center),
                                             costs):
            break
    return _first(cores), _first(center)


def sweep_once(cores, center, phis_c, y_onehot, class_weight, eta, cutoff,
               *, subspaces=None, mesh=None, **kw):
    """One self-contained sweep that builds its own left environments
    (sweep.py:639-672), from the subspace caches ``subspaces`` = (VB, UF)
    of a warm split (cold-started when None).  ``kw``: ``_sweep_core``'s
    options.  Returns (cores, center, (VB, UF), costs), placed as
    ``_sweep_core``'s under a mesh."""
    LE, LE_ls, VB, UF = _init_state(cores, phis_c, kw["svd_alg"], mesh)
    if subspaces is not None:
        VB, UF = subspaces
    cores, center, _, _, VB, UF, costs = _sweep_core(
        cores, center, LE, LE_ls, VB, UF, phis_c, y_onehot, class_weight, eta,
        cutoff, mesh=mesh, **kw)
    return cores, center, (VB, UF), costs

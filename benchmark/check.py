"""The comparison that decides ``correct``.

During the window the benchmark keeps, for a sample of the fits drawn from
the seed, what each sweep got and gave (cores, center, the warm subspace
caches) and, for a sample of its sweeps, what each of the sweep's bond
steps gave (the emitted cores, the moved center, the new bases): references
to the program's own tensors, which a sweep allocates anew and never
writes again.  Once the window has closed, the plain reference
(reference/plain.py, float64) judges each sampled fit:

* ``start_gap``: the first sweep's input (initial MPS, cold caches, the
  encoded training set, labels and weights) against the reference's own,
  worked out from the raw series and the fit's seed: the largest
  |program - reference| over the largest |reference|, by tensor.
* ``chain_gap``: the count of places where the program's state does not
  hand on bit for bit: a sweep's input against the last sweep's output,
  and a checked sweep's output against what its bond steps emitted.
* ``bond_gap``: every bond step of the checked sweeps that starts from
  the program's own center (each call of one step, the first step of each
  fused block), run by the reference from the program's state before it
  (that center, the cores as the sweep has left them, the cached bases)
  with the reference's own environments, features, labels and weights:
  the distance of the state the program's step leaves on its two sites
  (the emitted core and the moved center, compared whatever their gauge)
  from the reference's, over the distance of the state before the step
  from the reference's (the state left as it was reads 1).  Directions
  whose energy lies near the cutoff (1e-10 of the total, below float32's
  resolution) are kept or dropped by rounding; they carry next to nothing
  of the state, so the state, not the cores one by one, is compared.  The
  new bases are held by chain_gap.
* ``block_gap``: the same for every later step of a fused block, which
  the program runs from a center it does not give.  The reference carries
  the center on: its own stepped bond tensor projected on the program's
  emitted core, as the program makes its center under its core; the
  block's last step is judged with the program's own center.  Where a
  fit's steps are ill conditioned (sweep 0 while the ranks grow, and the
  early and middle sweeps at N 1000), the f32 program and the float64
  reference part within a few chained steps even so, so this number has
  a limit of its own; on cells whose route runs no block it reads nothing
  and is not compared.
* ``classify_gap``: the program's labels for the test set against the
  reference's class scores of the fit's last state (normalised by the
  reference) and its own encoding of the test series: the widest gap by
  which the program's class lies below the reference's best, in normalised
  class probability.

``control=True`` puts the reference itself in the program's place,
computed in bfloat16 (``plain.round_bf16`` after every operation), the
precision below the configuration's float32 / complex64.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from reference import plain

#: The numbers compared, in the order they are printed.
NUMBERS = ("start_gap", "chain_gap", "bond_gap", "block_gap",
           "classify_gap")

_WIDE = {torch.float32: torch.float64, torch.complex64: torch.complex128,
         torch.float64: torch.float64, torch.complex128: torch.complex128}
#: The program's fused bond-step functions, as its sweep calls them.
STEP_FNS = ("bond_step", "bond_step_c", "bond_block_steps",
            "bond_block_steps_c")


@dataclass
class CapturedFit:
    """What a sampled fit's sweeps got and gave, and its answers.
    ``check_sweeps``: the sweeps whose bond steps are recorded."""
    index: int
    init_rng: int
    check_sweeps: List[int]
    sweeps: List[dict] = field(default_factory=list)
    preds: Optional[np.ndarray] = None


class SweepCapture:
    """While entered, wraps the program's one-sweep function and its fused
    bond steps so that what the fit ``target`` gives is recorded; entered
    around a sampled fit only, so that the other fits run the program as
    it is."""

    def __init__(self, sweep_module, target: CapturedFit):
        self.mod, self.target = sweep_module, target
        self.orig = {n: getattr(sweep_module, n)
                     for n in ("_sweep_core",) + STEP_FNS}
        self._calls: Optional[list] = None

    def __enter__(self):
        self.mod._sweep_core = self._sweep
        for n in STEP_FNS:
            setattr(self.mod, n, self._step(self.orig[n],
                                            n.startswith("bond_block")))
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.mod, n, f)

    def _sweep(self, *args, **kw):
        fit = self.target
        if len(fit.sweeps) in fit.check_sweeps:
            self._calls = []
        out = self.orig["_sweep_core"](*args, **kw)
        cores, center, _, _, VB, UF, phis_c, y1h, w = args[:9]
        fit.sweeps.append(dict(
            inp=(cores, center, VB, UF),
            out=(out[0], out[1], out[4], out[5]),
            phis_c=phis_c, y1h=y1h, w=w, calls=self._calls))
        self._calls = None
        return out

    def _step(self, fn, block: bool):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if self._calls is not None:
                center, core, _, _, Q = out
                if not block:
                    core, Q = core[None], Q[None]
                self._calls.append((bool(kw["forward"]), center, core, Q))
            return out
        return wrapped


def _wide(t: torch.Tensor, device) -> torch.Tensor:
    return t.detach().to(device=device, dtype=_WIDE[t.dtype])


def _rel_max(p: torch.Tensor, r: torch.Tensor) -> float:
    den = float(r.abs().max())
    return float((p - r).abs().max()) / (den if den > 0 else 1.0)


class Reference:
    """The reference's view of one cell's data: its own scaling and
    encodings of the raw series, in float64 on ``device``."""

    def __init__(self, opts: dict, data, device, rnd=plain.exact):
        X_tr, y_tr, X_te, _ = data
        self.o, self.device, self.rnd = opts, device, rnd
        enc, d = opts["encoding"], opts["d"]
        rng = plain.FEATURES[enc][1]
        Xs, y_idx, self.labels = plain.class_sort(np.asarray(X_tr), y_tr)
        norms = plain.fit_norms(X_tr)
        phis = plain.encode(plain.scale_rows(Xs, norms, rng, False), enc, d,
                            device, rnd)
        self.phis_c = phis.conj().transpose(0, 1).contiguous()
        N, C = len(y_idx), len(self.labels)
        self.y1h = torch.nn.functional.one_hot(
            torch.as_tensor(y_idx, device=device), C).to(torch.float64)
        self.w = torch.full((N,), 1.0 / N, dtype=torch.float64, device=device)
        self.test = plain.encode(plain.scale_rows(X_te, norms, rng, True),
                                 enc, d, device, rnd)
        self.T, self.C = self.phis_c.shape[0], C

    def start(self, init_rng: int):
        """(cores, center, VB, UF) of a fit's first sweep."""
        o, dt = self.o, np.dtype(self.o["dtype"])
        cores, center = plain.random_mps(init_rng, self.T, o["d"], self.C,
                                         o["chi_init"], o["chi_max"], dt)
        n = o["chi_max"] * o["d"]
        q = plain.cold_subspace(n, o["chi_max"], dt)
        cache = np.broadcast_to(q, (self.T - 1,) + q.shape)
        return tuple(self.rnd(_wide(torch.from_numpy(np.ascontiguousarray(a)),
                                    self.device))
                     for a in (cores, center, cache, cache))

    def step(self, center_c, A, le, re, j: int, fwd: bool, V0):
        """This reference's step of bond ``j`` from the given state: (its
        stepped bond tensor, center, emitted core)."""
        o, ph, rnd = self.o, self.phis_c, self.rnd
        BT = plain.bond_tensor(rnd(A), rnd(center_c), rnd(le), rnd(re),
                               ph[j], ph[j + 1], self.y1h, self.w,
                               forward=fwd, eta=o["eta"], rnd=rnd)
        center, core, _ = plain.split(BT, rnd(V0), forward=fwd,
                                      cutoff=o["cutoff"],
                                      q=o["subspace_power_iters"], rnd=rnd)
        return BT, center, core

    def predict(self, cores, center) -> np.ndarray:
        """Labels by the largest class score of the normalised state."""
        center = center / torch.linalg.vector_norm(center)
        p = plain.class_scores(cores, center, self.test, self.rnd)
        return self.labels[p.argmax(dim=1).cpu().numpy()]


def _ratio(p: list, r: list, before: list, fwd: bool) -> float:
    """||p - r|| / ||before - r|| of the run of sites a call covers: the
    state after the program's steps, after the reference's, and before
    (each [center, emitted cores]; ``before`` [center, static cores]).
    Backward, the center ends left of the emitted cores, which come right
    to left; forward, it ends on the right."""
    def run(center_c, cores, center_first):
        return plain.site_run(center_c, cores if fwd else
                              torch.flip(cores, (0,)), center_first)
    ra = run(*r, not fwd)
    den = plain.segment_distance(run(*before, fwd), ra)
    num = plain.segment_distance(run(*p, not fwd), ra)
    return num / den if den > 0 else float(num > 0)


def _sweep_bonds(ref: Reference, low: Optional[Reference], rec: dict,
                 device):
    """(bond_gap, block_gap, chain mismatches) of one checked sweep: every
    step of every recorded call run again from the program's state before
    it."""
    cores, center, VB, UF = (_wide(t, device) for t in rec["inp"])
    T, chi = cores.shape[0], cores.shape[1]
    N = ref.phis_c.shape[1]
    cores = cores.clone()
    center_c = center.permute(3, 0, 1, 2)
    LE = plain.left_envs(cores, ref.phis_c, T - 1)
    RE = None
    env = plain.boundary(N, chi, cores.dtype, device)
    ls = torch.zeros(N, dtype=torch.float64, device=device)
    gap, done = [0.0, 0.0], {False: 0, True: 0}
    Qs = {False: [None] * (T - 1), True: [None] * (T - 1)}
    for fwd, c_out, core_b, Q_b in rec["calls"]:
        c_out, core_b, Q_b = (_wide(t, device) for t in (c_out, core_b, Q_b))
        if fwd and RE is None:            # the backward half is done
            RE = plain.right_envs(cores, ref.phis_c, 2)
            env = plain.boundary(N, chi, cores.dtype, device)
            ls = torch.zeros_like(ls)
        n = core_b.shape[0]
        bonds = range(done[fwd], done[fwd] + n)
        done[fwd] += n
        cache = UF if fwd else VB
        for k, jj in enumerate(bonds):
            j = jj if fwd else T - 2 - jj
            site = j if fwd else j + 1
            A = cores[j + 1] if fwd else cores[j]
            le, re = (env, RE[j + 2]) if fwd else (LE[j], env)
            BT, rc, rcore = ref.step(center_c, A, le, re, j, fwd, cache[j])
            core = core_b[k]
            # the center the reference carries on within a block: its own
            # step projected on the program's emitted core
            carried = c_out if k == n - 1 else plain.project(BT, core, fwd)
            if low is not None:           # the control's own step
                _, pc, pcore = low.step(center_c, A, le, re, j, fwd,
                                        cache[j])
            else:
                pc, pcore = carried, core
            gap[k > 0] = max(gap[k > 0], _ratio(
                [pc, pcore[None]], [rc, rcore[None]], [center_c, A[None]],
                fwd))
            cores[site] = core            # on with the program's own state
            Qs[fwd][j] = Q_b[k]
            env, ls = plain.env_step(env, ls, core, ref.phis_c[site], fwd,
                                     plain.exact)
            center_c = carried
    if low is not None:
        return gap + [0]
    if done[False] != T - 1 or done[True] != T - 1:
        return gap + [1]
    # the sweep hands on what its steps emitted (the slot under the center
    # is unused)
    out = [_wide(t, device) for t in rec["out"]]
    cores[T - 1] = out[0][T - 1]
    want = [cores, center_c.permute(1, 2, 3, 0), torch.stack(Qs[False]),
            torch.stack(Qs[True])]
    return gap + [sum(not torch.equal(a, b) for a, b in zip(out, want))]


def _classify_gap(preds: np.ndarray, ref: Reference, cores, center) -> float:
    center = center / torch.linalg.vector_norm(center)
    p = plain.class_scores(cores, center, ref.test).cpu().numpy()
    idx = np.searchsorted(ref.labels, preds)
    if (idx >= len(ref.labels)).any() or \
            (ref.labels[np.minimum(idx, len(ref.labels) - 1)] != preds).any():
        return 1.0                     # a label the training set lacks
    return float(np.max(p.max(axis=1) - p[np.arange(len(idx)), idx]))


def judge(fits: List[CapturedFit], opts: dict, data, device,
          control: bool = False) -> Dict[str, float]:
    """The numbers of NUMBERS over the sampled fits (the largest of each;
    chain_gap their sum).  With ``control`` the program's records are
    replaced by the reference computed in bfloat16 from the same states."""
    ref = Reference(opts, data, device)
    low = Reference(opts, data, device, plain.round_bf16) if control else None
    out = dict.fromkeys(NUMBERS, 0.0)
    for fit in fits:
        rec = fit.sweeps
        if len(rec) != opts["nsweeps"]:
            out["chain_gap"] += 1
            continue
        mine = ref.start(fit.init_rng)
        if control:
            theirs = low.start(fit.init_rng)
            inputs = (low.phis_c, low.y1h, low.w)
        else:
            theirs = tuple(_wide(t, device) for t in rec[0]["inp"])
            inputs = tuple(_wide(rec[0][k], device)
                           for k in ("phis_c", "y1h", "w"))
        out["start_gap"] = max(out["start_gap"], *(
            _rel_max(p, r) for p, r in zip(
                theirs + inputs, mine + (ref.phis_c, ref.y1h, ref.w))))
        if not control:
            out["chain_gap"] += sum(
                not all(torch.equal(a, b) for a, b in
                        zip(rec[i]["inp"], rec[i - 1]["out"]))
                for i in range(1, len(rec)))
        for i in fit.check_sweeps:
            if rec[i]["calls"] is None:
                out["chain_gap"] += 1
                continue
            gap, block, bad = _sweep_bonds(ref, low, rec[i], device)
            out["bond_gap"] = max(out["bond_gap"], gap)
            out["block_gap"] = max(out["block_gap"], block)
            out["chain_gap"] += bad
        last = tuple(_wide(t, device) for t in rec[-1]["out"])
        preds = low.predict(*last[:2]) if control else fit.preds
        out["classify_gap"] = max(out["classify_gap"],
                                  _classify_gap(preds, ref, *last[:2]))
    return out

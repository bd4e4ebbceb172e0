"""Readings for the limits of ``correct``: the program's numbers and the
control's over many seeds, in one process.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 ... \
        [--faults]

For each seed: one fit and classify of the cell as the window runs them
(init seed ``harness.fit_seed(seed, 0)``, the data of the seed), judged
with the bond steps of four of its sweeps (the first, the last and two
drawn from the seed), then the same fit judged with the control in the
program's place (the reference in bfloat16).  With
``--faults`` also the faults the cell can have, planted in the program:
a bond step that returns its state unchanged, a sweep over every other
sample with the weights doubled, and one label altered where classify
makes it; on the real route, a block of bond steps that advances only its
first step.
One JSON line a seed; the benchmark's runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import numpy as np                                # noqa: E402

import check                                      # noqa: E402
import generator                                  # noqa: E402
import harness                                    # noqa: E402


def unchanged(orig):
    """A bond step (or block of steps) that hands back its input state:
    the center where it was, the static cores as the emitted ones, the
    environment not advanced and the cached bases as the new ones."""
    def step(A, center, le, re, ls, phl, phr, y1h, w, V0, *a, **kw):
        env = le if kw["forward"] else re
        return center, A, env, ls, V0

    def block(A, center, envx, env0, ls0, *a, **kw):
        V0 = a[4]
        n = A.shape[0]
        return (center, A, env0[None].expand(n, *env0.shape),
                ls0[None].expand(n, *ls0.shape), V0)
    return block if orig.__name__.startswith("bond_block") else step


def first_step_only(orig):
    """A block of bond steps that advances its first step and hands the
    others back unchanged: their static cores as the emitted ones, their
    cached bases as the new ones, the center and the environment where the
    first step left them.  Steps run one to a call are left as they are."""
    if not orig.__name__.startswith("bond_block"):
        return orig

    def block(A, center, envx, env0, ls0, phl, phr, y1h, w, V0, *a, **kw):
        import torch
        c, core, env, ls, Q = orig(A[:1], center, envx[:1], env0, ls0,
                                   phl[:1], phr[:1], y1h, w, V0[:1], *a,
                                   **kw)
        rest = A.shape[0] - 1
        return (c, torch.cat([core, A[1:]]),
                torch.cat([env, env[-1:].expand(rest, *env.shape[1:])]),
                torch.cat([ls, ls[-1:].expand(rest, *ls.shape[1:])]),
                torch.cat([Q, V0[1:]]))
    return block


def half_batch(orig):
    """A sweep over every other sample, each weighing double."""
    def sweep(cores, center, LE, LE_ls, VB, UF, phis_c, y1h, w, *a, **kw):
        def half(t, axis):
            full = t.shape[axis] == w.shape[0]
            return (t[:, ::2] if axis else t[::2]).contiguous() if full else t
        return orig(cores, center, half(LE, 1), half(LE_ls, 1), VB, UF,
                    half(phis_c, 1), half(y1h, 0), 2 * half(w, 0), *a, **kw)
    return sweep


def altered(classify):
    """classify with the first answer changed to another class."""
    def wrapped(trained, X):
        preds = classify(trained, X).copy()
        labels = trained.labels
        preds[0] = labels[(np.searchsorted(labels, preds[0]) + 1)
                          % len(labels)]
        return preds
    return wrapped


FAULTS = {"unchanged": ("step", unchanged),
          "first_step_only": ("step", first_step_only),
          "half_batch": ("sweep", half_batch),
          "altered_answer": ("classify", altered)}


def can_have(cell, fault: str) -> bool:
    """Whether a cell's route can have the fault: a block's later steps
    exist only where fused blocks of several steps run, the real route (the
    complex route at q 3 runs one step a call)."""
    return (fault != "first_step_only"
            or np.dtype(cell.config["options"]["dtype"]).kind != "c")


def plant_faults(sweep_mod, fault, setattr=setattr):
    """Plant a sweep or step fault in the program's sweep module (classify
    faults are planted by the caller)."""
    kind, plant = FAULTS[fault] if fault else (None, None)
    if kind == "sweep":
        setattr(sweep_mod, "_sweep_core", plant(sweep_mod._sweep_core))
    elif kind == "step":
        for n in check.STEP_FNS:
            setattr(sweep_mod, n, plant(getattr(sweep_mod, n)))


def one_fit(cell, seed, device="cuda", cut=None, fault=None):
    """(CapturedFit, opts, data) of one fit."""
    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch.training import sweep as sweep_mod
    opts, data = harness._cut(cell, generator.make_data(cell.traffic, seed),
                              cut)
    X_tr, y_tr, X_te, _ = data
    init_rng = harness.fit_seed(seed, 0)
    ns = opts["nsweeps"]
    mids = generator.seed_rng(seed, 4).choice(np.arange(1, ns - 1), size=2,
                                               replace=False).tolist()
    fit = check.CapturedFit(0, init_rng, sorted({0, ns - 1, *mids}))
    kind, plant = FAULTS[fault] if fault else (None, None)
    saved = {n: getattr(sweep_mod, n) for n in
             ("_sweep_core",) + check.STEP_FNS}
    classify = mt.classify
    try:
        plant_faults(sweep_mod, fault)
        with check.SweepCapture(sweep_mod, fit):
            trained, _, _ = mt.fit_mps(
                X_tr, y_tr, opts=mt.MPSOptions(**opts).replace(
                    init_rng=init_rng), device=device)
        if kind == "classify":
            classify = plant(classify)
        fit.preds = classify(trained, X_te)
    finally:
        for n, f in saved.items():
            setattr(sweep_mod, n, f)
    return fit, opts, data


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        fit, opts, data = one_fit(cell, seed)
        row = {"seed": seed, "program": check.judge([fit], opts, data,
                                                    "cuda"),
               "control": check.judge([fit], opts, data, "cuda",
                                      control=True)}
        del fit
        if args.faults:
            for name in (f for f in FAULTS if can_have(cell, f)):
                f, opts, data = one_fit(cell, seed, fault=name)
                row[name] = check.judge([f], opts, data, "cuda")
                del f
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""How far rounding alone moves the golden constants of tests/test_golden.py
(ECG200, default MPSOptions, float64 on the CPU), in the JAX package and in
the port.  Not a test: run it from the repository root,

    JAX_PLATFORMS=cpu python tests/torch_golden_spread.py

1. Both packages' default f64 fits with the training series scaled by
   (1 + eps * noise), eps in {0, 1e-15, 1e-14}: sweep-1 and final train KLD,
   test accuracy and confusion.
2. The first backward sweep's first bonds at the same configuration: the
   gauge-invariant singular values of each bond matrix the two packages
   split, their largest relative difference, and the squared singular
   values around the truncation (the kept rank).
"""

import sys
from pathlib import Path

import numpy as np
import torch

import jax

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import mpstime_tpu as mj  # noqa: E402
import mpstime_tpu.training.sweep as jsweep  # noqa: E402
import mpstime_tpu_torch as mt  # noqa: E402
import mpstime_tpu_torch.training.sweep as tsweep  # noqa: E402

torch.set_num_threads(1)


def spread(data):
    Xtr, ytr, Xte, yte = data
    rng = np.random.default_rng(0)
    for eps in (0.0, 1e-15, 1e-14):
        X = Xtr * (1 + eps * rng.standard_normal(Xtr.shape)) if eps else Xtr
        for name, pkg, kw in (("jax", mj, {}), ("port", mt,
                                                dict(device="cpu"))):
            tr, info, _ = pkg.fit_mps(X, ytr, Xte, yte, pkg.MPSOptions(
                verbosity=-1, dtype="float64"), **kw)
            acc = float(np.mean(pkg.classify(tr, Xte) == yte))
            print(f"eps {eps:g} {name}: train KLD after sweep 1 "
                  f"{info['train_KL_div'][1]!r}, final "
                  f"{info['train_KL_div'][-1]!r}; test accuracy {acc}; "
                  f"confusion {np.asarray(info['test_conf'][-1]).tolist()}",
                  flush=True)


def bond_drift(data, nbonds=12):
    Xtr, ytr = data[0], data[1]
    seen = {"jax": [], "port": []}

    def capture(key, split):
        def f(M, *a, **k):
            if len(seen[key]) < nbonds:
                seen[key].append(np.linalg.svd(np.asarray(M),
                                               compute_uv=False))
            return split(M, *a, **k)
        return f

    jsweep.split_bond_left = capture("jax", jsweep.split_bond_left)
    tsweep.split_bond_left = capture("port", tsweep.split_bond_left)
    opts = dict(verbosity=-1, log_level=-1, dtype="float64", nsweeps=1)
    with jax.disable_jit():          # the hook sees every bond's values
        mj.fit_mps(Xtr, ytr, opts=mj.MPSOptions(**opts))
    mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(**opts), device="cpu")
    for i, (sj, st) in enumerate(zip(seen["jax"], seen["port"])):
        w = (sj / sj[0]) ** 2
        print(f"bond {i}: max |sv diff| / sv_max "
              f"{np.abs(sj - st).max() / sj[0]:.1e}; squared sv / largest "
              f"at ranks 23-26: {np.array2string(w[22:26], precision=2)}",
              flush=True)


if __name__ == "__main__":
    d = np.load(ROOT / "tests" / "data" / "ecg200.npz")
    data = (d["X_train"], d["y_train"], d["X_test"], d["y_test"])
    spread(data)
    bond_drift(data)

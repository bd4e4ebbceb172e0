"""How far the order of summing the gradient moves a data-parallel fit's
first sweep (ECG200, the card's default route: randomized_warm with the
Newton-Schulz refresh, KLD + TSGO, chi 25, d 5), and how far rounding alone
moves the single-device fit.  Not a test: run it from the repository root,

    python tests/torch_dp_spread.py

It runs the bond kernels' plain versions on the CPU:

1. float32: the train KLD after sweep 1 and after sweep 10 on one device
   (K12m blocks) and on meshes of 1, 2 and 4 shards (K1a on each shard, one
   sum, K1b, K2-split, K2-env on each shard).  One shard is the
   single-device fit bit for bit.
2. float64, the same after sweep 1 (the kernel route forced at float64).
3. float64 on one device with the training series scaled by
   (1 + eps * noise), eps in {0, 1e-15, 1e-14}: the KLD after sweep 1.
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import mpstime_tpu_torch as mt  # noqa: E402
from mpstime_tpu_torch.parallel import Mesh  # noqa: E402
from mpstime_tpu_torch.training import sweep as tsweep  # noqa: E402

OPTS = dict(verbosity=-1, log_level=1, svd_alg="randomized_warm",
            orth_alg="ns")


def klds(X, y, dtype, nsweeps=1, **kw):
    """The train KLD after each sweep."""
    _, info, _ = mt.fit_mps(X, y, opts=mt.MPSOptions(**OPTS, dtype=dtype,
                                                     nsweeps=nsweeps), **kw)
    return [float(v) for v in info["train_KL_div"][1:-1]]


def main():
    torch.set_num_threads(4)
    d = np.load(ROOT / "tests" / "data" / "ecg200.npz")
    X, y = d["X_train"], d["y_train"]
    for dtype, nsweeps in (("float32", 10), ("float64", 1)):
        if dtype == "float64":   # the kernel route's plain versions at f64
            tsweep._ineligible_reasons = lambda *a, **k: []
        row = {"one device": klds(X, y, dtype, nsweeps, device="cpu")}
        for n in (1, 2, 4):
            row[f"{n} shards"] = klds(X, y, dtype, nsweeps,
                                      mesh=Mesh(["cpu"] * n))
        print(f"{dtype} train KLD after sweep 1 (and {nsweeps}): "
              + "; ".join(f"{k} {v[0]:.6f} ({v[-1]:.6f})"
                          for k, v in row.items()), flush=True)
    rng = np.random.default_rng(1)
    for eps in (0.0, 1e-15, 1e-14):
        Xp = X * (1 + eps * rng.standard_normal(X.shape))
        print(f"float64 one device, series x (1 + {eps:g} noise): sweep-1 "
              f"train KLD {klds(Xp, y, 'float64', device='cpu')[0]:.6f}",
              flush=True)


if __name__ == "__main__":
    main()

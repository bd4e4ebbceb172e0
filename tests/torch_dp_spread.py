"""How far the order of summing the gradient moves a data-parallel fit's
first sweep (ECG200, the card's default route: randomized_warm with the
Newton-Schulz refresh, KLD + TSGO, chi 25, d 5), and how far rounding alone
moves the single-device fit.  Not a test: run it from the repository root,

    python tests/torch_dp_spread.py             # legendre_no_norm, real
    python tests/torch_dp_spread.py fourier     # the complex cell: q 3

It runs the bond kernels' plain versions on the CPU:

1. float32 (complex64 for fourier): the train KLD after sweep 1 and after
   sweep 10 on one device (K12m / K12c, K12mc blocks) and on meshes of 1, 2
   and 4 shards (K1a or K1c-grad on each shard, one sum, K1b or K1c-update,
   K2-split or K2c-split, K2-env or K2c-env on each shard).  One shard is
   the single-device fit bit for bit.
2. float64 (complex128), the same after sweep 1 (the kernel route forced
   at that precision).
3. float64 (complex128) on one device with the training series scaled by
   (1 + eps * noise), eps in {0, 1e-15, 1e-14}: the KLD after sweep 1.
4. float32 (complex64): the train KLD after sweep 10 on 5 shards and on one
   device with the series scaled by (1 + 1e-7 noise), six draws (rounding
   at float32's precision); then the range of the sweep-10 KLD over these
   and section 1's runs, relative to the one-shard fit's, which bounds how
   far two such runs (two shard counts) end apart.
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


def klds(X, y, encoding, dtype, nsweeps=1, **kw):
    """The train KLD after each sweep."""
    _, info, _ = mt.fit_mps(X, y, opts=mt.MPSOptions(
        **OPTS, encoding=encoding, dtype=dtype, nsweeps=nsweeps), **kw)
    return [float(v) for v in info["train_KL_div"][1:-1]]


def main():
    torch.set_num_threads(4)
    encoding = sys.argv[1] if len(sys.argv) > 1 else "legendre_no_norm"
    cplx = mt.get_encoding(encoding).is_complex
    lo, hi = ("complex64", "complex128") if cplx else ("float32", "float64")
    d = np.load(ROOT / "tests" / "data" / "ecg200.npz")
    X, y = d["X_train"], d["y_train"]
    rows = {}
    for dtype, nsweeps in ((lo, 10), (hi, 1)):
        if dtype == hi:   # the kernel route's plain versions at f64 / c128
            eligible = tsweep._ineligible_reasons
            tsweep._ineligible_reasons = lambda *a, **k: []
        row = rows[dtype] = {"one device": klds(X, y, encoding, dtype,
                                                nsweeps, device="cpu")}
        for n in (1, 2, 4):
            row[f"{n} shards"] = klds(X, y, encoding, dtype, nsweeps,
                                      mesh=Mesh(["cpu"] * n))
        print(f"{dtype} train KLD after sweep 1 (and {nsweeps}): "
              + "; ".join(f"{k} {v[0]:.6f} ({v[-1]:.6f})"
                          for k, v in row.items()), flush=True)
    rng = np.random.default_rng(1)
    for eps in (0.0, 1e-15, 1e-14):
        Xp = X * (1 + eps * rng.standard_normal(X.shape))
        print(f"{hi} one device, series x (1 + {eps:g} noise): sweep-1 "
              f"train KLD {klds(Xp, y, encoding, hi, device='cpu')[0]:.6f}",
              flush=True)
    tsweep._ineligible_reasons = eligible
    final = {k: v[-1] for k, v in rows[lo].items()}
    final["5 shards"] = klds(X, y, encoding, lo, 10,
                             mesh=Mesh(["cpu"] * 5))[-1]
    for i in range(6):
        Xp = X * (1 + 1e-7 * rng.standard_normal(X.shape))
        final[f"noise {i}"] = klds(Xp, y, encoding, lo, 10, device="cpu")[-1]
    ref = final["1 shards"]
    spread = (max(final.values()) - min(final.values())) / abs(ref)
    print(f"{lo} train KLD after sweep 10: "
          + "; ".join(f"{k} {v:.6f}" for k, v in final.items())
          + f"; range {spread:.4e} of the one-shard fit's", flush=True)


if __name__ == "__main__":
    main()

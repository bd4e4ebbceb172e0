"""The ritz route's tracked sweeps on ECG200 at chi 32, in both packages, on
the CPU: why a fourier ritz fit collapses to one class.

The tracked sweeps run K12cr (``ritz_rot_track="jacobi"``), whose basis
refresh is 8 damped tri-Newton steps.  This script fits ECG200 (fourier,
complex64, chi 32, d 5, init_rng 1, 3 sweeps: 2 exact, 1 tracked) with

  * the JAX package's XLA route (the same Jacobi rotation, QR refresh),
  * the JAX package's Pallas K12cr in interpret mode,
  * the port's K12cr plain version (8 tri-Newton steps),
  * the port's K12cr plain version with 40 tri-Newton steps,

and prints each fit's train KLD and accuracy after every sweep, and, on
the 40-step fit's tracked sweep, the inputs of the tri-Newton calls
(||X^H X - I||_F, cond(X)) and max |Q^H Q - I| after 8 and after 40 steps
from the same inputs.
Not a test (it takes about a minute); run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_ritz_probe.py
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

import mpstime_tpu as mj                                  # noqa: E402
import mpstime_tpu_torch as mt                            # noqa: E402
from mpstime_tpu.ops import pallas_bond                   # noqa: E402
from mpstime_tpu_torch.ops import decomp                  # noqa: E402

OPTS = dict(encoding="fourier", chi_max=32, d=5, nsweeps=3, verbosity=-1,
            log_level=1, dtype="complex64", svd_alg="randomized_warm_ritz",
            ritz_rot_track="jacobi", init_rng=1)


def report(name, info):
    print(f"{name}: train KLD {np.round(info['train_KL_div'], 3).tolist()}, "
          f"train acc {np.round(info['train_acc'], 3).tolist()}", flush=True)


def main():
    data = np.load(ROOT / "tests" / "data" / "ecg200.npz")
    X, y = data["X_train"], data["y_train"]
    for interpret in (False, True):
        pallas_bond.set_interpret(interpret)
        jax.clear_caches()
        _, info, _ = mj.fit_mps(X, y, opts=mj.MPSOptions(**OPTS))
        report("JAX " + ("Pallas K12cr (interpret)" if interpret
                         else "XLA route (QR refresh)"), info)
    pallas_bond.set_interpret(False)

    tri = decomp.tri_newton
    stats, steps = [], [8]

    def recording(Z):
        eye = torch.eye(Z.shape[1], dtype=Z.dtype)
        err = [float((Q.conj().T @ Q - eye).abs().max())
               for Q in (tri(Z, 8), tri(Z, 40))]
        stats.append([float(torch.linalg.vector_norm(Z.conj().T @ Z - eye)),
                      float(np.linalg.cond(Z.numpy()))] + err)
        return tri(Z, steps[0])

    decomp.tri_newton = recording
    try:
        for iters in (8, 40):
            steps[0] = iters
            stats.clear()
            _, info, _ = mt.fit_mps(X, y, device="cpu",
                                    opts=mt.MPSOptions(**OPTS))
            report(f"port K12cr plain, {iters} tri-Newton steps", info)
            if iters == 40:
                s = np.array(stats)
                print(f"  tri-Newton on the tracked sweep, {len(s)} bonds: "
                      f"||X^H X - I||_F median {np.median(s[:, 0]):.3g}, "
                      f"cond(X) median {np.median(s[:, 1]):.3g}; max "
                      f"|Q^H Q - I| median {np.median(s[:, 2]):.3g} after 8 "
                      f"steps, {np.median(s[:, 3]):.3g} after 40 (bonds "
                      f"above 1e-3: {int((s[:, 2] > 1e-3).sum())}, "
                      f"{int((s[:, 3] > 1e-3).sum())})", flush=True)
    finally:
        decomp.tri_newton = tri


if __name__ == "__main__":
    main()

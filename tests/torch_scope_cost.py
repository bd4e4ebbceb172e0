"""What the sweep's two profiler ranges ("mps/backward_bond" and
"mps/forward_bond", training/sweep.py) cost when no profiler runs.  Not a
test: run it from the repository root with a CUDA card,

    python tests/torch_scope_cost.py [rounds]

It fits ECG200 (10 sweeps) in one process, in turns with the ranges as
they are and with ``torch.profiler.record_function`` replaced by a
context manager that does nothing, for the default options, the default
options on ``make_mesh(1)`` (the dp chain, host-bound) and the qr options
(``orth_alg="qr", subspace_refresh_every=2``: host-bound refresh sweeps),
``rounds`` times each (5 by default), and prints the median sweep seconds
after one warm sweep of every fit (refresh sweeps only for the qr
options) and the medians over the rounds, as one JSON line after the
card's name and power limit.  Each round swaps which side runs first.
Imports nothing of JAX.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch.kernels import build
    from mpstime_tpu_torch.parallel import make_mesh
    if not torch.cuda.is_available():
        print("torch_scope_cost: no CUDA device", file=sys.stderr)
        return 2
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    data = np.load(os.path.join("tests", "data", "ecg200.npz"))
    X, y = data["X_train"], data["y_train"]
    scoped = torch.profiler.record_function
    base = mt.MPSOptions(verbosity=-1, log_level=-1)
    cells = {"default": (base, dict(device="cuda"), slice(1, None)),
             "dp": (base, dict(mesh=make_mesh(1)), slice(1, None)),
             "qr refresh": (base.replace(orth_alg="qr",
                                         subspace_refresh_every=2),
                            dict(device="cuda"), slice(2, None, 2))}
    out = {c: {"scoped": [], "unscoped": []} for c in cells}
    for r in range(rounds):
        for cell, (opts, where, sweeps) in cells.items():
            # each round swaps which side goes first
            for side in ("scoped", "unscoped")[::1 - 2 * (r % 2)]:
                torch.profiler.record_function = (
                    scoped if side == "scoped"
                    else lambda *a, **k: contextlib.nullcontext())
                try:
                    _, info, _ = mt.fit_mps(X, y, opts=opts, **where)
                finally:
                    torch.profiler.record_function = scoped
                out[cell][side].append(
                    statistics.median(info["sweep_seconds"][sweeps]))
    for cell in out.values():
        for side in ("scoped", "unscoped"):
            cell[side + "_median"] = statistics.median(cell[side])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The data-parallel fits of one or more checkouts of the port, timed on one
card in the order given, each checkout in a process of its own (two
packages of one name cannot share a process).  Not a test: run it from the
repository root with a CUDA card,

    python tests/torch_dp_ab.py PARENT . . PARENT

where PARENT is another commit unpacked with `git archive` into a directory
that .gitignore lists; parent, change, change, parent puts both commits on
the same card in turns.  For each checkout and each of the default and the
fourier options (ECG200, 10 sweeps on make_mesh(1), every bond K1a or
K1c-grad -> sum -> K1b or K1c-update -> K2-split or K2c-split -> K2-env or
K2c-env) it prints one JSON line: the median sweep after one warm sweep,
then one more sweep under torch.profiler, its device busy and wall ms and
the device ms of the K1a / K1c-grad kernel (one block or cluster).  The
card's name and power limit come first.  Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch.kernels import build
    from mpstime_tpu_torch.parallel import make_mesh
    if not mt.__file__.startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {mt.__file__}, not the tree at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    data = np.load(os.path.join(root, "tests", "data", "ecg200.npz"))
    X, y = data["X_train"], data["y_train"]
    out = {"tree": root}
    for label, kw in (("dp", {}), ("complex dp", {"encoding": "fourier"})):
        opts = mt.MPSOptions(verbosity=-1, log_level=-1, **kw)
        _, info, _ = mt.fit_mps(X, y, opts=opts, mesh=make_mesh(1))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, p_info, _ = mt.fit_mps(X, y, opts=opts.replace(nsweeps=1),
                                      mesh=make_mesh(1))
            torch.cuda.synchronize()
        dev = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
        out[label] = dict(
            median_sweep_s=statistics.median(info["sweep_seconds"][1:]),
            busy_ms=sum(dev.values()),
            wall_ms=1e3 * sum(p_info["sweep_seconds"]),
            k1a_ms=sum(v for n, v in dev.items() if "k1a_" in n))
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The data-parallel and qr fits of one or more checkouts of the port, timed
on one card in the order given, each checkout in a process of its own (two
packages of one name cannot share a process).  Not a test: run it from the
repository root with a CUDA card,

    python tests/torch_dp_ab.py PARENT . . PARENT

where PARENT is another commit unpacked with `git archive` into a directory
that .gitignore lists; parent, change, change, parent puts both commits on
the same card in turns.  For each checkout and each of the default and the
fourier options (ECG200, 10 sweeps on make_mesh(1), and the default options
on two shards of the card; every bond K1a or K1c-grad -> sum -> K1b or
K1c-update -> K2-split or K2c-split -> K2-env or K2c-env) it prints the
median sweep after one warm sweep, then one more
sweep under torch.profiler, its device busy and wall ms and the device ms
of the K1a / K1c-grad, K1b / K1c-update, K2-split / K2c-split and K2-env /
K2c-env kernels (one block, cluster or row tiles); for the qr fit (the default options with
orth_alg="qr", subspace_refresh_every=2: refresh sweeps K1 -> QR -> K2 per
bond, frozen sweeps K12m blocks) and the fourier qr fit (the same with
encoding="fourier": K1c -> realified QR -> K2c, frozen sweeps K12mc blocks)
the median refresh and frozen sweeps over 10, then one refresh + one
frozen sweep under torch.profiler, its busy and wall ms and K1's and K2's
(K1c's and K2c's) device ms; all as one JSON line per checkout.  The
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
    from mpstime_tpu_torch.parallel import Mesh, make_mesh
    if not mt.__file__.startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {mt.__file__}, not the tree at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    data = np.load(os.path.join(root, "tests", "data", "ecg200.npz"))
    X, y = data["X_train"], data["y_train"]
    out = {"tree": root}

    def profiled(opts, **where):
        """Device ms by kernel and sweep wall ms of a fit under
        torch.profiler."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, p_info, _ = mt.fit_mps(X, y, opts=opts, **where)
            torch.cuda.synchronize()
        dev = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
        return dev, 1e3 * sum(p_info["sweep_seconds"])

    def kernel_ms(dev, *kerns):
        return sum(v for n, v in dev.items() if any(k in n for k in kerns))

    two = Mesh(["cuda:0"] * 2)
    for label, kw, mesh in (("dp", {}, make_mesh(1)), ("dp2", {}, two),
                            ("complex dp", {"encoding": "fourier"},
                             make_mesh(1))):
        opts = mt.MPSOptions(verbosity=-1, log_level=-1, **kw)
        _, info, _ = mt.fit_mps(X, y, opts=opts, mesh=mesh)
        dev, wall = profiled(opts.replace(nsweeps=1), mesh=mesh)
        out[label] = dict(
            median_sweep_s=statistics.median(info["sweep_seconds"][1:]),
            busy_ms=sum(dev.values()), wall_ms=wall,
            k1a_ms=kernel_ms(dev, "k1a_"), k1b_ms=kernel_ms(dev, "k1b_"),
            k2_split_ms=kernel_ms(dev, "k2_split_"),
            k2_env_ms=kernel_ms(dev, "k2_env_"))
    for label, kw in (("qr", {}), ("fourier qr", {"encoding": "fourier"})):
        opts = mt.MPSOptions(verbosity=-1, log_level=-1, orth_alg="qr",
                             subspace_refresh_every=2, **kw)
        _, info, _ = mt.fit_mps(X, y, opts=opts, device="cuda")
        secs = info["sweep_seconds"]
        dev, wall = profiled(opts.replace(nsweeps=2), device="cuda")
        out[label] = dict(
            median_refresh_sweep_s=statistics.median(secs[2::2]),
            median_frozen_sweep_s=statistics.median(secs[1::2]),
            busy_ms=sum(dev.values()), wall_ms=wall,
            k1_ms=kernel_ms(dev, "k1_kernel", "k1_cluster_kernel"),
            k2_ms=kernel_ms(dev, "k2_kernel", "k2_cluster_kernel"))
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

"""The bond kernels whose power steps run Newton-Schulz tails (K12, K12m,
K12c, K12mc, K1b, K1c-update) of one or more checkouts of the port, timed
on one card in the order given and compared bit for bit, each checkout in
a process of its own (two packages of one name cannot share a process).
Not a test: run it from the repository root with a CUDA card,

    python tests/torch_kernel_ab.py OUT PARENT . . PARENT

where PARENT is another commit unpacked with `git archive` into a directory
that .gitignore lists and OUT a directory for the outputs; parent, change,
change, parent puts both commits on the same card in turns.  Each checkout
builds its library (the build's seconds and ptxas's lines for the kernels
and their device functions go to OUT/ptxas_<n>.txt), then runs every case
on seeded operands (C 2, d 5; chi 25 at N 100 as the kernel table's rows,
and N 1000; real chi 28-64 and complex chi 32 at N 100) and times it:
per-call device ms of 20 calls enqueued while the card spins, the least
and the median of 5 rounds.
It prints one JSON line per checkout (the card's name and power limit
first) and saves each case's outputs to OUT/out_<n>.pt; at the end one JSON
line says, case by case, whether every checkout computed the first one's
bits (torch.equal on every output).  Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys

SPIN_CYCLES = 100_000_000
SHAPE = dict(C=2, chi=25, d=5, N=100)


def _inputs(seed, Bb, C, chi, d, N, cplx):
    import numpy as np
    import torch
    from mpstime_tpu_torch.ops.decomp import warm_sketch_init
    rng = np.random.default_rng(seed)
    dt = np.complex64 if cplx else np.float32

    def t(*shape):
        z = rng.standard_normal(shape)
        if cplx:
            z = z + 1j * rng.standard_normal(shape)
        return torch.from_numpy(z.astype(dt)).cuda()

    def phi(*shape):
        if cplx:
            z = np.exp(1j * rng.uniform(-np.pi, np.pi, shape)) / np.sqrt(d)
        else:
            z = rng.uniform(-0.8, 0.8, shape)
        return torch.from_numpy(z.astype(dt)).cuda()

    def r(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    return dict(
        A=t(Bb, chi, d, chi), center=t(C, chi, d, chi), envx=t(Bb, N, chi),
        env0=t(N, chi), ls0=r(rng.standard_normal(N)),
        phil=phi(Bb, N, d), phir=phi(Bb, N, d),
        y1h=r(np.eye(C)[rng.integers(0, C, N)]), w=r(np.full(N, 1.0 / N)),
        V0=torch.stack([warm_sketch_init(chi * d, chi, dt, "cuda")] * Bb))


def _cases(bk, bkc):
    """name -> a call of one kernel on its seeded operands."""
    def single(x):
        return (x["A"][0], x["center"], x["envx"][0], x["env0"], x["ls0"],
                x["phil"][0], x["phir"][0], x["y1h"], x["w"], x["V0"][0],
                0.05, 1e-10)

    def block(x):
        return (x["A"], x["center"], x["envx"], x["env0"], x["ls0"],
                x["phil"], x["phir"], x["y1h"], x["w"], x["V0"], 0.05, 1e-10)

    def pieces(x, cplx):
        """K1b's (K1c-update's) operands, its gradient from K1a
        (K1c-grad) on the same inputs."""
        grad = bkc.k1c_grad_cuda if cplx else bk.k1a_cuda
        a = (x["A"][0], x["center"], x["envx"][0], x["env0"], x["phil"][0],
             x["phir"][0], x["y1h"], x["w"], x["ls0"])
        return (x["A"][0], x["center"], grad(*a, forward=False), x["V0"][0],
                0.05)

    cases = {}
    for N in (100, 1000):
        s = dict(SHAPE, N=N)
        xr, xc = _inputs(1, 1, **s, cplx=False), _inputs(2, 1, **s, cplx=True)
        x8, x4 = _inputs(3, 8, **s, cplx=False), _inputs(4, 4, **s, cplx=True)
        kw = dict(forward=False)
        cases.update({
            f"k12 N{N} q1": lambda xr=xr, kw=kw: bk.k12_cuda(
                *single(xr), power_iters=1, **kw),
            f"k12m Bb8 N{N} q1": lambda x8=x8, kw=kw: bk.k12m_cuda(
                *block(x8), power_iters=1, **kw),
            f"k12c N{N} q3": lambda xc=xc, kw=kw: bkc.k12c_cuda(
                *single(xc), power_iters=3, **kw),
            f"k12c N{N} q1": lambda xc=xc, kw=kw: bkc.k12c_cuda(
                *single(xc), power_iters=1, **kw),
        })
        if N == 100:
            pr, pc = pieces(xr, False), pieces(xc, True)
            cases.update({
                "k12mc Bb4 frozen": lambda x4=x4, kw=kw: bkc.k12mc_cuda(
                    *block(x4), refresh=False, **kw),
                "k1b q1 ns": lambda pr=pr, kw=kw: bk.k1b_cuda(
                    *pr, power_iters=1, orth="ns", **kw),
                "k1c_update q3 ns": lambda pc=pc, kw=kw: bkc.k1c_update_cuda(
                    *pc, power_iters=3, orth="ns", **kw),
            })
    # real bonds from chi 28 to 64, where the leader's tail meets the team's,
    # and a complex one
    for chi, cplx in ((28, False), (32, False), (36, False), (40, False),
                      (44, False), (64, False), (32, True)):
        x = _inputs(5, 1, **dict(SHAPE, chi=chi), cplx=cplx)
        step = bkc.k12c_cuda if cplx else bk.k12_cuda
        name = f"{'k12c' if cplx else 'k12'} chi{chi} q1"
        cases[name] = lambda x=x, step=step: step(*single(x), power_iters=1,
                                                  forward=False)
    return cases


def _queued_ms(fn, iters=20):
    """Per-call device ms of ``fn``: ``iters`` calls enqueued while the card
    spins, so that the events time the card, not the host between
    launches; None if the host took longer to enqueue than the spin."""
    import time
    import torch
    es, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    es.record()
    torch.cuda._sleep(SPIN_CYCLES)
    e0.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    e1.record()
    torch.cuda.synchronize()
    if host_ms >= es.elapsed_time(e0):
        return None
    return e0.elapsed_time(e1) / iters


def measure(root: str, out: str, n: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch.kernels import build
    from mpstime_tpu_torch.ops import bond_kernels as bk
    from mpstime_tpu_torch.ops import bond_kernels_c as bkc
    if not mt.__file__.startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {mt.__file__}, not the tree at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    with open(os.path.join(out, f"ptxas_{n}.txt"), "w") as f:
        f.write(f"{root}: built in {build.last_build_seconds:.1f} s\n")
        f.write(build.build_log)
    cases = _cases(bk, bkc)
    outs, times = {}, {}
    for name, fn in cases.items():
        got = fn()
        torch.cuda.synchronize()
        outs[name] = [t.cpu() for t in (got if isinstance(got, tuple)
                                        else (got,))]
        rounds = [ms for ms in (_queued_ms(fn) for _ in range(5))
                  if ms is not None]
        times[name] = ([round(min(rounds), 5),
                        round(statistics.median(rounds), 5)]
                       if rounds else None)
    torch.save(outs, os.path.join(out, f"out_{n}.pt"))
    polar = dict(getattr(bk, "POLAR_STEPS", {}))
    return {"tree": root, "ms_least_median": times, "polar_steps": polar}


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--one":
        out, n = sys.argv[3], int(sys.argv[4])
        print(json.dumps(measure(sys.argv[2], out, n)), flush=True)
        return 0
    if len(sys.argv) < 3:
        print(__doc__)
        return 2
    out = sys.argv[1]
    os.makedirs(out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    roots = sys.argv[2:]
    for n, root in enumerate(roots):
        subprocess.run([sys.executable, __file__, "--one", root, out, str(n)],
                       check=True)
    import torch
    outs = [torch.load(os.path.join(out, f"out_{n}.pt"))
            for n in range(len(roots))]
    same = {name: all(len(o[name]) == len(outs[0][name]) and
                      all(torch.equal(a, b)
                          for a, b in zip(o[name], outs[0][name]))
                      for o in outs[1:])
            for name in outs[0]}
    print(json.dumps({"bits_equal_to_first": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

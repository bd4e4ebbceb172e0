#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port (mpstime_tpu_torch) on one GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, one status line each; any failure exits non-zero:
  1. device: the card's name and power limit, torch/CUDA versions; TF32 off.
  2. build: compile the kernels from mpstime_tpu_torch/csrc/.
  3. kernel vs plain: K12, K12m, K1 and K2 against their plain PyTorch
     versions on the card at the main-path shape (C=2, chi=25, d=5, N=100)
     over their variant grids, K12m against chained K12 launches, the
     degenerate cutoff tie-break case (through K12 and through K2), and a
     whole QR bond (K1 -> torch.linalg.qr -> K2) against the plain QR bond
     around the same QR call; then each kernel's time beside its plain
     version's and the QR's.
  4. main path: fit_mps on ECG200 at the default MPSOptions (f32, chi 25,
     d 5, 10 sweeps, KLD -> K12m), device="cuda", then classify; checks
     the launch counts, the plain-version counts and the test accuracy.
     Then a 2-sweep MSE fit (-> K12) through the same entry point, its
     counts read from its own run, and the default fit at two more init
     seeds (accuracy reported, not held to the floor).
  5. qr path: fit_mps with orth_alg="qr", subspace_refresh_every=2 (refresh
     sweeps -> K1 -> QR -> K2 per bond, frozen sweeps -> K12m), counts read
     from its own run, then classify; then a refresh and a frozen sweep of
     it under torch.profiler (device time by kernel).
  6. unfused path: a 2-sweep gram_eigh fit with track_cost on the card,
     which runs no kernel and no plain version of one.
Then one JSON line of per-kernel results (each kernel's launches from the
fit that runs it; its bound, the least time the card could take for the
work of the timed call: bytes over 3.35 TB/s or float32 operations over
67 TFLOP/s, whichever is larger), the nvidia-smi line, and the final JSON
status line.

Exits 2 without a result when no CUDA device is available or the package
is not beside this script.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
RTOL, ATOL = 1e-4, 3e-5          # as tests/test_pallas_bond.py:73-82
CHAIN_ATOL = 1e-6                # K12m vs chained K12 launches
ACC_FLOOR = 0.85                 # f32 floor of the JAX hardware lane
QR_ACC_FLOOR = 0.80              # below the 0.84-0.91 seed spread of the ns route
SHAPE = dict(C=2, chi=25, d=5, N=100)
PEAK_BYTES_S = 3.35e12           # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12          # H100 SXM float32 outside the tensor cores
KERNEL_SRC = "mpstime_tpu_torch/csrc/bond_step.cu"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bond_inputs(seed: int, Bb: int, C: int, chi: int, d: int, N: int):
    """Numpy-seeded operands of a block of Bb bonds, on the card."""
    from mpstime_tpu_torch.ops.decomp import warm_sketch_init
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    return dict(
        A=t(rng.standard_normal((Bb, chi, d, chi))),
        center=t(rng.standard_normal((C, chi, d, chi))),
        envx=t(rng.standard_normal((Bb, N, chi))),
        env0=t(rng.standard_normal((N, chi))),
        ls0=t(rng.standard_normal(N)),
        opp=t(0.3 * rng.standard_normal(N)),
        phil=t(rng.uniform(-0.8, 0.8, (Bb, N, d))),
        phir=t(rng.uniform(-0.8, 0.8, (Bb, N, d))),
        y1h=t(np.eye(C)[rng.integers(0, C, N)]),
        w=t(np.full(N, 1.0 / N)),
        V0=torch.stack([warm_sketch_init(chi * d, chi, np.float32, "cuda")] * Bb),
    )


def k12_args(x, forward: bool, b: int = 0):
    le, re = (x["env0"], x["envx"][b]) if forward else (x["envx"][b], x["env0"])
    return (x["A"][b], x["center"], le, re, x["ls0"], x["phil"][b],
            x["phir"][b], x["y1h"], x["w"], x["V0"][b], 0.05, 1e-10)


def k12m_args(x):
    return (x["A"], x["center"], x["envx"], x["env0"], x["ls0"], x["phil"],
            x["phir"], x["y1h"], x["w"], x["V0"], 0.05, 1e-10)


def k1_args(x, forward: bool):
    """K1's operands from bond_inputs: gls is the total log-scale."""
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                       x["env0"])
    return (x["A"][0], x["center"], le, re, x["phil"][0], x["phir"][0],
            x["y1h"], x["w"], x["ls0"] + x["opp"], x["V0"][0], 0.05)


def k2_args(bk, x, forward: bool):
    """K2's operands: the plain K1's bond tensor and the QR of its Y."""
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                       x["env0"])
    BT, Y = bk.k1_plain(*k1_args(x, forward), forward=forward)
    Q = torch.linalg.qr(Y).Q.contiguous()
    env, phi = (le, x["phil"][0]) if forward else (re, x["phir"][0])
    return BT, Q, env, x["ls0"], phi, 1e-10


def compare_all(name, got, ref, atol=ATOL, rtol=RTOL) -> float:
    """Max abs error over any outputs; raises past tolerance."""
    err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        check(g.shape == r.shape, f"{name}: output {i} shape "
              f"{tuple(g.shape)} != {tuple(r.shape)}")
        check(bool(torch.isfinite(g).all()), f"{name}: output {i} not finite")
        diff = (g - r).abs()
        err = max(err, float(diff.max()))
        check(not bool((diff > atol + rtol * r.abs()).any()),
              f"{name}: output {i} max |diff| {float(diff.max()):.3e} beyond "
              f"atol {atol} + rtol {rtol}")
    return err


def kept(core, forward: bool):
    """Kept-direction mask of an emitted core ([.., m, k, b] backward,
    [.., a, i, m] forward)."""
    if forward:
        return (core != 0).any(dim=-2).any(dim=-2)
    return (core != 0).any(dim=-1).any(dim=-1)


def compare(name, got, ref, forward, atol=ATOL, rtol=RTOL) -> float:
    """Max abs error over the outputs (center, core, env, env_ls and, where
    given, Q); raises past tolerance or on a kept-rank mismatch."""
    err = 0.0
    for label, g, r in zip(("center", "core", "env", "env_ls", "Q"), got, ref):
        check(g.shape == r.shape, f"{name}: {label} shape {tuple(g.shape)} "
              f"!= {tuple(r.shape)}")
        check(bool(torch.isfinite(g).all()), f"{name}: {label} not finite")
        diff = (g - r).abs()
        err = max(err, float(diff.max()))
        bad = diff > atol + rtol * r.abs()
        check(not bool(bad.any()), f"{name}: {label} max |diff| "
              f"{float(diff.max()):.3e} beyond atol {atol} + rtol {rtol}")
    kg, kr = kept(got[1], forward), kept(ref[1], forward)
    check(bool(torch.equal(kg, kr)), f"{name}: kept ranks differ "
          f"({kg.sum(-1).tolist()} vs {kr.sum(-1).tolist()})")
    return err


def k1_work(C, chi, d, N, *, emit_y=True, q=1, qr=True, mse=False):
    """(float32 operations, bytes) of one K1 call: two per multiply-add of
    its products, one per elementwise operation; each operand read once and
    each result written once."""
    P, K = chi * d, chi
    mac = C * P * P * chi + 2 * C * N * P * P + N * C * P
    ops = 2 * mac + 2 * N * P + 2 * C * N * P + 6 * C * P * P
    if emit_y:
        ns = 0 if qr else (8 * (K * K * P + K ** 3 + P * K * K)
                           + 6 * (K * K * P + P * K * K))
        ops += q * (2 * (2 * C * P * K * P + ns) + 6 * P * K)
    reads = (P * chi * (C + 1) + 2 * N * chi + 2 * N * d + N * C + N + P * K
             + (N if mse else 0))
    writes = C * P * P + P * K
    return ops, 4 * (reads + writes)


def k2_work(C, chi, d, N):
    """(float32 operations, bytes) of one K2 call."""
    P, K = chi * d, chi
    ops = (2 * (C * P * K * P + N * K * P) + 2 * C * P * K + 3 * K * K
           + 2 * N * P + 2 * C * P * K + 3 * N * K)
    reads = C * P * P + P * K + N * chi + N + N * d
    writes = C * chi * d * chi + chi * d * chi + N * chi + N
    return ops, 4 * (reads + writes)


def k12_work(C, chi, d, N, *, Bb=1, refresh=True, q=1, mse=False):
    """(float32 operations, bytes) of one K12 / K12m call over Bb bonds:
    K1 with the Newton-Schulz power step and K2, BT kept on chip."""
    o1, _ = k1_work(C, chi, d, N, emit_y=refresh, q=q, qr=False, mse=mse)
    o2, _ = k2_work(C, chi, d, N)
    P = chi * d
    reads = (Bb * chi * d * chi + C * chi * d * chi + (Bb + 1) * N * chi + N
             + 2 * Bb * N * d + N * C + N + Bb * P * chi
             + (N if mse else 0))
    writes = (C * chi * d * chi + Bb * (chi * d * chi + N * chi + N
                                        + P * chi))
    return Bb * (o1 + o2), 4 * (reads + writes)


def bound(work):
    """(bound_ms, bound_by) of (operations, bytes)."""
    ops, nbytes = work
    t_ops, t_bytes = ops / PEAK_F32_FLOP_S, nbytes / PEAK_BYTES_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def tie_break_inputs():
    """The degenerate-spectrum oracle of tests/test_pallas_bond.py:144-179
    as a whole bond step: BT[0, i, 0, j] = sqrt(w_j) delta_ij with w =
    [4, 2, 2, 2, 1, 0.5], Q selecting the k=0 block (frozen bond, eta 0),
    so the projected energies tie and the cutoff boundary falls inside the
    tie group.  The stable order keeps exactly directions 0..2."""
    chi, d, C, N = 6, 2, 1, 4
    w = np.array([4.0, 2.0, 2.0, 2.0, 1.0, 0.5], np.float32)
    A = np.zeros((chi, d, chi), np.float32)
    A.reshape(chi * d, chi)[:chi] = np.eye(chi)
    center = np.zeros((C, chi, d, chi), np.float32)
    center[0, :, 0, :] = np.diag(np.sqrt(w))
    V0 = np.zeros((d * chi, chi), np.float32)
    V0[:chi] = np.eye(chi)
    env = np.zeros((N, chi), np.float32)
    env[:, 0] = 1.0
    phi = np.full((N, d), 0.5, np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    cutoff = float(np.float32(4.5 / w.sum()))
    return (t(A), t(center), t(env), t(env), t(np.zeros(N, np.float32)),
            t(phi), t(phi), t(np.ones((N, C), np.float32)),
            t(np.full(N, 1.0 / N, np.float32)), t(V0), 0.0, cutoff)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "mpstime_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: mpstime_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    # ---- 1. device --------------------------------------------------------
    card = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)

    # ---- 2. build ---------------------------------------------------------
    from mpstime_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.load_library()
    print(f"[build] {build.library_path().relative_to(ROOT)} ready in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{build.last_build_seconds:.2f} s)", flush=True)

    from mpstime_tpu_torch.ops import bond_kernels as bk

    # ---- 3. kernel vs plain ----------------------------------------------
    err = {"k12": 0.0, "k12m": 0.0}
    n_cases = {"k12": 0, "k12m": 0}
    k12_grid = []
    for forward in (False, True):
        for q in (1, 3):
            k12_grid.append((forward, True, q, "KLD", "TSGO", None))
        k12_grid.append((forward, False, 1, "KLD", "TSGO", None))
        for loss in ("KLD", "MSE"):
            for bbopt in ("TSGO", "GD"):
                k12_grid.append((forward, True, 1, loss, bbopt, None))
        k12_grid.append((forward, True, 1, "KLD", "TSGO", 17))
    for i, (forward, refresh, q, loss, bbopt, mr) in enumerate(k12_grid):
        x = bond_inputs(100 + i, 1, **SHAPE)
        kw = dict(forward=forward, refresh=refresh, power_iters=q,
                  max_rank=mr, loss=loss, bbopt=bbopt,
                  opp_ls=x["opp"] if loss == "MSE" else None)
        name = (f"K12 {'fwd' if forward else 'bwd'} refresh={refresh} q={q} "
                f"{loss}/{bbopt} max_rank={mr}")
        got = bk.k12_cuda(*k12_args(x, forward), **kw)
        torch.cuda.synchronize()
        ref = bk.k12_plain(*k12_args(x, forward), **kw)
        err["k12"] = max(err["k12"], compare(name, got, ref, forward))
        n_cases["k12"] += 1
    for i, (Bb, forward, refresh) in enumerate(
            (Bb, f, r) for Bb in (8, 7) for f in (False, True)
            for r in (True, False)):
        x = bond_inputs(200 + i, Bb, **SHAPE)
        kw = dict(forward=forward, refresh=refresh, power_iters=1)
        name = f"K12m Bb={Bb} {'fwd' if forward else 'bwd'} refresh={refresh}"
        got = bk.k12m_cuda(*k12m_args(x), **kw)
        torch.cuda.synchronize()
        ref = bk.k12m_plain(*k12m_args(x), **kw)
        err["k12m"] = max(err["k12m"], compare(name, got, ref, forward))
        # the block equals Bb chained single-bond launches
        center, env, ls, chain = x["center"], x["env0"], x["ls0"], []
        for b in range(Bb):
            le, re = (env, x["envx"][b]) if forward else (x["envx"][b], env)
            center, core, env, ls, Q = bk.k12_cuda(
                x["A"][b], center, le, re, ls, x["phil"][b], x["phir"][b],
                x["y1h"], x["w"], x["V0"][b], 0.05, 1e-10, **kw)
            chain.append((core, env, ls, Q))
        chained = (center,) + tuple(torch.stack(c) for c in zip(*chain))
        compare(name + " vs chained K12", got, chained, forward,
                atol=CHAIN_ATOL, rtol=0.0)
        n_cases["k12m"] += 1
    tb = tie_break_inputs()
    kw = dict(forward=False, refresh=False, power_iters=1)
    got = bk.k12_cuda(*tb, **kw)
    ref = bk.k12_plain(*tb, **kw)
    err["k12"] = max(err["k12"], compare("K12 tie-break", got, ref,
                                         False))
    kept_dirs = kept(got[1], False).tolist()
    check(kept_dirs == [True, True, True, False, False, False],
          f"tie-break kept {kept_dirs}")
    print(f"[kernel-vs-plain] K12 {n_cases['k12']} cases + tie-break, max "
          f"|err| {err['k12']:.3e}; K12m {n_cases['k12m']} cases, max |err| "
          f"{err['k12m']:.3e} (rtol {RTOL}, atol {ATOL}; K12m vs chained "
          f"K12 atol {CHAIN_ATOL}); kept ranks equal", flush=True)

    # K1 over its grid: BT and Y (the column-normalised iterate under
    # orth="qr", before any QR)
    err["k1"] = err["k2"] = 0.0
    n_cases["k1"] = n_cases["k2"] = 0
    k1_grid = [(f, e, q, loss, bbopt) for f in (False, True)
               for e in (True, False) for q in (1, 3)
               for loss in ("KLD", "MSE") for bbopt in ("TSGO", "GD")]
    for i, (forward, emit_y, q, loss, bbopt) in enumerate(k1_grid):
        x = bond_inputs(300 + i, 1, **SHAPE)
        args = k1_args(x, forward)
        kw = dict(forward=forward, emit_y=emit_y, power_iters=q, orth="qr",
                  loss=loss, bbopt=bbopt)
        got = bk.k1_cuda(*args, **kw)
        torch.cuda.synchronize()
        ref = bk.k1_plain(*args, **kw)
        err["k1"] = max(err["k1"], compare_all(f"K1 {kw}", got, ref))
        n_cases["k1"] += 1
    for i, (forward, mr) in enumerate((f, m) for f in (False, True)
                                      for m in (None, 17)):
        args = k2_args(bk, bond_inputs(400 + i, 1, **SHAPE), forward)
        got = bk.k2_cuda(*args, forward=forward, max_rank=mr)
        torch.cuda.synchronize()
        ref = bk.k2_plain(*args, forward=forward, max_rank=mr)
        name = f"K2 {'fwd' if forward else 'bwd'} max_rank={mr}"
        err["k2"] = max(err["k2"], compare(name, got, ref, forward))
        n_cases["k2"] += 1
    # the tie-break case fed to K2: its bond tensor (eta 0) and the basis
    A, center, le, re, ls, phil, phir, y1h, w, V0, _, cutoff = tb
    BT, _ = bk.k1_plain(A, center, le, re, phil, phir, y1h, w, ls, V0, 0.0,
                        forward=False, emit_y=False)
    got = bk.k2_cuda(BT, V0, re, ls, phir, cutoff, forward=False)
    ref = bk.k2_plain(BT, V0, re, ls, phir, cutoff, forward=False)
    err["k2"] = max(err["k2"], compare("K2 tie-break", got, ref, False))
    kept_dirs = kept(got[1], False).tolist()
    check(kept_dirs == [True, True, True, False, False, False],
          f"K2 tie-break kept {kept_dirs}")
    # a whole QR bond: both sides orthonormalise with torch.linalg.qr
    qr_err = 0.0
    for i, (forward, loss) in enumerate((f, l) for f in (False, True)
                                        for l in ("KLD", "MSE")):
        x = bond_inputs(500 + i, 1, **SHAPE)
        kw = dict(forward=forward, loss=loss,
                  opp_ls=x["opp"] if loss == "MSE" else None)
        got = bk.qr_bond_step(*k12_args(x, forward), plain=False, **kw)
        torch.cuda.synchronize()
        ref = bk.qr_bond_step(*k12_args(x, forward), plain=True, **kw)
        qr_err = max(qr_err, compare(f"QR bond {kw['forward']} {loss}", got,
                                     ref, forward))
    print(f"[kernel-vs-plain] K1 {n_cases['k1']} cases, max |err| "
          f"{err['k1']:.3e}; K2 {n_cases['k2']} cases + tie-break (kept "
          f"directions 0..2), max |err| {err['k2']:.3e}; QR bond (K1 -> "
          f"torch.linalg.qr -> K2) 4 cases, max |err| {qr_err:.3e} (rtol "
          f"{RTOL}, atol {ATOL}); kept ranks equal", flush=True)

    x1 = bond_inputs(7, 1, **SHAPE)
    x8 = bond_inputs(8, 8, **SHAPE)
    kw1 = dict(forward=False, refresh=True, power_iters=1)
    times = {
        "k12": (time_ms(lambda: bk.k12_cuda(*k12_args(x1, False), **kw1)),
                time_ms(lambda: bk.k12_plain(*k12_args(x1, False), **kw1))),
        "k12m": (time_ms(lambda: bk.k12m_cuda(*k12m_args(x8), **kw1)),
                 time_ms(lambda: bk.k12m_plain(*k12m_args(x8), **kw1))),
    }
    print(f"[timing] one refresh bond (K12) {times['k12'][0]:.3f} ms vs plain "
          f"{times['k12'][1]:.3f} ms; an 8-bond block (K12m) "
          f"{times['k12m'][0]:.3f} ms vs plain {times['k12m'][1]:.3f} ms "
          f"({card})", flush=True)
    a1 = k1_args(x1, False)
    BT1, Y1 = bk.k1_cuda(*a1, forward=False)
    Q1 = torch.linalg.qr(Y1).Q.contiguous()
    a2 = (BT1, Q1, x1["envx"][0], x1["ls0"], x1["phir"][0], 1e-10)
    times["k1"] = (time_ms(lambda: bk.k1_cuda(*a1, forward=False)),
                   time_ms(lambda: bk.k1_plain(*a1, forward=False)))
    times["k2"] = (time_ms(lambda: bk.k2_cuda(*a2, forward=False)),
                   time_ms(lambda: bk.k2_plain(*a2, forward=False)))
    qr_ms = time_ms(lambda: torch.linalg.qr(Y1))
    print(f"[timing] one qr refresh bond: K1 {times['k1'][0]:.3f} ms vs plain "
          f"{times['k1'][1]:.3f} ms; torch.linalg.qr of Y "
          f"{list(Y1.shape)} {qr_ms:.3f} ms; K2 {times['k2'][0]:.3f} ms vs "
          f"plain {times['k2'][1]:.3f} ms ({card})", flush=True)

    # ---- 4. main path -----------------------------------------------------
    import mpstime_tpu_torch as mt
    data = np.load(ROOT / "tests" / "data" / "ecg200.npz")
    Xtr, ytr, Xte, yte = (data["X_train"], data["y_train"], data["X_test"],
                          data["y_test"])
    # the default fit (KLD) runs K12m blocks; its counts are read from its
    # own run alone
    bk.reset_counts()
    trained, info, _ = mt.fit_mps(Xtr, ytr, Xte, yte,
                                  mt.MPSOptions(verbosity=-1, log_level=-1),
                                  device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = mt.classify(trained, Xte)
    torch.cuda.synchronize()
    classify_s = time.perf_counter() - t0
    launches, plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
    acc = float(np.mean(preds == yte))
    m = trained.mps
    check(m.cores.is_cuda and m.center.is_cuda, "model not on the card")
    check(tuple(m.center.shape) == (25, 5, 25, 2), f"center {m.center.shape}")
    for t in (m.cores, m.center):
        check(bool(torch.isfinite(t).all()), "non-finite model weights")
    check(launches["k12m"] > 0, f"default fit: kernel launches {launches}")
    check(sum(plain.values()) == 0,
          f"default fit: plain-version calls on the card {plain}")
    check(acc >= ACC_FLOOR, f"test accuracy {acc} < {ACC_FLOOR}")
    sweep_s = statistics.median(info["sweep_seconds"][1:])
    print(f"[main-path] ECG200 default MPSOptions (KLD, 10 sweeps) on cuda: "
          f"test accuracy {acc:.4f}; median sweep {sweep_s:.4f} s (after 1 "
          f"warm sweep); classify {classify_s:.4f} s for {len(Xte)} series; "
          f"launches {launches}; plain calls {plain} ({card})", flush=True)

    # an MSE fit through the same entry point runs one K12 per bond; its
    # counts are read from its own run alone
    bk.reset_counts()
    mse_trained, _, _ = mt.fit_mps(
        Xtr, ytr, opts=mt.MPSOptions(verbosity=-1, log_level=-1,
                                     loss_grad="MSE", nsweeps=2),
        device="cuda")
    mse_preds = mt.classify(mse_trained, Xte)
    torch.cuda.synchronize()
    mse_launches, mse_plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
    check(bool(torch.isfinite(mse_trained.mps.center).all()),
          "MSE fit: non-finite model weights")
    check(set(np.unique(mse_preds)) <= set(np.unique(ytr)),
          "MSE-fit predictions outside the label set")
    check(mse_launches["k12"] > 0, f"MSE fit: kernel launches {mse_launches}")
    check(sum(mse_plain.values()) == 0,
          f"MSE fit: plain-version calls on the card {mse_plain}")
    print(f"[main-path] ECG200 MPSOptions(loss_grad='MSE', nsweeps=2) on "
          f"cuda: test accuracy {float(np.mean(mse_preds == yte)):.4f}; "
          f"launches {mse_launches}; plain calls {mse_plain} ({card})",
          flush=True)

    # the default fit's accuracy over other init seeds (reported, not held
    # to the floor: the floor is the default seed's)
    seed_acc = {}
    for seed in (1, 2):
        tr, inf, _ = mt.fit_mps(
            Xtr, ytr, opts=mt.MPSOptions(verbosity=-1, log_level=-1,
                                         init_rng=seed), device="cuda")
        seed_acc[seed] = (float(np.mean(mt.classify(tr, Xte) == yte)),
                          statistics.median(inf["sweep_seconds"][1:]))
    print("[seeds] ECG200 default MPSOptions on cuda, init_rng: test accuracy, "
          "median sweep s: " + "; ".join(
              f"{s}: {a:.4f}, {t:.4f}" for s, (a, t) in seed_acc.items())
          + f" ({card})", flush=True)

    # ---- 5. qr path ------------------------------------------------------
    # orth="qr" with a refresh every second sweep: refresh sweeps run
    # K1 -> QR -> K2 bond by bond, frozen sweeps K12m blocks; the counts
    # are read from this run alone
    bk.reset_counts()
    qr_trained, qr_info, _ = mt.fit_mps(
        Xtr, ytr, opts=mt.MPSOptions(verbosity=-1, log_level=-1,
                                     orth_alg="qr", subspace_refresh_every=2),
        device="cuda")
    qr_preds = mt.classify(qr_trained, Xte)
    torch.cuda.synchronize()
    qr_launches, qr_plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
    qr_acc = float(np.mean(qr_preds == yte))
    m = qr_trained.mps
    check(m.cores.is_cuda and m.center.is_cuda, "qr fit: model not on the card")
    for t in (m.cores, m.center):
        check(bool(torch.isfinite(t).all()), "qr fit: non-finite weights")
    want = {"k12": 0, "k12m": 5 * 24, "k1": 5 * 190, "k2": 5 * 190}
    check(qr_launches == want, f"qr fit: launches {qr_launches} != {want}")
    check(sum(qr_plain.values()) == 0, f"qr fit: plain calls {qr_plain}")
    check(qr_acc >= QR_ACC_FLOOR, f"qr fit: test accuracy {qr_acc} < "
          f"{QR_ACC_FLOOR}")
    secs = qr_info["sweep_seconds"]
    refresh_s = statistics.median(secs[2::2])     # after the first sweep
    frozen_s = statistics.median(secs[1::2])
    print(f"[qr-path] ECG200 MPSOptions(orth_alg='qr', "
          f"subspace_refresh_every=2) on cuda: test accuracy {qr_acc:.4f}; "
          f"median refresh sweep {refresh_s:.4f} s, frozen sweep "
          f"{frozen_s:.4f} s; launches {qr_launches}; plain calls {qr_plain} "
          f"({card})", flush=True)

    # where a qr fit's device time goes: one refresh and one frozen sweep
    # under torch.profiler (sums of each device kernel's own time)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_info, _ = mt.fit_mps(
            Xtr, ytr, opts=mt.MPSOptions(verbosity=-1, log_level=-1,
                                         orth_alg="qr", nsweeps=2,
                                         subspace_refresh_every=2),
            device="cuda")
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    dev = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA}
    busy = sum(dev.values())
    wall = 1e3 * sum(prof_info["sweep_seconds"])
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile] qr fit, one refresh + one frozen sweep on cuda: device "
          f"busy {busy:.1f} ms of {wall:.1f} ms sweep wall time; by kernel: "
          + "; ".join(f"{k[:60]} {v:.1f} ms" for k, v in top)
          + f" ({card})", flush=True)

    # ---- 6. unfused path --------------------------------------------------
    bk.reset_counts()
    uf_trained, uf_info, _ = mt.fit_mps(
        Xtr, ytr, opts=mt.MPSOptions(verbosity=-1, log_level=-1, nsweeps=2,
                                     svd_alg="gram_eigh", track_cost=True),
        device="cuda")
    uf_preds = mt.classify(uf_trained, Xte)
    torch.cuda.synchronize()
    uf_launches, uf_plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
    m = uf_trained.mps
    check(sum(uf_launches.values()) == 0, f"unfused fit: launches "
          f"{uf_launches}")
    check(sum(uf_plain.values()) == 0, f"unfused fit: plain calls {uf_plain}")
    check(m.cores.is_cuda and m.center.is_cuda,
          "unfused fit: model not on the card")
    for t in (m.cores, m.center):
        check(bool(torch.isfinite(t).all()), "unfused fit: non-finite weights")
    check(len(uf_info["bond_costs"][0]) == 190,
          f"unfused fit: {len(uf_info['bond_costs'][0])} bond costs")
    check(bool(np.isfinite(uf_info["bond_costs"][-1]).all()),
          "unfused fit: non-finite bond costs")
    print(f"[unfused-path] ECG200 MPSOptions(svd_alg='gram_eigh', nsweeps=2, "
          f"track_cost=True) on cuda: test accuracy "
          f"{float(np.mean(uf_preds == yte)):.4f}; sweeps "
          f"{[round(t, 4) for t in uf_info['sweep_seconds']]} s; launches "
          f"{uf_launches}; plain calls {uf_plain} ({card})", flush=True)

    # bounds of the timed calls: one backward refresh bond (KLD, TSGO, q 1)
    # and an 8-bond block, at the main-path shape
    work = {"k12": k12_work(**SHAPE), "k12m": k12_work(**SHAPE, Bb=8),
            "k1": k1_work(**SHAPE), "k2": k2_work(**SHAPE)}
    rows = (("K12", "k12", ":863", mse_launches["k12"]),
            ("K12m", "k12m", ":966", launches["k12m"]),
            ("K1", "k1", ":419", qr_launches["k1"]),
            ("K2", "k2", ":748", qr_launches["k2"]))
    kernels = []
    for name, key, line, n in rows:
        b_ms, b_by = bound(work[key])
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SRC,
            "replaces": "mpstime_tpu/ops/pallas_bond.py" + line,
            "launches": n, "max_abs_err": err[key], "ms": times[key][0],
            "plain_ms": times[key][1], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

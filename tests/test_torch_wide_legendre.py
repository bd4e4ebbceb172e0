"""The port at the largest trial of the paper's ECG200 tuning box, Legendre
d 15 (chi_max 40 on the card; 8-10 here, so that the CPU holds it), held
against the benchmark's plain reference (benchmark/reference/plain.py,
float64, imported by path; it imports nothing of the port): the fused
bond step (``bond_step``, K12's plain version) and a block of steps
(``bond_block_steps``, K12m's) from seeded random cores and environments
over ECG200 rows, compared as states whatever their gauge; the d 15
encoding of ECG200 rows; the tail's path at (40, 15).  The kernels
themselves are held against these plain versions on the card
(tests/test_torch_cuda.py)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import mpstime_tpu_torch as mt
from mpstime_tpu_torch.encodings.registry import get_encoding
from mpstime_tpu_torch.ops import bond_kernels as bk
from mpstime_tpu_torch.utils.preprocessing import transform_data

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "bench_plain_reference", REPO / "benchmark" / "reference" / "plain.py")
plain = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(plain)

D, N, T, C = 15, 24, 10, 2
ETA, CUTOFF = 0.01, 1e-10
#: The float32 step's distance from the float64 reference, over the
#: reference state's norm: float32 rounds each value by 2^-24 (6e-8); a
#: step's chains run over P = chi*d <= 150 and N = 24 terms, through the
#: TSGO normalisations and 14 Newton-Schulz steps, and a block carries its
#: center over 8 steps: a step reads ~5e-7, a block ~4e-6.  The bfloat16
#: control (2^-9 a value, plain.round_bf16 after every operation) reads
#: ~8e-3 a step and 5e-2 to 8e-2 a block, past ten times this, which each
#: test checks.
STEP_TOL = 1e-4
#: The float64 encoding against the reference's: both evaluate the same
#: sigmoid, min-max map and Bonnet recurrence to degree 14 in float64,
#: whose rounding (1e-16) the recurrence grows by at most a few hundred.
ENC_TOL = 1e-12


@pytest.fixture(scope="module")
def ecg200():
    d = np.load(REPO / "tests" / "data" / "ecg200.npz")
    return d["X_train"], d["y_train"], d["X_test"]


def _features(X_train):
    """phis_c [T, N, d] (float64) of the first N training rows cut to T
    sites, scaled and encoded as the reference does."""
    X = np.asarray(X_train[:N, :T], np.float64)
    Xs = plain.scale_rows(X, plain.fit_norms(X), (-1.0, 1.0), False)
    return plain.encode(Xs, "legendre_no_norm", D, "cpu").transpose(0, 1)


def _state(seed, chi, X_train, y_train):
    """Seeded random cores [T, chi, d, chi], a class-major center [C, chi, d,
    chi] and the environments of the cores over ECG200's features."""
    rng = np.random.default_rng(seed)
    f64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    cores = f64(rng.standard_normal((T, chi, D, chi)) / np.sqrt(chi * D))
    center = f64(rng.standard_normal((C, chi, D, chi)))
    phis_c = _features(X_train)
    labels = np.searchsorted(np.unique(y_train), y_train[:N])
    y1h = torch.nn.functional.one_hot(torch.as_tensor(labels), C).double()
    w = torch.full((N,), 1.0 / N, dtype=torch.float64)
    V0 = f64(plain.cold_subspace(chi * D, chi, np.float64))
    return cores, center, phis_c, y1h, w, V0


def _run_distance(p, r, forward):
    """||p - r|| / ||r|| of two runs (center, emitted cores in update
    order) after steps in one direction, whatever their gauge."""
    def run(center_c, cores):
        return plain.site_run(center_c, cores if forward else
                              torch.flip(cores, (0,)), not forward)
    rr = run(*r)
    return (plain.segment_distance(run(*p), rr)
            / plain.segment_inner(rr, rr).real ** 0.5)


def _reference_steps(cores, center, phis_c, y1h, w, V0, bonds, env, LE, RE,
                     forward, rnd=plain.exact):
    """The reference's steps of ``bonds`` in order from the given center,
    carrying its own center and advancing environment on; returns (center,
    emitted cores [n, chi, d, chi])."""
    out = []
    ls = torch.zeros(N, dtype=torch.float64)
    for j in bonds:
        A = cores[j + 1] if forward else cores[j]
        le, re = (env, RE[j + 2]) if forward else (LE[j], env)
        BT = plain.bond_tensor(rnd(A), rnd(center), rnd(le), rnd(re),
                               phis_c[j], phis_c[j + 1], y1h, w,
                               forward=forward, eta=ETA, rnd=rnd)
        center, core, _ = plain.split(BT, rnd(V0), forward=forward,
                                      cutoff=CUTOFF, q=1, rnd=rnd)
        site = j if forward else j + 1
        env, ls = plain.env_step(env, ls, core, phis_c[site], forward, rnd)
        out.append(core)
    return center, torch.stack(out)


def _bonds(forward, n):
    """The first ``n`` bonds of a half-sweep, in update order."""
    return list(range(n)) if forward else list(range(T - 2, T - 2 - n, -1))


@pytest.mark.parametrize("chi", [8, 10])
@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("block", [False, True], ids=["k12", "k12m"])
def test_fused_steps_match_the_plain_reference(ecg200, chi, forward, block):
    X_train, y_train, _ = ecg200
    cores, center, phis_c, y1h, w, V0 = _state(20 + chi + 2 * forward,
                                               chi, X_train, y_train)
    LE = plain.left_envs(cores, phis_c, T - 1)
    RE = plain.right_envs(cores, phis_c, 1)
    env = plain.boundary(N, chi, torch.float64, "cpu")
    bonds = _bonds(forward, 8 if block else 1)
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    phil = torch.stack([phis_c[j] for j in bonds])
    phir = torch.stack([phis_c[j + 1] for j in bonds])
    A = torch.stack([cores[j + 1] if forward else cores[j] for j in bonds])
    envx = torch.stack([RE[j + 2] if forward else LE[j] for j in bonds])
    V0b = torch.stack([V0] * len(bonds))
    ls0 = torch.zeros(N, dtype=torch.float64)
    bk.reset_counts()
    if block:
        got = bk.bond_block_steps(
            *(f32(t) for t in (A, center, envx, env, ls0, phil, phir, y1h, w,
                               V0b)), ETA, CUTOFF, forward=forward)
        p_center, p_cores = got[0], got[1]
    else:
        le, re = (env, envx[0]) if forward else (envx[0], env)
        got = bk.bond_step(
            *(f32(t) for t in (A[0], center, le, re, ls0, phil[0], phir[0],
                               y1h, w, V0)), ETA, CUTOFF, forward=forward,
            orth="ns")
        p_center, p_cores = got[0], got[1][None]
    assert bk.PLAIN_CALLS["k12m" if block else "k12"] == 1
    ref = _reference_steps(cores, center, phis_c, y1h, w, V0, bonds, env, LE,
                           RE, forward)
    mine = (p_center.double(), p_cores.double())
    assert _run_distance(mine, ref, forward) < STEP_TOL
    # the control: the reference in bfloat16 from the same state fails it
    low = _reference_steps(cores, center, phis_c, y1h, w, V0, bonds, env,
                           LE, RE, forward, rnd=plain.round_bf16)
    assert _run_distance(low, ref, forward) > 10 * STEP_TOL


def test_d15_encoding_of_ecg200_matches_the_reference(ecg200):
    X_train, _, X_test = ecg200
    opts = mt.MPSOptions(d=D, chi_max=40, verbosity=-1, log_level=-1)
    tr_s, te_s, _, _ = transform_data(X_train, X_test, opts)
    enc = get_encoding(opts.encoding).encode_batch
    norms = plain.fit_norms(X_train)
    for X, mine, rescue in ((X_train, tr_s, False), (X_test, te_s, True)):
        want = plain.encode(plain.scale_rows(X, norms, (-1.0, 1.0), rescue),
                            "legendre_no_norm", D, "cpu")
        got = enc(torch.from_numpy(np.asarray(mine, np.float64)), D, None)
        assert got.shape == want.shape == (len(X), X.shape[1], D)
        assert got.dtype == torch.float64
        assert float((got - want).abs().max()) < ENC_TOL * float(
            want.abs().max())


def test_the_box_corner_takes_the_team_tail():
    # X, X' [600, 40] and their transposes, Gm, Mq^T in padded float32 rows
    assert bk.polar_smem_bytes(40, 15) == 418560 > bk.POLAR_SMEM
    assert bk.polar_path(40, 15) == "team"
    assert bk.polar_path(25, 5) == "block"

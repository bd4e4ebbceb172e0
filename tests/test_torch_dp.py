"""Data-parallel training in the port (mpstime_tpu_torch/parallel): one
process drives a mesh of devices, here ``Mesh(["cpu"] * n)``, which stands
in for the JAX package's 8 forced host devices (tests/conftest.py:20-21).
Held against the JAX package's ``shard_map`` route (tests/test_parallel.py)
and against the port's single-device sweep:

  * one dp bond step on 1 and 4 shards (K1a -> one sum -> K1b -> QR ->
    K2-split -> K2-env, their plain versions here);
  * whole sharded sweeps, float64 gram_eigh (the unfused route with its
    reduction) and the float32 kernel route;
  * ``fit_mps(mesh=)`` end to end, with and without ``pad_samples_to``;
  * the contract: one ``all_reduce`` per bond update;
  * complex fits: the kernel route runs bond_step_c_dp on a mesh (its
    pieces against JAX in tests/test_torch_complex_dp.py), the ritz route
    runs unfused.

Tolerances: on one shard the dp route does the single-device route's
arithmetic (bit for bit in the port, 1e-7 in the JAX package's own test);
more shards sum the gradient in another order, which the power step's QR
amplifies to ~1e-4 per bond (tests/test_parallel.py:199-212); across
packages a bond agrees to the per-bond bound rtol 1e-4 / atol 3e-5 of
tests/test_pallas_bond.py:73-82; whole f32 sweeps flip ranks at the
truncation edge and are held at tests/test_parallel.py:185-196's
rtol 1e-2 / atol 2e-3 after zeroing sub-1e-6 entries."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import mpstime_tpu_torch as mt
from mpstime_tpu.models.mps import random_mps as jax_random_mps
from mpstime_tpu.ops import pallas_bond
from mpstime_tpu.ops.decomp import warm_sketch_init as jax_sketch
from mpstime_tpu.parallel import make_mesh as jax_make_mesh
from mpstime_tpu.parallel import replicate as jax_replicate
from mpstime_tpu.parallel import shard_train_arrays as jax_shard
from mpstime_tpu.parallel import sharded_full_sweeps as jax_sharded_sweeps
from mpstime_tpu_torch.models.mps import contract_batch_scaled
from mpstime_tpu_torch.models.mps import random_mps
from mpstime_tpu_torch.ops import bond_kernels as bk
from mpstime_tpu_torch.parallel import (Mesh, make_mesh, replicate,
                                        shard_train_arrays,
                                        sharded_full_sweep,
                                        sharded_full_sweep_warm,
                                        sharded_full_sweeps)
from mpstime_tpu_torch.training import sweep as tsweep

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 3e-5
SWEEP_KW = dict(loss="KLD", bbopt="TSGO", update_iters=1,
                rescale=(False, True))


@pytest.fixture(scope="module")
def tiny():
    """tests/test_parallel.py:13-24's problem: T 8, chi 6, d 3, C 2, N 32;
    the port's random_mps makes the JAX package's cores bit for bit."""
    T, chi, d, C, N = 8, 6, 3, 2, 32
    mps = random_mps(0, T, d, C, 4, chi, np.float64, device="cpu")
    rng = np.random.default_rng(0)
    phis = rng.uniform(-0.9, 0.9, (T, N, d))
    y_idx = np.sort(rng.integers(0, C, N))
    return dict(cores=mps.cores.numpy(), center=mps.center.numpy(),
                phis=phis, y1h=np.eye(C)[y_idx], w=np.full(N, 1.0 / N))


def _cast(x, dtype):
    return {k: v.astype(dtype) if v.dtype.kind == "f" else v
            for k, v in x.items()}


def _torch(x, *keys):
    return tuple(torch.from_numpy(np.array(x[k])) for k in keys)


def _squash(a):
    """Zero the sub-threshold entries a truncation-edge rank flip leaves
    (tests/test_parallel.py:251-257)."""
    a = np.array(a)
    a[np.abs(a) < 1e-6] = 0.0
    return a


@pytest.fixture
def interpret():
    pallas_bond.set_interpret(True)
    jax.clear_caches()
    yield
    pallas_bond.set_interpret(False)
    jax.clear_caches()


# ---------------------------------------------------------------- the mesh

def test_mesh_shards_replicates_and_reduces_in_order():
    mesh = Mesh(["cpu"] * 4)
    assert len(mesh) == 4 and mesh.replicas == (torch.device("cpu"),)
    phis = torch.arange(2 * 8 * 3, dtype=torch.float64).reshape(2, 8, 3)
    y, w = torch.eye(2)[torch.arange(8) % 2], torch.full((8,), 0.125)
    sp, sy, sw = shard_train_arrays(mesh, phis, y, w)
    assert [tuple(t.shape) for t in sp] == [(2, 2, 3)] * 4
    torch.testing.assert_close(torch.cat(sp, dim=1), phis, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat(sy), y, rtol=0, atol=0)
    assert all(t.is_contiguous() for t in sp)
    cores = replicate(mesh, phis)
    assert len(cores) == 1 and cores[0] is phis
    assert mesh.to_shards(cores) == [phis] * 4
    # shard order: 1e16 + 1 - 1e16 + 1 = 1 in float64, not 2
    parts = [torch.tensor(v, dtype=torch.float64)
             for v in (1e16, 1.0, -1e16, 1.0)]
    assert mesh.all_reduce(parts)[0].item() == 1.0
    loss, g = mesh.all_reduce([(p, 2 * p) for p in parts])[0]
    assert (loss.item(), g.item()) == (1.0, 2.0)
    assert mesh.reductions == 2
    with pytest.raises(ValueError, match="equal shards"):
        shard_train_arrays(Mesh(["cpu"] * 3), phis, y, w)
    with pytest.raises(ValueError, match="cpu or cuda"):
        Mesh(["meta"])


def test_cuda_meshes_raise_without_a_card(monkeypatch, ecg200):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.fit_mps(ecg200[0][:8], ecg200[1][:8], mesh=Mesh(["cuda"] * 2))


# ------------------------------------------------------------ one dp bond

def _dp_bond_operands(tiny):
    """One mid-chain bond (tests/test_parallel.py:231-248), float32, with
    random cores of full rank: the tiny problem's own cores start from
    chi_init 4 < chi 6, and the QR of a rank-deficient power iterate fills
    its missing columns from rounding, differently in MKL and the JAX
    package's LAPACK (ROADMAP.md queue 3)."""
    f32 = np.float32
    rng = np.random.default_rng(7)
    N, chi = tiny["phis"].shape[1], tiny["cores"].shape[1]
    d, C = tiny["phis"].shape[2], tiny["center"].shape[3]

    def unit_rows():
        a = rng.standard_normal((N, chi)).astype(f32)
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    le, re = unit_rows(), unit_rows()
    return ((0.5 * rng.standard_normal((chi, d, chi))).astype(f32),
            (0.5 * rng.standard_normal((C, chi, d, chi))).astype(f32), le, re,
            np.zeros(N, f32), tiny["phis"][3].astype(f32),
            tiny["phis"][4].astype(f32), tiny["y1h"].astype(f32),
            tiny["w"].astype(f32), np.asarray(jax_sketch(chi * d, chi, f32)))


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("n_dev", [1, 4])
def test_single_bond_dp_matches_jax_and_single_device(interpret, tiny,
                                                      forward, n_dev):
    ops = _dp_bond_operands(tiny)
    eta, cutoff = 0.05, 1e-10

    def dp_body(*a):
        return pallas_bond.bond_step(*a, jnp.float32(eta),
                                     jnp.float32(cutoff), forward=forward,
                                     axis_name="dp")

    b, r = P("dp"), P()
    fn = jax.jit(jax.shard_map(
        dp_body, mesh=jax_make_mesh(n_dev),
        in_specs=(r, r, b, b, b, b, b, b, b, r),
        out_specs=(r, r, b, b, r), check_vma=False))
    ref = [np.asarray(o) for o in fn(*ops)]

    t = [torch.from_numpy(np.array(a)) for a in ops]
    mesh = Mesh(["cpu"] * n_dev)

    def shards(x):
        return list(x.chunk(n_dev))

    bk.reset_counts()
    center, core, env, ls, Q = bk.bond_step_dp(
        mesh, [t[0]], [t[1]], *(shards(x) for x in t[2:9]), [t[9]], eta,
        cutoff, forward=forward)
    got = (center[0], core[0], torch.cat(env), torch.cat(ls), Q[0])
    assert mesh.reductions == 1
    assert {k: v for k, v in bk.PLAIN_CALLS.items() if v} == {
        "k1a": n_dev, "k1b": 1, "k2_split": 1, "k2_env": n_dev}
    for g, want in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), want, rtol=RTOL, atol=ATOL)
    single = bk.bond_step(*t, eta, cutoff, forward=forward)
    for g, want in zip(got, single):
        if n_dev == 1:      # K1a -> K1b is K1, K2-split -> K2-env is K2
            torch.testing.assert_close(g, want, rtol=0, atol=0)
        else:
            torch.testing.assert_close(g, want, rtol=0, atol=1e-4)


# --------------------------------------------------------- sharded sweeps

def _sweep_inputs(tiny, dtype, n_dev):
    x = _cast(tiny, dtype)
    cores, center, phis, y1h, w = _torch(x, "cores", "center", "phis", "y1h",
                                         "w")
    mesh = Mesh(["cpu"] * n_dev)
    placed = replicate(mesh, cores, center) + shard_train_arrays(
        mesh, phis, y1h, w)
    return mesh, placed, (cores, center, phis, y1h, w), x


def _jax_sharded(x, n_dev, **kw):
    mesh = jax_make_mesh(n_dev)
    sp, sy, sw = jax_shard(mesh, jnp.asarray(x["phis"]),
                           jnp.asarray(x["y1h"]), jnp.asarray(x["w"]))
    rc, rce = jax_replicate(mesh, jnp.asarray(x["cores"]),
                            jnp.asarray(x["center"]))
    dt = x["w"].dtype
    out = jax_sharded_sweeps(mesh, rc, rce, sp, sy, sw, jnp.asarray(0.05, dt),
                             jnp.asarray(1e-10, dt), **kw)
    return [np.asarray(o) for o in out]


def _outputs(cores, center, phis):
    """The contracted outputs and log-scales of the trained MPS on the
    training features: a gauge invariant, free of eigenvector signs."""
    m = mt.MPS(torch.as_tensor(np.array(cores)),
               torch.as_tensor(np.array(center)), cores.shape[0] - 1)
    y, ls = contract_batch_scaled(m, torch.as_tensor(phis).conj()
                                  .transpose(0, 1))
    return y.numpy(), ls.numpy()


def test_sharded_sweeps_match_jax_and_single_device_f64(tiny):
    """Two float64 gram_eigh sweeps (the unfused route, one reduction of the
    loss and gradient per bond) on 8 shards: within 1e-8 of the port's
    single-device sweeps, as tests/test_parallel.py:51-69 holds the JAX
    package's, and of the JAX package's sharded sweeps on the gauge
    invariant outputs (MKL and the JAX package's LAPACK pick eigenvector
    signs differently, ROADMAP.md queue 3)."""
    kw = dict(nsweeps=2, svd_alg="gram_eigh", **SWEEP_KW)
    mesh, placed, plain, x = _sweep_inputs(tiny, np.float64, 8)
    c2, ce2 = sharded_full_sweeps(mesh, *placed, 0.05, 1e-10, **kw)
    assert mesh.reductions == 2 * 2 * 7
    c1, ce1 = tsweep.full_sweeps(*plain, 0.05, 1e-10, **kw)
    np.testing.assert_allclose(ce2.numpy(), ce1.numpy(), atol=1e-8)
    np.testing.assert_allclose(c2.numpy(), c1.numpy(), atol=1e-8)
    jc, jce = _jax_sharded(x, 8, **kw)
    for got, want in zip(_outputs(c2, ce2, x["phis"]),
                         _outputs(jc, jce, x["phis"])):
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_sharded_sweeps_kernel_route_matches_jax_and_single_device_f32(
        interpret, tiny):
    """The card's production configuration, float32 randomized_warm with the
    Newton-Schulz refresh (orth="ns"; the QR refresh fills rank-deficient
    bonds' columns from rounding differently in MKL and the JAX package's
    LAPACK, ROADMAP.md queue 3), two sweeps on 8 shards: the dp kernels'
    plain versions against the JAX package's dp kernels (interpret) and
    against the port's single-device K12m blocks, at
    tests/test_parallel.py:185-196's bounds."""
    kw = dict(nsweeps=2, svd_alg="randomized_warm", orth="ns", **SWEEP_KW)
    mesh, placed, plain, x = _sweep_inputs(tiny, np.float32, 8)
    bk.reset_counts()
    c2, ce2 = sharded_full_sweeps(mesh, *placed, 0.05, 1e-10, **kw)
    assert {k: v for k, v in bk.PLAIN_CALLS.items() if v} == {
        "k1a": 8 * 28, "k1b": 28, "k2_split": 28, "k2_env": 8 * 28}
    assert mesh.reductions == 28
    assert np.isfinite(ce2.numpy()).all()
    c1, ce1 = tsweep.full_sweeps(*plain, 0.05, 1e-10, **kw)
    jc, jce = _jax_sharded(x, 8, **kw)
    for want_c, want_ce in ((c1.numpy(), ce1.numpy()), (jc, jce)):
        np.testing.assert_allclose(_squash(ce2), _squash(want_ce), rtol=1e-2,
                                   atol=2e-3)
        np.testing.assert_allclose(_squash(c2), _squash(want_c), rtol=1e-2,
                                   atol=2e-3)


def test_one_sweep_functions_are_full_sweeps_of_one(tiny):
    mesh, placed, (cores, center, *_), _ = _sweep_inputs(tiny, np.float32, 4)
    warm = dict(svd_alg="randomized_warm", orth="ns", **SWEEP_KW)
    c1, ce1 = sharded_full_sweeps(mesh, *placed, 0.05, 1e-10, nsweeps=1,
                                  **warm)
    subspaces = tsweep.init_subspaces(8, 6, 3, np.float32, "cpu")
    *_, costs = sharded_full_sweep_warm(
        mesh, cores, center, subspaces, *placed[2:], 0.05, 1e-10,
        track_cost=True, **warm)
    assert costs.shape == (14,) and torch.isfinite(costs).all()
    c2, ce2, (VB, UF) = sharded_full_sweep_warm(
        mesh, cores, center, subspaces, *placed[2:], 0.05, 1e-10, **warm)
    torch.testing.assert_close(c2, c1, rtol=0, atol=0)
    torch.testing.assert_close(ce2, ce1, rtol=0, atol=0)
    assert VB.shape == UF.shape == (7, 18, 6)
    c3, ce3 = sharded_full_sweep(mesh, *placed, 0.05, 1e-10,
                                 svd_alg="gram_eigh", **SWEEP_KW)
    c4, ce4 = sharded_full_sweeps(mesh, *placed, 0.05, 1e-10, nsweeps=1,
                                  svd_alg="gram_eigh", **SWEEP_KW)
    torch.testing.assert_close(ce3, ce4, rtol=0, atol=0)


@pytest.mark.parametrize("route,per_bond", [
    (dict(svd_alg="gram_eigh"), 1),
    (dict(svd_alg="randomized_warm", orth="qr"), 1),
    (dict(svd_alg="gram_eigh", bbopt="CGD", update_iters=2), 2)],
    ids=["unfused", "dp_kernels", "unfused_cgd_2_iters"])
def test_one_reduction_per_bond_update(tiny, route, per_bond):
    """The DP contract (tests/test_parallel.py:432-463): one all-reduce of
    the gradient (with the loss) per bond update, so 2(T-1) per sweep, and
    one per iteration where a bond iterates."""
    mesh, placed, _, _ = _sweep_inputs(tiny, np.float32, 8)
    calls = []
    reduce = mesh.all_reduce
    mesh.all_reduce = lambda parts: calls.append(len(parts)) or reduce(parts)
    sharded_full_sweeps(mesh, *placed, 0.05, 1e-10, nsweeps=2,
                        **{**SWEEP_KW, **route})
    assert calls == [8] * (2 * 2 * 7 * per_bond)


# --------------------------------------------------------------- fit_mps

def test_fit_mps_with_mesh():
    """tests/test_parallel.py:466-485: 30 series padded to 32 on 8 shards,
    float64, within 1e-8 of the single-device fit."""
    rng = np.random.default_rng(0)
    T, n = 20, 30
    t = np.linspace(0, 2 * np.pi, T)
    X = np.concatenate([np.sin(t[None] + rng.uniform(0, 6, (n // 2, 1))),
                        np.sin(5 * t[None] + rng.uniform(0, 6, (n // 2, 1)))])
    y = np.repeat([0, 1], n // 2)
    opts = mt.MPSOptions(nsweeps=3, chi_max=8, d=3, verbosity=-1,
                         dtype="float64", log_level=0)
    trained_m, info, _ = mt.fit_mps(X, y, opts=opts, mesh=Mesh(["cpu"] * 8))
    trained_s, _, _ = mt.fit_mps(X, y, opts=opts, device="cpu")
    assert trained_m.mps.center.device.type == "cpu"
    assert len(info["sweep_seconds"]) == 3
    np.testing.assert_allclose(trained_m.mps.center.numpy(),
                               trained_s.mps.center.numpy(), atol=1e-8)
    assert np.mean(mt.classify(trained_m, X) == y) >= 0.9


def test_fit_mps_mesh_production_config(ecg200):
    """tests/test_parallel.py:384-403: ECG200 X[:40], float32
    randomized_warm (one dp bond step per bond: K1a on each of 8 shards,
    K1b, QR, K2-split, K2-env on each shard), trains and classifies."""
    Xtr, ytr = ecg200[0][:40], ecg200[1][:40]
    opts = mt.MPSOptions(nsweeps=3, chi_max=12, d=3, verbosity=-1,
                         log_level=-1, dtype="float32",
                         svd_alg="randomized_warm")
    bk.reset_counts()
    trained, _, _ = mt.fit_mps(Xtr, ytr, opts=opts, mesh=Mesh(["cpu"] * 8))
    bonds = 3 * 2 * 95
    assert {k: v for k, v in bk.PLAIN_CALLS.items() if v} == {
        "k1a": 8 * bonds, "k1b": bonds, "k2_split": bonds,
        "k2_env": 8 * bonds}
    assert np.mean(mt.classify(trained, Xtr) == ytr) >= 0.9


def test_fit_mps_mesh_with_pad_samples_to(ecg200, monkeypatch):
    """tests/test_parallel.py:406-421: the mesh's pad is reckoned from the
    length pad_samples_to gave (50 -> 54 -> 56 on 8 shards, not 60)."""
    import mpstime_tpu_torch.parallel as par
    Xtr, ytr = ecg200[0][:50], ecg200[1][:50]
    opts = mt.MPSOptions(nsweeps=2, chi_max=10, d=3, verbosity=-1,
                         log_level=-1, dtype="float32", svd_alg="gram_eigh")
    rows = []
    shard = par.shard_train_arrays
    monkeypatch.setattr(par, "shard_train_arrays",
                        lambda m, p, y, w: rows.append((p.shape[1], y,
                                                        w.clone()))
                        or shard(m, p, y, w))
    trained, _, _ = mt.fit_mps(Xtr, ytr, opts=opts, mesh=Mesh(["cpu"] * 8),
                               pad_samples_to=54)
    (n, y1h, w), = rows
    assert n == 56
    # the pad rows copy sample 0 at weight 0
    torch.testing.assert_close(y1h[50:], y1h[:1].expand(6, -1), rtol=0, atol=0)
    assert (w[50:] == 0).all() and (w[:50] > 0).all()
    assert np.mean(mt.classify(trained, Xtr) == ytr) >= 0.8


# ----------------------------------------------------------- complex fits

def _complex(tiny, dtype):
    rng = np.random.default_rng(3)
    x = dict(tiny)
    x["cores"] = tiny["cores"].astype(dtype)
    x["center"] = tiny["center"].astype(dtype)
    x["phis"] = (tiny["phis"] * np.exp(1j * rng.uniform(
        -1, 1, tiny["phis"].shape))).astype(dtype)
    return x


def test_complex_kernel_route_under_a_mesh_runs(tiny):
    """A complex64 KLD + TSGO randomized_warm sweep on a mesh runs one
    bond_step_c_dp per bond (K1c-grad on each shard, one sum, K1c-update,
    K2c-split, K2c-env on each shard); on one shard it is the
    single-device sweep's arithmetic (K12mc blocks of chained K12c steps)
    bit for bit, on two it sums the gradients in another order."""
    x = _complex(tiny, np.complex64)
    x["y1h"], x["w"] = x["y1h"].astype(np.float32), x["w"].astype(np.float32)
    kw = dict(nsweeps=1, svd_alg="randomized_warm", orth="ns", **SWEEP_KW)
    runs = {}
    for n in (1, 2):
        mesh, placed, plain, _ = _sweep_inputs(x, np.float32, n)
        bk.reset_counts()
        runs[n] = sharded_full_sweeps(mesh, *placed, 0.05, 1e-10, **kw)
        assert {k: v for k, v in bk.PLAIN_CALLS.items() if v} == {
            "k1c_grad": 14 * n, "k1c_update": 14, "k2c_split": 14,
            "k2c_env": 14 * n}
        assert mesh.reductions == 14
    c1, ce1 = tsweep.full_sweeps(*plain, 0.05, 1e-10, **kw)
    assert c1.dtype == torch.complex64
    torch.testing.assert_close(runs[1][0], c1, rtol=0, atol=0)
    torch.testing.assert_close(runs[1][1], ce1, rtol=0, atol=0)
    assert all(torch.isfinite(t).all() for t in runs[2])


def test_complex_ritz_under_a_mesh_runs_unfused(tiny):
    """The ritz route under a mesh takes the unfused route (no K12cr,
    sweep.py:327), with one reduction per bond.  Complex128 with the
    eigh-free schedule (Jacobi rotations from the first sweep) and the
    Newton-Schulz refresh: within 1e-8 of the port's single-device fit and
    of the JAX package's sharded sweeps, whose eigh-free ritz sweeps the
    port reproduces to ~1e-14 (tests/test_torch_ritz.py).  Not the QR
    refresh: the edge bonds' power iterates are rank-deficient, so the QR
    fills their missing columns from rounding, which the shards' order of
    summation moves; the second sweep then parts by ~0.1 even within one
    package (measured here, 4 shards)."""
    x = _complex(tiny, np.complex128)
    kw = dict(nsweeps=2, svd_alg="randomized_warm_ritz", orth="ns",
              ritz_exact_sweeps=0, ritz_track_rot="jacobi", **SWEEP_KW)
    mesh, placed, plain, _ = _sweep_inputs(x, np.float64, 4)
    bk.reset_counts()
    c2, ce2 = sharded_full_sweeps(mesh, *placed, 0.05, 1e-10, **kw)
    assert sum(bk.PLAIN_CALLS.values()) == 0 and mesh.reductions == 28
    c1, ce1 = tsweep.full_sweeps(*plain, 0.05, 1e-10, **kw)
    np.testing.assert_allclose(ce2.numpy(), ce1.numpy(), atol=1e-8)
    np.testing.assert_allclose(c2.numpy(), c1.numpy(), atol=1e-8)
    jc, jce = _jax_sharded(x, 4, **kw)
    np.testing.assert_allclose(ce2.numpy(), jce, atol=1e-8)
    np.testing.assert_allclose(c2.numpy(), jc, atol=1e-8)
    # complex64 would run K12cr on one device; under a mesh it runs unfused
    x64 = _complex(tiny, np.complex64)
    x64["y1h"], x64["w"] = (x64["y1h"].astype(np.float32),
                            x64["w"].astype(np.float32))
    mesh, placed, _, _ = _sweep_inputs(x64, np.float32, 2)
    c3, _ = sharded_full_sweeps(mesh, *placed, 0.05, 1e-10,
                                **{**kw, "nsweeps": 1})
    assert sum(bk.PLAIN_CALLS.values()) == 0 and mesh.reductions == 14
    assert c3.dtype == torch.complex64 and torch.isfinite(c3).all()

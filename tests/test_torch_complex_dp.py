"""The complex data-parallel and batch-tiled bond steps of the port: the
plain versions of K1c-grad, K1c-update, K2c-split and K2c-env held against
the JAX package's complex Pallas kernels (``_k1c_grad_call``,
``_k1c_update_call``, ``_k2c_split_call``, ``_k2c_env_call``, in interpret
mode as tests/test_pallas_bond_c.py runs them), one dp bond on 1 and 4
shards against the JAX ``bond_step_c(axis_name="dp")`` under ``shard_map``
(tests/test_parallel.py:270-343), the streamed bond step against the JAX
package's (tests/test_pallas_bond_c.py:583-603), sharded complex sweeps
against the JAX ``sharded_full_sweeps``, and ``fit_mps(mesh=)`` on a
complex encoding end to end.  The CUDA kernels are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

The mesh is ``Mesh(["cpu"] * n)``; the JAX side's is ``make_mesh(n)`` over
the 8 forced host devices (tests/conftest.py:20-21).  Tolerances: a piece
at the per-bond bound rtol 1e-4 / atol 3e-5 (tests/test_pallas_bond.py:
73-82), with equal kept ranks; a dp bond 1e-5 on one shard and 1e-4 on
four, where the shards' sums go through the power step's QR
(tests/test_parallel.py:262); the streamed step rtol 2e-4 / atol 1e-5
(tests/test_pallas_bond_c.py:602); whole float32 sweeps at
tests/test_parallel.py:388-389's rtol 1e-2 / atol 2e-3 after zeroing
sub-1e-6 entries."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import mpstime_tpu_torch as mt
from mpstime_tpu.ops import pallas_bond, pallas_bond_c
from mpstime_tpu.ops.decomp import warm_sketch_init as jax_sketch
from mpstime_tpu.parallel import make_mesh as jax_make_mesh
from mpstime_tpu.parallel import replicate as jax_replicate
from mpstime_tpu.parallel import shard_train_arrays as jax_shard
from mpstime_tpu.parallel import sharded_full_sweeps as jax_sharded_sweeps
from mpstime_tpu_torch.models.mps import random_mps
from mpstime_tpu_torch.ops import bond_kernels as bk
from mpstime_tpu_torch.ops import bond_kernels_c as bkc
from mpstime_tpu_torch.parallel import (Mesh, replicate, shard_train_arrays,
                                        sharded_full_sweeps)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 3e-5
STREAM_RTOL, STREAM_ATOL = 2e-4, 1e-5
CHI, D, C, N = 6, 3, 2, 13


@pytest.fixture(scope="module")
def interpret():
    pallas_bond.set_interpret(True)
    jax.clear_caches()
    yield
    pallas_bond.set_interpret(False)
    jax.clear_caches()


def _bond(seed, n=N):
    """One complex64 bond's operands (numpy): unit environment rows and
    unit-modulus conjugated features, as a sweep hands them over."""
    rng = np.random.default_rng(seed)

    def c(*shape, scale=1.0):
        return (scale * (rng.standard_normal(shape)
                         + 1j * rng.standard_normal(shape))
                ).astype(np.complex64)

    def unit_rows():
        a = c(n, CHI)
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    def phi():
        th = rng.uniform(-np.pi, np.pi, (n, D))
        return (np.exp(-1j * th) / np.sqrt(D)).astype(np.complex64)

    Q = np.linalg.qr(c(CHI * D, CHI))[0].astype(np.complex64)
    return dict(
        A=c(CHI, D, CHI, scale=0.5), center=c(C, CHI, D, CHI, scale=0.5),
        le=unit_rows(), re=unit_rows(),
        ls=(0.3 * rng.standard_normal(n)).astype(np.float32),
        phil=phi(), phir=phi(),
        y1h=np.eye(C, dtype=np.float32)[rng.integers(0, C, n)],
        w=np.full(n, 1.0 / n, np.float32),
        V0=np.asarray(jax_sketch(CHI * D, CHI, np.complex64)),
        G=c(C, CHI * D, D, CHI, scale=1e-2), Q=Q,
        BT=c(C, CHI * D, D, CHI))


NAMES = ("A", "center", "le", "re", "ls", "phil", "phir", "y1h", "w", "V0")


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(a):
    a = np.asarray(a)
    if not np.iscomplexobj(a):
        return jnp.asarray(a)
    return (jnp.asarray(a.real.astype(np.float32)),
            jnp.asarray(a.imag.astype(np.float32)))


def _comb(p):
    if isinstance(p, tuple):
        return np.asarray(p[0]) + 1j * np.asarray(p[1])
    return np.asarray(p)


def _close(got, ref, rtol=RTOL, atol=ATOL):
    for g, r in zip(got, ref):
        r = _comb(r)
        np.testing.assert_allclose(g.numpy(), r.reshape(g.shape), rtol=rtol,
                                   atol=atol)


def _left_right(x, forward):
    """The JAX calls' (left, right) pairs: (center, core) forward, (core,
    center) backward."""
    A, center = _pair(x["A"]), _pair(x["center"])
    return (center, A) if forward else (A, center)


def _kept(core, forward):
    """The kept directions of an emitted core."""
    core = np.asarray(core)
    axes = (0, 1) if forward else (1, 2)
    return (core != 0).any(axis=axes)


# ------------------------------------------------------ the four pieces

@pytest.mark.parametrize("forward", [False, True])
def test_k1c_grad_plain_matches_pallas(interpret, forward):
    x = _bond(5)
    ref = pallas_bond_c._k1c_grad_call(
        jnp.asarray(x["y1h"]), jnp.asarray(x["w"])[:, None],
        *_left_right(x, forward),
        *(_pair(x[k]) for k in ("le", "re", "phil", "phir")), C=C, chi=CHI,
        d=D, forward=forward, est=0)
    bk.reset_counts()
    got = bkc.k1c_grad_plain(*(_t(x[k]) for k in NAMES[:4]),
                             *(_t(x[k]) for k in ("phil", "phir", "y1h", "w",
                                                  "ls")), forward=forward)
    assert got.dtype == torch.complex64
    assert got.shape == (C, CHI * D, D, CHI)
    _close([got], [ref])


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("emit_y,q,orth", [
    (True, 3, "ns"), (True, 1, "qr"), (False, 1, "ns")])
def test_k1c_update_plain_matches_pallas(interpret, forward, emit_y, q,
                                         orth):
    x = _bond(6)
    ref = pallas_bond_c._k1c_update_call(
        jnp.full((1, 1), 0.05, jnp.float32), *_left_right(x, forward),
        _pair(x["G"]), _pair(x["V0"]), C=C, chi=CHI, d=D, forward=forward,
        emit_y=emit_y, q=q, orth=orth, est=0)
    got = bkc.k1c_update_plain(_t(x["A"]), _t(x["center"]), _t(x["G"]),
                               _t(x["V0"]), 0.05, forward=forward,
                               emit_y=emit_y, power_iters=q, orth=orth)
    _close(got, ((ref[0], ref[1]), (ref[2], ref[3])))
    if not emit_y:     # a frozen bond passes V0 through
        torch.testing.assert_close(got[1], _t(x["V0"]), rtol=0, atol=0)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("mr", [None, 4])
def test_k2c_split_plain_matches_pallas(interpret, forward, mr):
    x = _bond(7)
    cut = jnp.asarray([[0.05, CHI if mr is None else mr]], jnp.float32)
    ref = pallas_bond_c._k2c_split_call(cut, _pair(x["BT"]), _pair(x["Q"]),
                                        C=C, chi=CHI, d=D, forward=forward,
                                        est=0)
    got = bkc.k2c_split_plain(_t(x["BT"]), _t(x["Q"]), 0.05, forward=forward,
                              max_rank=mr)
    _close(got, ((ref[0], ref[1]), (ref[2], ref[3]), (ref[4], ref[5])))
    np.testing.assert_array_equal(_kept(got[1], forward),
                                  _kept(_comb((ref[2], ref[3])), forward))
    # the isometry is Q with the dropped directions zeroed
    kept = (got[2] != 0).any(dim=0)
    assert int(kept.sum()) == (CHI if mr is None else mr)
    torch.testing.assert_close(got[2], _t(x["Q"]) * kept, rtol=0, atol=0)


@pytest.mark.parametrize("forward", [False, True])
def test_k2c_env_plain_matches_pallas(interpret, forward):
    x = _bond(8)
    Qm = (x["Q"] * (np.arange(CHI) < 4)).astype(np.complex64)
    env, phi = (x["le"], x["phil"]) if forward else (x["re"], x["phir"])
    ref = pallas_bond_c._k2c_env_call(_pair(Qm), _pair(env),
                                      jnp.asarray(x["ls"])[:, None],
                                      _pair(phi), chi=CHI, d=D,
                                      forward=forward, est=0)
    got = bkc.k2c_env_plain(_t(Qm), _t(env), _t(x["ls"]), _t(phi),
                            forward=forward)
    _close(got, ((ref[0], ref[1]), ref[2]))


def test_pieces_refuse_what_the_complex_kernels_do_not_cover():
    a = {k: _t(v) for k, v in _bond(9).items()}
    args = tuple(a[k] for k in ("A", "center", "le", "re", "phil", "phir",
                                "y1h", "w", "ls"))
    with pytest.raises(ValueError, match="KLD \\+ TSGO"):
        bkc.k1c_grad_cuda(*args, forward=False, loss="MSE")
    with pytest.raises(ValueError, match="KLD \\+ TSGO"):
        bkc.k1c_update_cuda(a["A"], a["center"], a["G"], a["V0"], 0.05,
                            forward=False, bbopt="GD")
    # the complex chain refuses them before any piece runs
    for kw in (dict(loss="MSE"), dict(bbopt="GD")):
        bk.reset_counts()
        with pytest.raises(ValueError, match="KLD \\+ TSGO"):
            bk.bond_step_dp(Mesh(["cpu"]), [a["A"]], [a["center"]],
                            [a["le"]], [a["re"]], [a["ls"]], [a["phil"]],
                            [a["phir"]], [a["y1h"]], [a["w"]], [a["V0"]],
                            0.05, 1e-10, forward=False, **kw)
        assert sum(bk.PLAIN_CALLS.values()) == 0
    with pytest.raises(ValueError, match="bond_step_c_dp"):
        bkc.bond_step_c(*(a[k] for k in NAMES), 0.05, 1e-10, forward=False,
                        axis_name="dp")


# ---------------------------------------------------------- one dp bond

def _jax_dp_bond(ops, forward, n_dev, **kw):
    """The JAX complex bond step with axis_name under shard_map."""
    eta, cutoff = jnp.float32(0.05), jnp.float32(1e-10)

    def dp_body(*a):
        return pallas_bond_c.bond_step_c(*a, eta, cutoff, forward=forward,
                                         axis_name="dp", **kw)

    b, r = P("dp"), P()
    bp, rp = (b, b), (r, r)
    fn = jax.jit(jax.shard_map(
        dp_body, mesh=jax_make_mesh(n_dev),
        in_specs=(rp, rp, bp, bp, b, bp, bp, b, b, rp),
        out_specs=(rp, rp, bp, b, rp), check_vma=False))
    return [_comb(o) for o in fn(*(_pair(o) for o in ops))]


def _dp_bond(ops, forward, n_dev, **kw):
    """The port's bond_step_c_dp on Mesh(["cpu"] * n_dev), its per-shard
    outputs joined."""
    t = [_t(o) for o in ops]
    mesh = Mesh(["cpu"] * n_dev)

    def shards(v):
        return list(v.chunk(n_dev))

    center, core, env, ls, Q = bkc.bond_step_c_dp(
        mesh, [t[0]], [t[1]], *(shards(v) for v in t[2:9]), [t[9]], 0.05,
        1e-10, forward=forward, **kw)
    return (center[0], core[0], torch.cat(env), torch.cat(ls), Q[0]), mesh


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("n_dev", [1, 4])
def test_single_bond_dp_matches_jax_shard_map(interpret, forward, n_dev):
    """The JAX test's operands (tests/test_parallel.py:280-302 at N 32): one
    bond of q 1 under orth="qr", its realified QR once per replica."""
    x = _bond(11, n=32)
    ops = tuple(x[k] for k in NAMES)
    ref = _jax_dp_bond(ops, forward, n_dev)
    bk.reset_counts()
    got, mesh = _dp_bond(ops, forward, n_dev)
    assert mesh.reductions == 1
    assert {k: v for k, v in bk.PLAIN_CALLS.items() if v} == {
        "k1c_grad": n_dev, "k1c_update": 1, "k2c_split": 1,
        "k2c_env": n_dev}
    assert [g.dtype for g in got] == [torch.complex64] * 3 + [
        torch.float32, torch.complex64]
    atol = 1e-5 if n_dev == 1 else 1e-4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=atol)


@pytest.mark.parametrize("forward", [False, True])
def test_one_shard_chain_is_k12c_and_the_qr_bond(forward):
    """On one shard the chain does the single-device kernels' arithmetic:
    K12c under orth="ns" (q 3, the complex main path's refresh bond) and
    K1c -> realified QR -> K2c under orth="qr"; a frozen bond keeps V0."""
    x = _bond(12, n=32)
    ops = tuple(x[k] for k in NAMES)
    t = tuple(_t(o) for o in ops)
    for orth, ref in (("ns", bkc.k12c_plain(*t, 0.05, 1e-10, forward=forward,
                                            power_iters=3)),
                      ("qr", bkc.qr_bond_step_c(*t, 0.05, 1e-10,
                                                forward=forward, plain=True,
                                                power_iters=3))):
        got, _ = _dp_bond(ops, forward, 1, orth=orth, power_iters=3)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=1e-6)
    got, _ = _dp_bond(ops, forward, 1, refresh=False)
    torch.testing.assert_close(got[4], t[9], rtol=0, atol=0)
    ref = bkc.k12c_plain(*t, 0.05, 1e-10, forward=forward, refresh=False)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6)


# -------------------------------------------------------- the streamed step

@pytest.mark.parametrize("forward,refresh,orth,q", [
    (False, True, "ns", 3), (True, True, "ns", 3), (True, True, "qr", 1),
    (False, False, "qr", 1)])
def test_streamed_bond_step_matches_jax_streamed(interpret, forward, refresh,
                                                 orth, q):
    """13 rows in tiles of 5: three tiles, the last holding 3 rows and 2 pad
    rows (copies of row 0 at weight 0)."""
    x = _bond(13)
    kw = dict(forward=forward, refresh=refresh, power_iters=q, orth=orth)
    ops = tuple(x[k] for k in NAMES)
    ref = pallas_bond_c.bond_step_c(*(_pair(o) for o in ops),
                                    jnp.float32(0.05), jnp.float32(1e-10),
                                    stream_tile=5, **kw)
    bk.reset_counts()
    got = bkc.bond_step_c(*(_t(o) for o in ops), 0.05, 1e-10, stream_tile=5,
                          **kw)
    assert {k: v for k, v in bk.PLAIN_CALLS.items() if v} == {
        "k1c_grad": 3, "k1c_update": 1, "k2c_split": 1, "k2c_env": 3}
    assert [tuple(g.shape) for g in got] == [(C, CHI, D, CHI), (CHI, D, CHI),
                                             (N, CHI), (N,), (CHI * D, CHI)]
    _close(got, [_comb(r) for r in ref], rtol=STREAM_RTOL, atol=STREAM_ATOL)
    np.testing.assert_array_equal(_kept(got[1], forward),
                                  _kept(_comb(ref[1]), forward))


# ---------------------------------------------------------- sharded sweeps

@pytest.fixture(scope="module")
def tiny():
    """tests/test_parallel.py:347-361's complex problem: T 8, chi 6, d 3,
    C 2, N 32, unit-modulus features; the port's random_mps makes the JAX
    package's cores bit for bit."""
    T, chi, d, C_, n = 8, 6, 3, 2, 32
    mps = random_mps(0, T, d, C_, 4, chi, np.float64, device="cpu")
    rng = np.random.default_rng(0)
    y_idx = np.sort(rng.integers(0, C_, n))
    theta = np.random.default_rng(3).uniform(-np.pi, np.pi, (T, n, d))
    return dict(cores=mps.cores.numpy().astype(np.complex64),
                center=mps.center.numpy().astype(np.complex64),
                phis=(np.exp(-1j * theta) / np.sqrt(d)).astype(np.complex64),
                y1h=np.eye(C_, dtype=np.float32)[y_idx],
                w=np.full(n, 1.0 / n, np.float32))


def _squash(a):
    a = np.array(a)
    a[np.abs(a) < 1e-6] = 0.0
    return a


def test_sharded_sweeps_match_jax_sharded_sweeps(interpret, tiny):
    """Two complex64 randomized_warm sweeps on 4 shards (Newton-Schulz
    refresh, q 1): one bond_step_c_dp per bond, one all_reduce per bond
    update, against the JAX package's dp kernels under shard_map."""
    kw = dict(nsweeps=2, loss="KLD", bbopt="TSGO", update_iters=1,
              rescale=(False, True), svd_alg="randomized_warm", orth="ns")
    n_dev, x = 4, tiny
    mesh = Mesh(["cpu"] * n_dev)
    placed = replicate(mesh, _t(x["cores"]), _t(x["center"])) + \
        shard_train_arrays(mesh, _t(x["phis"]), _t(x["y1h"]), _t(x["w"]))
    calls = []
    reduce = mesh.all_reduce
    mesh.all_reduce = lambda parts: calls.append(len(parts)) or reduce(parts)
    bk.reset_counts()
    c2, ce2 = sharded_full_sweeps(mesh, *placed, 0.05, 1e-10, **kw)
    bonds = 2 * 2 * 7
    assert calls == [n_dev] * bonds
    assert {k: v for k, v in bk.PLAIN_CALLS.items() if v} == {
        "k1c_grad": n_dev * bonds, "k1c_update": bonds, "k2c_split": bonds,
        "k2c_env": n_dev * bonds}
    assert c2.dtype == torch.complex64 and torch.isfinite(ce2).all()
    jm = jax_make_mesh(n_dev)
    sp, sy, sw = jax_shard(jm, jnp.asarray(x["phis"]), jnp.asarray(x["y1h"]),
                           jnp.asarray(x["w"]))
    rc, rce = jax_replicate(jm, jnp.asarray(x["cores"]),
                            jnp.asarray(x["center"]))
    jc, jce = jax_sharded_sweeps(jm, rc, rce, sp, sy, sw, jnp.float32(0.05),
                                 jnp.float32(1e-10), **kw)
    np.testing.assert_allclose(_squash(ce2), _squash(jce), rtol=1e-2,
                               atol=2e-3)
    np.testing.assert_allclose(_squash(c2), _squash(jc), rtol=1e-2, atol=2e-3)


# ------------------------------------------------------------------ fit_mps

def test_fit_mps_complex_on_a_mesh(ecg200):
    """ECG200 X[:30, :16], fourier (complex64), the kernel route pinned
    (randomized_warm + ns; the CPU default is gram_eigh): 30 series padded
    to 32 on two shards, every bond one bond_step_c_dp; it classifies."""
    Xtr, ytr, Xte, yte = ecg200
    Xtr, ytr = Xtr[:30, :16], ytr[:30]
    opts = mt.MPSOptions(encoding="fourier", dtype="complex64", chi_max=8,
                         d=3, nsweeps=2, verbosity=-1, log_level=-1,
                         svd_alg="randomized_warm", orth_alg="ns")
    mesh = Mesh(["cpu"] * 2)
    bk.reset_counts()
    trained, info, _ = mt.fit_mps(Xtr, ytr, opts=opts, mesh=mesh)
    bonds = 2 * 2 * 15
    assert {k: v for k, v in bk.PLAIN_CALLS.items() if v} == {
        "k1c_grad": 2 * bonds, "k1c_update": bonds, "k2c_split": bonds,
        "k2c_env": 2 * bonds}
    assert sum(bk.LAUNCHES.values()) == 0 and mesh.reductions == bonds
    assert trained.mps.center.dtype == torch.complex64
    assert len(info["sweep_seconds"]) == 2
    preds = mt.classify(trained, Xte[:20, :16])
    assert preds.shape == (20,) and set(preds) <= set(np.unique(ytr))
    assert np.mean(mt.classify(trained, Xtr) == ytr) >= 0.6

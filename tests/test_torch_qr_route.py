"""The port's QR-refresh bond route: the plain versions of K1 and K2 held
against the JAX package's Pallas kernels _k1_call / _k2_call (run in
interpret mode, as tests/test_pallas_bond.py runs them), the whole
K1 -> QR -> K2 bond step against pallas_bond.bond_step(orth="qr"), the
kernels' operand marshalling, and qr fits against the JAX package's.  The
CUDA kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpstime_tpu as mj
import mpstime_tpu_torch as mt
from mpstime_tpu.ops import pallas_bond
from mpstime_tpu.ops.decomp import warm_sketch_init as jax_sketch
from mpstime_tpu_torch.ops import bond_kernels as bk

torch.set_num_threads(1)

# the per-bond bound of tests/test_pallas_bond.py:73-82 (f32 reassociation)
RTOL, ATOL = 1e-4, 3e-5
C, CHI, D, N = 2, 6, 3, 12


@pytest.fixture(scope="module")
def interpret():
    pallas_bond.set_interpret(True)
    jax.clear_caches()
    yield
    pallas_bond.set_interpret(False)
    jax.clear_caches()


def _bond(seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        A=rng.standard_normal((CHI, D, CHI)).astype(f32),
        center=rng.standard_normal((C, CHI, D, CHI)).astype(f32),
        le=rng.standard_normal((N, CHI)).astype(f32),
        re=rng.standard_normal((N, CHI)).astype(f32),
        ls=rng.standard_normal(N).astype(f32),
        opp=(0.3 * rng.standard_normal(N)).astype(f32),
        phil=rng.uniform(-0.8, 0.8, (N, D)).astype(f32),
        phir=rng.uniform(-0.8, 0.8, (N, D)).astype(f32),
        y1h=np.eye(C, dtype=f32)[rng.integers(0, C, N)],
        w=np.full(N, 1.0 / N, f32),
        V0=np.asarray(jax_sketch(CHI * D, CHI, f32)),
    )


def _close(got, ref, rtol=RTOL, atol=ATOL):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol,
                                   atol=atol)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


K1_GRID = [  # (emit_y, q): refresh bonds at q 1 and 3, and a frozen bond
    (True, 1), (True, 3), (False, 1)]


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("emit_y,q", K1_GRID)
@pytest.mark.parametrize("loss,bbopt", [("KLD", "TSGO"), ("KLD", "GD"),
                                        ("MSE", "TSGO"), ("MSE", "GD")])
def test_k1_plain_matches_pallas_k1(interpret, forward, emit_y, q, loss,
                                    bbopt):
    """BT and Y before the QR.  Under orth="qr" Y is the column-normalised
    power iterate, whose dynamic range at q=3 is the spectrum's 7th power:
    it is compared as it is, at the per-bond bound."""
    x = _bond(7 + q + 2 * forward)
    gls = x["ls"] + x["opp"]
    left, right = (x["center"], x["A"]) if forward else (x["A"], x["center"])
    ref = pallas_bond._k1_call(
        jnp.full((1, 1), 0.05, jnp.float32), jnp.asarray(left),
        jnp.asarray(right), *(jnp.asarray(x[k]) for k in
                              ("le", "re", "phil", "phir", "y1h")),
        jnp.asarray(x["w"][:, None]), jnp.asarray(gls[:, None]),
        jnp.asarray(x["V0"]), C=C, chi=CHI, d=D, forward=forward,
        emit_y=emit_y, q=q, orth="qr", loss=loss, bbopt=bbopt)
    got = bk.k1_plain(*_t(x["A"], x["center"], x["le"], x["re"], x["phil"],
                          x["phir"], x["y1h"], x["w"], gls, x["V0"]), 0.05,
                      forward=forward, emit_y=emit_y, power_iters=q,
                      orth="qr", loss=loss, bbopt=bbopt)
    assert got[0].shape == (C, CHI * D, D, CHI) and got[1].shape == (CHI * D,
                                                                    CHI)
    _close(got, ref)


def _k2_inputs(seed):
    """A stepped bond tensor and an orthonormal basis of its dominant
    subspace, as the QR route hands them to K2."""
    x = _bond(seed)
    rng = np.random.default_rng(seed + 100)
    BT = rng.standard_normal((C, CHI * D, D, CHI)).astype(np.float32)
    Q = np.linalg.qr(rng.standard_normal((CHI * D, CHI)))[0].astype(np.float32)
    return x, BT / np.linalg.norm(BT), Q


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("max_rank", [None, 4])
def test_k2_plain_matches_pallas_k2(interpret, forward, max_rank):
    x, BT, Q = _k2_inputs(21 + forward)
    env, phi = (x["le"], x["phil"]) if forward else (x["re"], x["phir"])
    mr = float(CHI if max_rank is None else max_rank)
    ref = pallas_bond._k2_call(
        jnp.asarray([[1e-10, mr]], jnp.float32), jnp.asarray(BT),
        jnp.asarray(Q), jnp.asarray(env), jnp.asarray(x["ls"][:, None]),
        jnp.asarray(phi), C=C, chi=CHI, d=D, forward=forward)
    got = bk.k2_plain(*_t(BT, Q, env, x["ls"], phi), 1e-10, forward=forward,
                      max_rank=max_rank)
    _close(got[:3], ref[:3])
    _close(got[3:], (np.asarray(ref[3])[:, 0],))
    if max_rank is not None:
        kept = (got[1] != 0).any(dim=-1).any(dim=-1) if not forward \
            else (got[1] != 0).any(dim=0).any(dim=0)
        assert int(kept.sum()) == max_rank


def test_k2_plain_cutoff_tie_break_matches_pallas(interpret):
    """The degenerate oracle of tests/test_pallas_bond.py:144-179 fed to K2:
    the projected energies are w = [4, 2, 2, 2, 1, .5] with the cutoff
    boundary inside the tie group; the stable order keeps exactly
    directions 0..2."""
    chi, d, c, n = 6, 2, 1, 4
    w = np.array([4.0, 2.0, 2.0, 2.0, 1.0, 0.5], np.float32)
    BT = np.zeros((c, chi * d, d, chi), np.float32)
    BT[0, :, 0, :].reshape(chi, d, chi)[:, 0, :] = np.diag(np.sqrt(w))
    Q = np.zeros((d * chi, chi), np.float32)
    Q[:chi] = np.eye(chi)
    env = np.zeros((n, chi), np.float32)
    env[:, 0] = 1.0
    phi = np.full((n, d), 0.5, np.float32)
    cutoff = float(np.float32(4.5 / w.sum()))
    ref = pallas_bond._k2_call(
        jnp.asarray([[cutoff, float(chi)]], jnp.float32), jnp.asarray(BT),
        jnp.asarray(Q), jnp.asarray(env), jnp.zeros((n, 1), jnp.float32),
        jnp.asarray(phi), C=c, chi=chi, d=d, forward=False)
    got = bk.k2_plain(*_t(BT, Q, env, np.zeros(n, np.float32), phi), cutoff,
                      forward=False)
    _close(got[:3], ref[:3])
    kept = (got[1] != 0).any(dim=-1).any(dim=-1).tolist()
    assert kept == [True, True, True, False, False, False]


def _step_args(x, forward, conv):
    return tuple(conv(np.array(a)) for a in (
        x["A"], x["center"], x["le"], x["re"], x["ls"], x["phil"],
        x["phir"], x["y1h"], x["w"], x["V0"]))


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("q,loss,max_rank", [(1, "KLD", None),
                                             (3, "MSE", None),
                                             (1, "KLD", 4)])
def test_qr_bond_step_matches_pallas_qr_bond_step(interpret, forward, q,
                                                  loss, max_rank):
    """K1 -> QR -> K2 against the JAX package's K1 -> jnp.linalg.qr -> K2
    (pallas_bond.py:1320-1372).  Both QRs are LAPACK Householder on a
    full-rank Y here, so Q agrees column for column."""
    x = _bond(31 + q)
    kw = dict(forward=forward, refresh=True, power_iters=q, orth="qr",
              loss=loss)
    ref = pallas_bond.bond_step(
        *_step_args(x, forward, jnp.asarray), jnp.float32(0.05),
        jnp.float32(1e-10),
        max_rank=None if max_rank is None else jnp.int32(max_rank),
        opp_ls=jnp.asarray(x["opp"]), **kw)
    bk.reset_counts()
    got = bk.bond_step(*_step_args(x, forward, torch.from_numpy), 0.05, 1e-10,
                       max_rank=max_rank, opp_ls=torch.from_numpy(x["opp"]),
                       **kw)
    assert bk.PLAIN_CALLS == {**dict.fromkeys(bk.PLAIN_CALLS, 0), "k1": 1,
                             "k2": 1}
    _close(got, ref)
    np.testing.assert_allclose(got[4].T @ got[4], np.eye(CHI), atol=1e-5)


def test_rank_deficient_qr_bond_agrees_in_gauge_invariants(interpret):
    """A bond whose bond tensor has rank below chi (the center lives on two
    left-bond directions, GD at eta 0 leaves it there): Y is rank
    deficient, and the QR's fill-in columns follow the LAPACK build's
    rounding, so the two packages' Q may differ column for column.  What the
    split means agrees: the contracted two-site tensor center.core, the
    environment's Gram over samples and its log-scales, and the span of
    the kept directions.  The bond tensor has rank 4 (two left-bond
    directions per class); the fill-in directions carry f32 rounding noise
    of up to ~1e-10 of the energy, on either side of the default cutoff, so
    the cutoff here is 1e-6: it keeps exactly the four real directions in
    both packages."""
    x = _bond(41)
    x["center"][:, 2:] = 0.0
    kw = dict(forward=False, refresh=True, orth="qr", bbopt="GD")
    ref = pallas_bond.bond_step(*_step_args(x, False, jnp.asarray),
                                jnp.float32(0.0), jnp.float32(1e-6), **kw)
    got = bk.bond_step(*_step_args(x, False, torch.from_numpy), 0.0, 1e-6,
                       **kw)
    ref = [np.asarray(r) for r in ref]
    got = [g.numpy() for g in got]
    for core in (got[1], ref[1]):
        assert int((np.abs(core).sum(axis=(1, 2)) > 0).sum()) == 4
    # backward: center [C, a, i, m], core [m, k, b]
    two_site = lambda c, v: np.einsum("caim,mkb->caikb", c, v)  # noqa: E731
    np.testing.assert_allclose(two_site(got[0], got[1]),
                               two_site(ref[0], ref[1]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[2] @ got[2].T, ref[2] @ ref[2].T,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[3], ref[3], rtol=RTOL, atol=ATOL)
    kept_t = got[1].reshape(CHI, -1)
    kept_j = ref[1].reshape(CHI, -1)
    np.testing.assert_allclose(kept_t.T @ kept_t, kept_j.T @ kept_j,
                               rtol=RTOL, atol=ATOL)


def test_k1_k2_launches_check_operands_before_launching():
    x = _bond(51)
    calls = []
    wsf = lambda *s: 16  # noqa: E731
    a1 = _t(x["A"], x["center"], x["le"], x["re"], x["phil"], x["phir"],
            x["y1h"], x["w"], x["ls"], x["V0"])
    BT, Y = bk._launch_k1(*a1, 0.05, forward=False, emit_y=True,
                          power_iters=1, orth="qr", loss="MSE", bbopt="TSGO",
                          launch=lambda *p: calls.append(p),
                          workspace_floats=wsf)
    assert len(calls[0]) == 24 and calls[0][4] is not None      # gls (MSE)
    assert calls[0][13:23] == (C, CHI, D, N, 0, 1, 1, 1, 1, 0)
    assert BT.shape == (C, CHI * D, D, CHI) and Y.shape == (CHI * D, CHI)
    bk._launch_k1(*a1, 0.05, forward=True, emit_y=False, power_iters=2,
                  orth="ns", loss="KLD", bbopt="GD",
                  launch=lambda *p: calls.append(p), workspace_floats=wsf)
    assert calls[1][4] is None and calls[1][13:23] == (C, CHI, D, N, 1, 0, 2,
                                                       0, 0, 1)
    env, phi = _t(x["re"], x["phir"])
    out = bk._launch_k2(BT, Y, env, torch.from_numpy(x["ls"]), phi, 1e-10,
                        forward=False, max_rank=4,
                        launch=lambda *p: calls.append(p),
                        workspace_floats=wsf)
    assert len(calls[2]) == 17 and calls[2][10:] == (C, CHI, D, N, 0, 1e-10,
                                                      4.0)
    assert [tuple(o.shape) for o in out] == [(C, CHI, D, CHI), (CHI, D, CHI),
                                             (N, CHI), (N,)]
    bad = list(a1)
    bad[9] = bad[9][:, :3]
    with pytest.raises(ValueError, match="shape"):
        bk._launch_k1(*bad, 0.05, forward=False, emit_y=True, power_iters=1,
                      orth="qr", loss="KLD", bbopt="TSGO", launch=None,
                      workspace_floats=wsf)
    with pytest.raises(ValueError, match="float32"):
        bk._launch_k2(BT.double(), Y, env, torch.from_numpy(x["ls"]), phi,
                      1e-10, forward=False, max_rank=None, launch=None,
                      workspace_floats=wsf)
    with pytest.raises(ValueError, match="contiguous"):
        bk._launch_k2(BT, Y.T.contiguous().T, env, torch.from_numpy(x["ls"]),
                      phi, 1e-10, forward=False, max_rank=None, launch=None,
                      workspace_floats=wsf)
    assert len(calls) == 3


# ---- whole fits -----------------------------------------------------------

#: A configuration whose bonds keep full rank (chi_max = d = chi_init = 3):
#: where a bond tensor has rank below chi_max, Y is rank deficient and the
#: QR's fill-in columns follow the LAPACK build's rounding, so the port
#: (MKL) and the JAX package part there.  Measured at chi_max 8, d 3,
#: chi_init 4 (ROADMAP.md queue 3): bonds of rank 3 and 6 give Q columns up
#: to 1.99 apart while US.Vh agrees to 1e-15, and two f64 sweeps end 1.64
#: apart in max |cores|.
QR_OPTS = dict(chi_max=3, d=3, chi_init=3, verbosity=-1, log_level=-1,
               svd_alg="randomized_warm", orth_alg="qr")


@pytest.fixture(scope="module")
def qr_data(ecg200):
    Xtr, ytr, Xte, _ = ecg200
    return Xtr[:30, :32], ytr[:30], Xte[:40, :32]


def _assert_fits_agree(tf, jf, Xte):
    np.testing.assert_allclose(tf.mps.cores.numpy(), np.asarray(jf.mps.cores),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tf.mps.center.numpy(),
                               np.asarray(jf.mps.center), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_array_equal(mt.classify(tf, Xte), mj.classify(jf, Xte))


def test_f64_qr_fit_matches_jax(qr_data):
    """Two f64 sweeps of the qr warm route (the unfused route in both
    packages: float64 is no kernel's), rtol 1e-3 / atol 1e-4 and identical
    predictions as tests/test_torch_slice.py holds the ns route; measured
    4e-13 apart in max |cores|."""
    Xtr, ytr, Xte = qr_data
    opts = dict(QR_OPTS, nsweeps=2, dtype="float64")
    jf, _, _ = mj.fit_mps(Xtr, ytr, opts=mj.MPSOptions(**opts))
    tf, _, _ = mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(**opts), device="cpu")
    _assert_fits_agree(tf, jf, Xte)


def test_f32_qr_fit_matches_jax_pallas_fit_over_one_short_sweep(qr_data):
    """Float32 through the QR route of both packages (K1 -> QR -> K2 per
    bond; JAX's Pallas kernels in interpret mode), one sweep at T=8 as the
    ns route is held (tests/test_torch_slice.py); measured 4.9e-6 apart in
    max |cores|."""
    Xtr, ytr, Xte = (a[:, :8] if a.ndim == 2 else a for a in qr_data)
    opts = dict(QR_OPTS, nsweeps=1, dtype="float32")
    pallas_bond.set_interpret(True)
    jax.clear_caches()
    try:
        jf, _, _ = mj.fit_mps(Xtr, ytr, opts=mj.MPSOptions(**opts))
    finally:
        pallas_bond.set_interpret(False)
        jax.clear_caches()
    bk.reset_counts()
    tf, _, _ = mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(**opts), device="cpu")
    assert bk.PLAIN_CALLS == {**dict.fromkeys(bk.PLAIN_CALLS, 0), "k1": 14,
                             "k2": 14}
    _assert_fits_agree(tf, jf, Xte)


def test_qr_mse_fit_runs_k12_on_frozen_bonds(qr_data):
    # MSE bonds run one by one: K1 -> QR -> K2 when refreshed, K12 frozen
    Xtr, ytr, _ = qr_data
    bk.reset_counts()
    trained, _, _ = mt.fit_mps(
        Xtr[:, :8], ytr, device="cpu",
        opts=mt.MPSOptions(**{**QR_OPTS, "nsweeps": 2, "loss_grad": "MSE",
                              "subspace_refresh_every": 2}))
    assert bk.PLAIN_CALLS == {**dict.fromkeys(bk.PLAIN_CALLS, 0), "k12": 14,
                             "k1": 14, "k2": 14}
    assert bool(torch.isfinite(trained.mps.center).all())

"""The ritz route of the port (svd_alg="randomized_warm_ritz"), held against
the JAX package: the eigen-rotations and ritz splits of ops/decomp.py, the
tri-Newton refresh and the Jacobi rounds against their Pallas pair twins,
K12cr's plain version against the Pallas K12cr in interpret mode and
against the port's own unfused ritz step, one tracked sweep, the exact ->
tracked schedule, and whole fits.

Tolerances, each stated where it is used:
  * float64 / complex128 decomp functions: 1e-10 (the same arithmetic;
    eigh's eigenvectors compared up to their column phase, which the two
    LAPACK builds pick differently);
  * complex64 bond steps: rtol 1e-4 / atol 5e-5, the JAX package's own for
    its complex kernels (tests/test_pallas_bond_c.py:94-103), and its gauge
    tolerances (tests/test_pallas_bond_c.py:388-432) where two routes differ
    by a per-direction phase;
  * one tracked complex64 sweep: the trained states' KLD to rtol 2e-3,
    JAX's own bar for the same comparison (tests/test_pallas_bond_c.py:
    510-556);
  * whole fits: complex128 trajectories over 2 sweeps on the contracted
    outputs and KLD traces (rtol 1e-6), complex64 on quality (f32 fits part
    chaotically, ROADMAP.md queue 3)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpstime_tpu as mj
import mpstime_tpu_torch as mt
from mpstime_tpu.ops import decomp as jdec
from mpstime_tpu.ops import pallas_bond, pallas_bond_c
from mpstime_tpu.ops.bond_update import apply_update as jax_update
from mpstime_tpu.models.mps import MPS as JaxMPS
from mpstime_tpu.models.mps import contract_batch_scaled as jax_contract
from mpstime_tpu.summary import _encode_test as jax_encode_test
from mpstime_tpu.training import sweep as jsweep
from mpstime_tpu.training.stats import loss_acc_conf as jax_stats
from mpstime_tpu_torch.models.mps import MPS, contract_batch_scaled
from mpstime_tpu_torch.ops import bond_kernels as bk
from mpstime_tpu_torch.ops import bond_kernels_c as bkc
from mpstime_tpu_torch.ops import decomp as tdec
from mpstime_tpu_torch.ops.bond_update import apply_update
from mpstime_tpu_torch.ops.env import (env_step_left_scaled,
                                       env_step_right_scaled)
from mpstime_tpu_torch.summary import _encode_test
from mpstime_tpu_torch.training import sweep as tsweep
from mpstime_tpu_torch.training.stats import loss_acc_conf

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 5e-5
F64 = dict(rtol=1e-10, atol=1e-10)
ROTS = ["eigh", "eigh_r", "track", "jacobi", "jacobi_warm"]


@pytest.fixture
def interpret():
    pallas_bond.set_interpret(True)
    jax.clear_caches()
    yield
    pallas_bond.set_interpret(False)
    jax.clear_caches()


def _rand(rng, shape, dtype):
    a = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def _gram(seed, k, dtype=np.complex128):
    """A hermitian PSD [k, k] with a decaying spectrum."""
    rng = np.random.default_rng(seed)
    B = _rand(rng, (3 * k, k), dtype) * np.exp(-0.3 * np.arange(k))
    return B.conj().T @ B


def _phase_aligned(W, ref):
    """W's columns rotated by the unit phase that best matches ref's."""
    ph = np.sum(W.conj() * ref, axis=0)
    return W * (ph / np.maximum(np.abs(ph), 1e-300))


# ---- options ----------------------------------------------------------------

@pytest.mark.parametrize("chi", [40, 41, 64])
@pytest.mark.parametrize("encoding", [
    "legendre", "legendre_norm", "uniform", "fourier", "stoudenmire",
    "sahand", "sahand_legendre", "hist_split_fourier"])
def test_ritz_resolution_matches_jax_on_both_devices(monkeypatch, encoding,
                                                     chi):
    # the CPU resolves as JAX's CPU branch, "cuda" as its accelerator
    # branch (jax.default_backend() patched, as tests/test_training.py:351)
    to, jo = mt.MPSOptions(encoding=encoding, chi_max=chi), \
        mj.MPSOptions(encoding=encoding, chi_max=chi)
    for device, backend in (("cpu", "cpu"), ("cuda", "tpu")):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        assert (to.resolved_svd_alg(device), to.resolved_orth_alg(device),
                to.resolved_power_iters(device),
                to.resolved_ritz_rots(device)) == (
            jo.resolved_svd_alg(), jo.resolved_orth_alg(),
            jo.resolved_power_iters(), jo.resolved_ritz_rots())
    ritz = mj.MPSOptions(encoding=encoding, chi_max=chi).resolved_svd_alg()
    assert (ritz == "randomized_warm_ritz") == (
        chi > 40 and encoding in ("fourier", "stoudenmire", "sahand",
                                  "hist_split_fourier"))


def test_route_notice_counts_k12cr_as_the_kernels():
    # sweep.py:190-206: a complex ritz fit whose tracked sweeps run K12cr
    # takes no notice; another tracker, or a real ritz fit, does
    args = ("KLD", "TSGO", 1, (False, True), "randomized_warm_ritz", "cuda")
    assert tsweep.pallas_route_notice(torch.complex64, *args) is None
    note = tsweep.pallas_route_notice(torch.complex64, *args,
                                      ritz_track_rot="track")
    assert "ritz_rot_track='track'" in note
    note = tsweep.pallas_route_notice(torch.float32, *args)
    assert "svd_alg='randomized_warm_ritz'" in note
    assert tsweep.pallas_route_notice(torch.complex128, *args) is not None


# ---- the decomp functions ---------------------------------------------------

def test_fixed_hermitian_is_bit_identical():
    for k in (5, 64):
        for a, b in zip(tdec._fixed_hermitian_np(k),
                        jdec._fixed_hermitian_np(k)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
@pytest.mark.parametrize("rot", ROTS)
def test_ritz_rotation_matches_jax(rot, dtype):
    S = _gram(3, 9, dtype)
    w, W = tdec._ritz_rot(torch.from_numpy(S), rot)
    wj, Wj = (np.asarray(a) for a in jdec._ritz_rot(jnp.asarray(S), rot))
    np.testing.assert_allclose(w.numpy(), wj, **F64)
    W = W.numpy()
    if rot in ("eigh", "eigh_r"):
        W = _phase_aligned(W, Wj)       # eigh fixes columns up to a phase
    np.testing.assert_allclose(W, Wj, **F64)
    # a unitary rotation onto (near-)eigenvectors, whatever the order
    np.testing.assert_allclose(W.conj().T @ W, np.eye(9), atol=1e-10)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh", [True, False])
@pytest.mark.parametrize("rot", ROTS)
def test_warm_ritz_split_matches_jax(rot, refresh, forward):
    rng = np.random.default_rng(5)
    R, Cc, keep = (36, 18, 7) if not forward else (18, 36, 7)
    M = _rand(rng, (R, Cc), np.complex128)
    V0 = np.array(jdec.warm_sketch_init(Cc if not forward else R, keep,
                                        np.complex128))
    kw = dict(q=2, refresh=refresh, orth="qr", rot=rot, max_rank=6)
    tf = tdec.warm_ritz_split_right if forward else tdec.warm_ritz_split_left
    jf = jdec.warm_ritz_split_right if forward else jdec.warm_ritz_split_left
    A, B, Q = tf(torch.from_numpy(M), torch.from_numpy(V0), keep, 1e-10, **kw)
    Aj, Bj, Qj = (np.asarray(a) for a in jf(jnp.asarray(M), jnp.asarray(V0),
                                             keep, 1e-10, **kw))
    # the truncated product is gauge-free
    np.testing.assert_allclose((A @ B).numpy(), Aj @ Bj, **F64)
    Q = Q.numpy()
    if rot in ("eigh", "eigh_r"):
        Q = _phase_aligned(Q, Qj)
    np.testing.assert_allclose(Q, Qj, **F64)
    kept = (A != 0).any(dim=0) if forward else (B != 0).any(dim=1)
    assert int(kept.sum()) == 6           # the rank cap


@pytest.mark.parametrize("rot", ["eigh", "jacobi"])
def test_warm_ritz_split_rank_deficient_masks_zeros(rot):
    # tests/test_mps_ops.py:369-382: a rank-8 M split at keep 20 keeps 8
    # directions; the dropped ones come out exactly zero, in both packages
    rng = np.random.default_rng(13)
    A = rng.standard_normal((120, 8)) @ rng.standard_normal((8, 60))
    V0 = np.array(jdec.warm_sketch_init(60, 20, np.float64))
    US, Vh, _ = tdec.warm_ritz_split_left(torch.from_numpy(A),
                                          torch.from_numpy(V0), 20, 1e-12,
                                          rot=rot)
    USj, Vhj, _ = jdec.warm_ritz_split_left(jnp.asarray(A), jnp.asarray(V0),
                                            20, 1e-12, rot=rot)
    live = Vh.abs().sum(1) > 1e-9
    assert int(live.sum()) == 8
    assert not US[:, ~live].any() and not Vh[~live].any()
    np.testing.assert_array_equal(live.numpy(),
                                  np.abs(np.asarray(Vhj)).sum(1) > 1e-9)
    np.testing.assert_allclose((US @ Vh).numpy(), A, atol=1e-9)
    np.testing.assert_allclose((US @ Vh).numpy(), np.asarray(USj @ Vhj),
                               **F64)


def test_pairwise_mask_is_the_sorted_rule():
    # the kernels' sort-free rule equals the descending-sort rule, ties and
    # rank cap included (pallas_bond.py:662-697)
    w = torch.tensor([2.0, 4.0, 2.0, 0.5, 2.0, 1.0, 0.0, 3.0],
                     dtype=torch.float64)
    for cutoff in (0.0, 0.05, 4.5 / 14.5, 0.6):
        for mr in (None, 2, 4, 7):
            np.testing.assert_array_equal(
                tdec._pairwise_mask(w, cutoff, mr).numpy(),
                tdec._mask_by_energy(w, 8, cutoff, mr).numpy())


# ---- the kernel pieces against their Pallas pair twins ---------------------

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


def test_tri_newton_matches_the_pair_twin():
    # the QR-gauge refresh: the thin-QR Q with a positive real R diagonal
    rng = np.random.default_rng(7)
    X = _rand(rng, (24, 8), np.complex64)
    X = X / np.linalg.norm(X, axis=0)
    got = tdec.tri_newton(torch.from_numpy(X)).numpy()
    ref = _comb(pallas_bond_c._tri_newton_pair(_pair(X)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    R = got.conj().T @ X
    np.testing.assert_allclose(np.tril(R, -1), 0, atol=1e-5)
    assert np.all(np.diagonal(R).real > 0)
    np.testing.assert_allclose(np.abs(np.diagonal(R).imag), 0, atol=1e-5)


@pytest.mark.parametrize("rounds", [6, 24])
def test_jacobi_rounds_match_the_pair_twin(rounds):
    # tests/test_pallas_bond_c.py:369-386: a near-diagonal S, as tracking
    # hands the rotation, at its tolerances
    rng = np.random.default_rng(2)
    k = 8
    D = np.diag(np.sort(rng.uniform(0.1, 1.0, k))[::-1])
    P = _rand(rng, (k, k), np.complex128)
    P = (P + P.conj().T) / 2
    S = (D + 0.05 * P / np.linalg.norm(P)).astype(np.complex64)
    w, W = tdec._ritz_rot_jacobi(torch.from_numpy(S), rounds)
    wv, Wp = pallas_bond_c._jacobi_rounds_pair(_pair(S), rounds=rounds)
    np.testing.assert_allclose(w.numpy(), np.asarray(wv)[0], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(W.numpy(), _comb(Wp), rtol=1e-4, atol=1e-4)


# ---- K12cr's plain version -------------------------------------------------

CHI, D, C, N = 6, 3, 2, 14


def _bond(seed, chi=CHI, d=D, C=C, N=N):
    """Numpy-seeded complex64 operands of one bond, of the kinds
    tests/test_pallas_bond_c.py:37-58 draws: unit-modulus conjugated
    features, a class-major center."""
    rng = np.random.default_rng(seed)
    phi = (np.exp(1j * rng.uniform(-np.pi, np.pi, (2, N, d)))
           / np.sqrt(d)).astype(np.complex64)
    return dict(
        A=_rand(rng, (chi, d, chi), np.complex64),
        center=_rand(rng, (C, chi, d, chi), np.complex64),
        le=_rand(rng, (N, chi), np.complex64),
        re=_rand(rng, (N, chi), np.complex64),
        ls=rng.standard_normal(N).astype(np.float32), phil=phi[0],
        phir=phi[1], y1h=np.eye(C, dtype=np.float32)[rng.integers(0, C, N)],
        w=np.full(N, 1.0 / N, np.float32),
        V0=tdec.warm_sketch_init(chi * d, chi, np.complex64).numpy())


KEYS = ("A", "center", "le", "re", "ls", "phil", "phir", "y1h", "w", "V0")


def _torch_ops(x):
    return tuple(torch.from_numpy(np.ascontiguousarray(x[k])) for k in KEYS)


def _invariants(out, forward):
    """The gauge invariants of tests/test_pallas_bond_c.py:388-432: the
    reconstructed two-site tensor, env against conj(core), the log-scales
    and the cache's projector."""
    center, core, env, ls, Q = (np.asarray(o) for o in out)
    if forward:
        rec = np.einsum("aim,cmkb->caikb", core, center)
        inv = np.einsum("nm,akm->nak", env, np.conj(core))
    else:
        rec = np.einsum("caim,mkb->caikb", center, core)
        inv = np.einsum("nm,mkb->nkb", env, np.conj(core))
    return rec, inv, ls, Q @ Q.conj().T


def _kept(core, forward):
    core = np.asarray(core)
    return (core != 0).any(axis=(0, 1)) if forward else \
        (core != 0).any(axis=(1, 2))


# (forward, refresh, q, rounds, max_rank): held against the Pallas K12cr; a
# few cases, since each interpreted kernel costs seconds
PALLAS_CASES = [(False, True, 1, 6, None), (True, True, 3, 24, None),
                (False, False, 1, 24, 4), (True, True, 1, 6, 4)]


@pytest.mark.parametrize("forward,refresh,q,rounds,mr", PALLAS_CASES)
def test_k12cr_plain_matches_pallas_k12cr(interpret, forward, refresh, q,
                                          rounds, mr):
    x = _bond(30 + q + rounds + 2 * refresh)
    ref = pallas_bond_c.bond_step_c_ritz(
        *(_pair(x[k]) for k in KEYS), jnp.float32(0.05), jnp.float32(1e-10),
        forward=forward, refresh=refresh, power_iters=q, rounds=rounds,
        max_rank=None if mr is None else jnp.int32(mr))
    ref = tuple(_comb(o) for o in ref)
    bk.reset_counts()
    rot = "jacobi" if rounds == 6 else "jacobi_warm"
    got = bkc.bond_step_c_ritz(*_torch_ops(x), 0.05, 1e-10, forward=forward,
                               refresh=refresh, power_iters=q, max_rank=mr,
                               rot=rot)
    assert bk.PLAIN_CALLS == {**dict.fromkeys(bk.PLAIN_CALLS, 0), "k12cr": 1}
    # the same algorithm on both sides: the raw outputs
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(_kept(got[1], forward),
                                  _kept(ref[1], forward))
    if mr is not None:
        assert int(_kept(got[1], forward).sum()) == mr


def _jax_test_bond(seed, chi=CHI, d=D, C=C, N=12):
    """tests/test_pallas_bond_c.py:37-58's complex128 operands, drawn in its
    order, with the center class-major and the cold-start cache."""
    rng = np.random.default_rng(seed)

    def c(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    def phi(*shape):
        return np.exp(1j * rng.uniform(-np.pi, np.pi, shape)) / np.sqrt(3)

    A, center, le, re = (c(chi, d, chi), c(chi, d, chi, C), c(N, chi),
                         c(N, chi))
    ls = rng.standard_normal(N)
    phil, phir = phi(N, d), phi(N, d)
    y1h = np.eye(C)[rng.integers(0, C, N)]
    return dict(A=A, center=np.ascontiguousarray(np.moveaxis(center, 3, 0)),
                le=le, re=re, ls=ls, phil=phil, phir=phir, y1h=y1h,
                w=np.full(N, 1.0 / N),
                V0=np.array(jdec.warm_sketch_init(d * chi, chi,
                                                  np.complex128)))


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh,q", [(True, 1), (True, 3), (False, 1)])
def test_k12cr_plain_matches_the_unfused_ritz_step(forward, refresh, q):
    # tests/test_pallas_bond_c.py:435-477 in the port, on its operands:
    # complex64 K12cr against the unfused ritz step (apply_update,
    # warm_ritz_split_* with rot="jacobi", orth="qr", the env step) in
    # complex128.  K12cr's tri-Newton refresh is the QR gauge with a positive
    # real R diagonal, the realified Householder QR another phase gauge, so
    # the two are held on the gauge invariants at that test's tolerances.
    # Where the first power step's iterate is ill-conditioned, K12cr's 8
    # tri-Newton steps stop short of orthonormality and the two part beyond
    # the gauge, in the JAX package as here (ROADMAP.md queue 3)
    x = _jax_test_bond(21 if not forward else 23)
    A, center, le, re, ls, phil, phir, y1h, w, V0 = (
        torch.from_numpy(x[k]) for k in KEYS)
    kw = dict(q=q, refresh=refresh, orth="qr", rot="jacobi")
    if forward:
        BT = torch.einsum("caim,mkb->aikbc", center, A)
    else:
        BT = torch.einsum("aim,cmkb->aikbc", A, center)
    _, BT = apply_update(BT, le, re, phil.conj(), phir.conj(), y1h, w,
                         torch.zeros(12, dtype=torch.float64), eta=0.05)
    if forward:
        U, SVh, Q = tdec.warm_ritz_split_right(
            BT.reshape(CHI * D, D * CHI * C), V0, CHI, 1e-10, **kw)
        core = U.reshape(CHI, D, CHI)
        center2 = SVh.reshape(CHI, D, CHI, C).permute(3, 0, 1, 2)
        env2, ls2 = env_step_left_scaled(le, ls, core, phil)
    else:
        US, Vh, Q = tdec.warm_ritz_split_left(
            BT.permute(0, 1, 4, 2, 3).reshape(CHI * D * C, D * CHI), V0, CHI,
            1e-10, **kw)
        center2 = US.reshape(CHI, D, C, CHI).permute(2, 0, 1, 3)
        core = Vh.reshape(CHI, D, CHI)
        env2, ls2 = env_step_right_scaled(re, ls, core, phir)
    got = bkc.k12cr_plain(*(torch.from_numpy(
        x[k].astype(np.complex64 if x[k].dtype.kind == "c" else np.float32))
        for k in KEYS), 0.05, 1e-10, forward=forward, refresh=refresh,
        power_iters=q)
    gi = _invariants(got, forward)
    ri = _invariants((center2, core, env2, ls2, Q), forward)
    np.testing.assert_allclose(gi[0], ri[0], rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(gi[1], ri[1], rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(gi[2], ri[2], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(gi[3], ri[3], rtol=0, atol=5e-3)


def test_k12cr_refuses_other_rotations_and_checks_operands():
    ops = _torch_ops(_bond(50))
    with pytest.raises(ValueError, match="Jacobi"):
        bkc.bond_step_c_ritz(*ops, 0.05, 1e-10, forward=False, rot="track")
    calls = []
    bad = list(ops)
    bad[1] = bad[1].to(torch.complex128)
    with pytest.raises(ValueError, match="center_c must be complex64"):
        bk._launch_k12m(bad[0][None], bad[1], bad[2][None], bad[3], bad[4],
                        None, bad[5][None], bad[6][None], bad[7], bad[8],
                        bad[9][None], 0.05, 1e-10, forward=False,
                        refresh=True, power_iters=1, max_rank=None,
                        loss="KLD", bbopt="TSGO",
                        launch=lambda *p: calls.append(p),
                        workspace_floats=lambda *s: 16,
                        dtype=torch.complex64)
    assert not calls


# ---- sweeps -----------------------------------------------------------------

def _sweep_operands(seed, T=6, chi=6, d=3, C=2, N=16):
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, (T, N, d))
    return dict(
        cores=_rand(rng, (T, chi, d, chi), np.complex64),
        center=_rand(rng, (chi, d, chi, C), np.complex64),
        phis=(np.exp(1j * th) / np.sqrt(d)).astype(np.complex64),
        y1h=np.eye(C, dtype=np.float32)[rng.integers(0, C, N)],
        w=np.full(N, 1.0 / N, np.float32))


SWEEP_KW = dict(loss="KLD", bbopt="TSGO", update_iters=1,
                rescale=(False, True), svd_alg="randomized_warm_ritz",
                power_iters=1, orth="qr")


def test_tracked_sweep_matches_jax_pallas_sweep(interpret):
    # one tracked sweep (rot="jacobi"): the port's fused route (K12cr's
    # plain version, one a bond) against the JAX package's Pallas route in
    # interpret mode (tests/test_pallas_bond_c.py:510-556): the routes'
    # phases compound through the cores, so the trained states are held on
    # their KLD on the training batch, at rtol 2e-3
    x = _sweep_operands(41)
    T, chi, d, _ = x["cores"].shape
    cj, zj, _ = jsweep.full_sweep_warm(
        jnp.asarray(x["cores"]), jnp.asarray(x["center"]),
        jsweep.init_subspaces(T, chi, d, np.complex64), jnp.asarray(x["phis"]),
        jnp.asarray(x["y1h"]), jnp.asarray(x["w"]), jnp.float32(0.05),
        jnp.float32(1e-10), ritz_rot="jacobi", **SWEEP_KW)
    cores, center, phis = (torch.from_numpy(x[k]) for k in
                           ("cores", "center", "phis"))
    LE, LE_ls = tsweep.init_left_env_state(cores, phis)
    VB, UF = tsweep.init_subspaces(T, chi, d, np.complex64, "cpu")
    bk.reset_counts()
    ct, zt, *_ = tsweep._sweep_core(
        cores, center, LE, LE_ls, VB, UF, phis, torch.from_numpy(x["y1h"]),
        torch.from_numpy(x["w"]), 0.05, 1e-10, ritz_rot="jacobi", **SWEEP_KW)
    assert bk.PLAIN_CALLS["k12cr"] == 2 * (T - 1)
    X_enc = torch.from_numpy(np.conj(x["phis"]).swapaxes(0, 1).copy())
    y_idx = np.argmax(x["y1h"], axis=1)
    _, kld_t, _, _ = loss_acc_conf(MPS(ct, zt, T - 1), X_enc, y_idx)
    _, kld_j, _, _ = jax_stats(JaxMPS(cj, zj, T - 1),
                               jnp.asarray(X_enc.numpy()), y_idx)
    np.testing.assert_allclose(kld_t, float(kld_j), rtol=2e-3)


def _recorded(module, call):
    """The (refresh, ritz_rot) of each sweep that ``call`` runs through
    ``module._sweep_core``, with the sweep body stubbed out."""
    seen = []
    real = module._sweep_core

    def stub(cores, center, LE, LE_ls, VB, UF, *a, refresh=True,
             ritz_rot="eigh", **k):
        seen.append((bool(refresh), ritz_rot))
        return cores, center, LE, LE_ls, VB, UF, None

    module._sweep_core = stub
    try:
        call()
    finally:
        module._sweep_core = real
    return seen


@pytest.mark.parametrize("refresh_every", [1, 2])
@pytest.mark.parametrize("exact_sweeps", [-1, 0, 2])
def test_schedule_matches_jax(exact_sweeps, refresh_every):
    # the JAX package's fused schedule (sweep.py:837-870), run eagerly so
    # its lax.cond takes one branch a sweep; ritz_exact_sweeps=0 has no
    # test in the JAX package
    x = _sweep_operands(42, T=4, chi=3, d=2, N=5)
    kw = dict(nsweeps=5, loss="KLD", bbopt="TSGO", update_iters=1,
              rescale=(False, True), svd_alg="randomized_warm_ritz",
              refresh_every=refresh_every, ritz_exact_sweeps=exact_sweeps,
              ritz_exact_rot="eigh_r", ritz_track_rot="jacobi")
    args = [x[k] for k in ("cores", "center", "phis", "y1h", "w")]

    def run_jax():
        with jax.disable_jit():
            jsweep._full_sweeps_impl(*(jnp.asarray(a) for a in args), 0.05,
                                     1e-10, **kw)

    def run_port():
        tsweep.full_sweeps(*(torch.from_numpy(a) for a in args), 0.05,
                           1e-10, **kw)

    seen = _recorded(tsweep, run_port)
    assert seen == _recorded(jsweep, run_jax)
    assert [r for r, _ in seen] == [i % refresh_every == 0 for i in range(5)]
    assert [rot for _, rot in seen] == [
        "jacobi" if 0 <= exact_sweeps <= i else "eigh_r" for i in range(5)]
    # the route each sweep takes: K12cr on the Jacobi rotations only, as the
    # JAX package's ritz_fused rule (sweep.py:326-329)
    for _, rot in seen:
        assert tsweep._ritz_fused(torch.complex64, "KLD", "TSGO", 1,
                                  (False, True), "randomized_warm_ritz",
                                  rot) == (rot in ("jacobi", "jacobi_warm"))


@pytest.mark.parametrize("kw,k12cr", [
    (dict(ritz_rot_exact="eigh_r", ritz_rot_track="jacobi"), 1),
    (dict(ritz_rot_exact="eigh", ritz_rot_track="track"), 0),
    (dict(ritz_rot_exact="jacobi", ritz_rot_track="jacobi"), 2)])
def test_ritz_fit_takes_k12cr_on_jacobi_sweeps_only(ecg200, kw, k12cr):
    # two sweeps at ritz_exact_sweeps=1: eigh_r and track take the unfused
    # route, jacobi (the exact sweeps' jacobi_warm) and jacobi take K12cr
    Xtr, ytr, _, _ = ecg200
    bk.reset_counts()
    trained, _, _ = mt.fit_mps(Xtr[:20, :8], ytr[:20], device="cpu",
                               opts=mt.MPSOptions(
                                   encoding="fourier", chi_max=6, d=3,
                                   nsweeps=2, verbosity=-1, log_level=-1,
                                   svd_alg="randomized_warm_ritz",
                                   ritz_exact_sweeps=1, **kw))
    assert bk.PLAIN_CALLS == {**dict.fromkeys(bk.PLAIN_CALLS, 0),
                              "k12cr": k12cr * 2 * 7}
    assert sum(bk.LAUNCHES.values()) == 0
    assert bool(torch.isfinite(trained.mps.center).all())


# ---- the slice as a whole ---------------------------------------------------

def test_fourier_ritz_fit_learns_like_jax(ecg200):
    # the JAX package's tracked-ritz cell (tests/test_pallas_bond_c.py:
    # 558-573): 4 sweeps, one exact (eigh_r) and three tracked by Jacobi,
    # complex64; the port's tracked sweeps run K12cr's plain version, the
    # JAX package's CPU route its XLA ritz step.  Quality, not trajectories.
    Xtr, ytr, _, _ = ecg200
    Xtr, ytr = Xtr[:40], ytr[:40]
    kw = dict(nsweeps=4, chi_max=12, d=3, encoding="fourier", verbosity=-1,
              log_level=-1, dtype="complex64",
              svd_alg="randomized_warm_ritz", ritz_exact_sweeps=1,
              ritz_rot_exact="eigh_r", ritz_rot_track="jacobi",
              init_rng=1234)
    bk.reset_counts()
    tf, _, _ = mt.fit_mps(Xtr, ytr, device="cpu", opts=mt.MPSOptions(**kw))
    T = Xtr.shape[1]
    assert bk.PLAIN_CALLS["k12cr"] == 3 * 2 * (T - 1)
    assert tf.mps.center.dtype == torch.complex64
    jf, _, _ = mj.fit_mps(Xtr, ytr, opts=mj.MPSOptions(**kw))
    assert np.mean(mt.classify(tf, Xtr) == ytr) >= 0.7
    assert np.mean(mj.classify(jf, Xtr) == ytr) >= 0.7


#: (ritz_exact_sweeps, exact rotation, tracker, chi_max, chi_init): ritz
#: schedules without an eigh.  The exact sweeps' eigh fixes each column up
#: to a phase that the two LAPACK builds pick differently, and the warm
#: cache carries that gauge into the next bond's split, so fits with eigh
#: sweeps part after the first such bond (ROADMAP.md queue 3); the eigh
#: split itself is held above, up to its phases.
C128_SCHEDULES = [(0, "eigh", "track", 3, 3), (1, "jacobi", "jacobi", 3, 3)]


@pytest.mark.parametrize("res,exact,track,chi,chi_init", C128_SCHEDULES)
def test_c128_ritz_fit_matches_jax_over_two_sweeps(ecg200, res, exact, track,
                                                  chi, chi_init):
    # complex128 takes the unfused ritz route in both packages; from the
    # same random_mps the two trajectories agree on the KLD trace and the
    # contracted outputs (rtol 1e-6; measured <= 1e-14)
    Xtr, ytr, Xte, _ = ecg200
    Xtr, ytr, Xte = Xtr[:30, :12], ytr[:30], Xte[:40, :12]
    kw = dict(encoding="fourier", chi_max=chi, chi_init=chi_init, d=3,
              nsweeps=2, verbosity=-1, log_level=1, dtype="complex128",
              svd_alg="randomized_warm_ritz", ritz_exact_sweeps=res,
              ritz_rot_exact=exact, ritz_rot_track=track)
    bk.reset_counts()
    tf, tinfo, _ = mt.fit_mps(Xtr, ytr, device="cpu",
                              opts=mt.MPSOptions(**kw))
    assert sum(bk.PLAIN_CALLS.values()) == 0
    jf, jinfo, _ = mj.fit_mps(Xtr, ytr, opts=mj.MPSOptions(**kw))
    np.testing.assert_allclose(tinfo["train_KL_div"], jinfo["train_KL_div"],
                               rtol=1e-6)
    yt, lt = contract_batch_scaled(tf.mps, _encode_test(tf, Xte).X_enc)
    yj, lj = jax_contract(jf.mps, jax_encode_test(jf, Xte).X_enc)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_array_equal(mt.classify(tf, Xte), mj.classify(jf, Xte))

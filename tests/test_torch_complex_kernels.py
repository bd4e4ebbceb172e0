"""The port's complex bond kernels: the plain versions of K12c, K12mc, K1c
and K2c held against the JAX package's complex Pallas kernels (interpret
mode, as tests/test_pallas_bond_c.py runs them; a few cases, since each
interpreted kernel costs seconds) and, for every other direction x refresh
x orth case, against its XLA complex route (apply_update, the warm split
and the scaled environment step, tests/test_pallas_bond_c.py:61-75); the
realified QR against the JAX package's; and the wrappers' dispatch,
counters and refusals.  The CUDA kernels are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: rtol 1e-4 / atol 5e-5 per bond, the JAX package's own for its
complex kernels against XLA (tests/test_pallas_bond_c.py:94-103; float32
reassociation across a dozen products and fourteen Newton-Schulz steps
per power step)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpstime_tpu.ops import pallas_bond, pallas_bond_c
from mpstime_tpu.ops import decomp as jdec
from mpstime_tpu.ops.bond_update import apply_update as jax_update
from mpstime_tpu.ops.env import env_step_left_scaled, env_step_right_scaled
from mpstime_tpu_torch.ops import bond_kernels as bk
from mpstime_tpu_torch.ops import bond_kernels_c as bkc
from mpstime_tpu_torch.ops import decomp as tdec

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 5e-5
CHI, D, C, N = 6, 3, 2, 12


@pytest.fixture(scope="module")
def interpret():
    pallas_bond.set_interpret(True)
    jax.clear_caches()
    yield
    pallas_bond.set_interpret(False)
    jax.clear_caches()


def _bond(seed, Bb=1, chi=CHI, d=D, C=C, N=N):
    """Numpy-seeded complex64 operands of Bb bonds (tests/test_pallas_bond_c
    .py:37-58): unit-modulus conjugated features, a class-major center."""
    rng = np.random.default_rng(seed)

    def c(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    def phi(*shape):
        th = rng.uniform(-np.pi, np.pi, shape)
        return (np.exp(1j * th) / np.sqrt(d)).astype(np.complex64)

    return dict(
        A=c(Bb, chi, d, chi), center=c(C, chi, d, chi), envx=c(Bb, N, chi),
        env0=c(N, chi), ls0=rng.standard_normal(N).astype(np.float32),
        phil=phi(Bb, N, d), phir=phi(Bb, N, d),
        y1h=np.eye(C, dtype=np.float32)[rng.integers(0, C, N)],
        w=np.full(N, 1.0 / N, np.float32),
        V0=np.stack([tdec.warm_sketch_init(chi * d, chi, np.complex64)
                     .numpy()] * Bb))


def _single(x, forward):
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0], x["env0"])
    return (x["A"][0], x["center"], le, re, x["ls0"], x["phil"][0],
            x["phir"][0], x["y1h"], x["w"], x["V0"][0])


def _torch(ops):
    return tuple(torch.from_numpy(np.ascontiguousarray(o)) for o in ops)


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
        np.testing.assert_allclose(g.numpy(), _comb(r), rtol=rtol, atol=atol)


def _xla_bond(ops, forward, refresh, q, orth):
    """The JAX package's XLA complex bond step (tests/test_pallas_bond_c.py:
    61-75): (center_c', core', env', env_ls', Q')."""
    A, center, le, re, ls, phil, phir, y1h, w, V0 = (jnp.asarray(o)
                                                     for o in ops)
    Cc = center.shape[0]
    zeros = jnp.zeros(le.shape[0], jnp.float32)
    kw = dict(eta=jnp.float32(0.05), loss="KLD", bbopt="TSGO",
              update_iters=1, rescale=(False, True))
    split_kw = dict(refresh=refresh, q=q, orth=orth)
    if forward:
        BT = jnp.einsum("caim,mkb->aikbc", center, A)
        _, BT = jax_update(BT, le, re, phil.conj(), phir.conj(), y1h, w,
                           zeros, **kw)
        U, SVh, Q = jdec.warm_split_right(BT.reshape(CHI * D, D * CHI * Cc),
                                          V0, CHI, jnp.float32(1e-10),
                                          **split_kw)
        core = U.reshape(CHI, D, CHI)
        center2 = jnp.moveaxis(SVh.reshape(CHI, D, CHI, Cc), 3, 0)
        env2, ls2 = env_step_left_scaled(le, ls, core, phil)
    else:
        BT = jnp.einsum("aim,cmkb->aikbc", A, center)
        _, BT = jax_update(BT, le, re, phil.conj(), phir.conj(), y1h, w,
                           zeros, **kw)
        M = BT.transpose(0, 1, 4, 2, 3).reshape(CHI * D * Cc, D * CHI)
        US, Vh, Q = jdec.warm_split_left(M, V0, CHI, jnp.float32(1e-10),
                                         **split_kw)
        center2 = jnp.moveaxis(US.reshape(CHI, D, Cc, CHI), 2, 0)
        core = Vh.reshape(CHI, D, CHI)
        env2, ls2 = env_step_right_scaled(re, ls, core, phir)
    return center2, core, env2, ls2, Q


def _pallas_bond(ops, forward, refresh, q, orth):
    out = pallas_bond_c.bond_step_c(
        *(_pair(o) for o in ops), jnp.float32(0.05), jnp.float32(1e-10),
        forward=forward, refresh=refresh, power_iters=q, orth=orth)
    return tuple(_comb(o) for o in out)


# (forward, refresh, q, orth): the cases held against the Pallas kernels
PALLAS_CASES = [(False, True, 3, "ns"),        # K12c, the main path's bond
                (True, False, 1, "ns"),        # K12c, a frozen bond
                (False, True, 3, "qr")]        # K1c -> QR -> K2c


@pytest.mark.parametrize("forward,refresh,q,orth", PALLAS_CASES)
def test_plain_bond_matches_pallas_complex_kernels(interpret, forward,
                                                   refresh, q, orth):
    x = _bond(3 + q + 2 * refresh)
    ops = _single(x, forward)
    ref = _pallas_bond(ops, forward, refresh, q, orth)
    bk.reset_counts()
    got = bkc.bond_step_c(*_torch(ops), 0.05, 1e-10, forward=forward,
                          refresh=refresh, power_iters=q, orth=orth)
    want = ({"k1c": 1, "k2c": 1} if refresh and orth == "qr"
            else {"k12c": 1})
    assert bk.PLAIN_CALLS == {**dict.fromkeys(bk.PLAIN_CALLS, 0), **want}
    assert sum(bk.LAUNCHES.values()) == 0
    _close(got, ref)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh,q,orth", [(True, 3, "ns"), (True, 1, "ns"),
                                            (True, 3, "qr"), (True, 1, "qr"),
                                            (False, 1, "ns")])
def test_plain_bond_matches_xla_complex_route(forward, refresh, q, orth):
    x = _bond(20 + q + 2 * refresh + (orth == "qr"))
    ops = _single(x, forward)
    got = bkc.bond_step_c(*_torch(ops), 0.05, 1e-10, forward=forward,
                          refresh=refresh, power_iters=q, orth=orth)
    _close(got, _xla_bond(ops, forward, refresh, q, orth))
    # the emitted core is an isometry on its kept directions
    U = got[1].reshape(CHI * D, CHI) if forward else \
        got[1].reshape(CHI, D * CHI).T
    np.testing.assert_allclose((U.conj().T @ U).numpy(), np.eye(CHI),
                               atol=1e-5)


def test_k1c_and_k2c_plain_split_the_xla_route():
    # K1c's bond tensor and Y before the QR, then K2c against that Q: the
    # two halves of the XLA route's refresh bond, at max_rank 4
    x = _bond(41)
    A, center, le, re, ls, phil, phir, y1h, w, V0 = _torch(_single(x, False))
    BT, Y = bkc.k1c_plain(A, center, le, re, phil, phir, y1h, w, V0, 0.05,
                          forward=False, power_iters=3)
    BTj = jnp.einsum("aim,cmkb->aikbc", *(jnp.asarray(o) for o in
                                          (x["A"][0], x["center"])))
    _, BTj = jax_update(BTj, *(jnp.asarray(o) for o in (
        x["envx"][0], x["env0"], x["phil"][0].conj(), x["phir"][0].conj(),
        x["y1h"], x["w"])), jnp.zeros(N, jnp.float32), eta=jnp.float32(0.05))
    np.testing.assert_allclose(
        BT.numpy(), np.asarray(BTj).transpose(4, 0, 1, 2, 3).reshape(
            C, CHI * D, D, CHI), rtol=RTOL, atol=ATOL)
    assert torch.allclose(torch.linalg.vector_norm(Y, dim=0),
                          torch.ones(CHI), atol=1e-6)
    Q = tdec._qr_orth(Y)
    got = bkc.k2c_plain(BT, Q, re, ls, phir, 1e-10, forward=False,
                        max_rank=4)
    M = BTj.transpose(0, 1, 4, 2, 3).reshape(CHI * D * C, D * CHI)
    US, Vh, _ = jdec.warm_split_left(M, jnp.asarray(Q.numpy()), CHI,
                                     jnp.float32(1e-10), refresh=False,
                                     max_rank=4)
    core = Vh.reshape(CHI, D, CHI)
    env2, ls2 = env_step_right_scaled(jnp.asarray(x["env0"]),
                                      jnp.asarray(x["ls0"]), core,
                                      jnp.asarray(x["phir"][0]))
    _close(got, (jnp.moveaxis(US.reshape(CHI, D, C, CHI), 2, 0), core,
                 env2, ls2))
    assert int((got[1] != 0).any(dim=-1).any(dim=-1).sum()) == 4


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh,q", [(True, 1), (False, 1)])
def test_k12mc_plain_is_chained_k12c_plain(forward, refresh, q):
    # tests/test_pallas_bond_c.py:170-238's block contract, at its
    # tolerance: the block equals Bb = 3 chained single bonds
    x = _bond(51, Bb=3)
    blk = _torch(x[k] for k in ("A", "center", "envx", "env0", "ls0", "phil",
                                "phir", "y1h", "w", "V0"))
    kw = dict(forward=forward, refresh=refresh, power_iters=q)
    bk.reset_counts()
    center2, core_b, env_b, ls_b, q_b = bkc.bond_block_steps_c(
        *blk, 0.05, 1e-10, orth="ns", **kw)
    assert bk.PLAIN_CALLS["k12mc"] == 1
    center, env, ls = blk[1], blk[3], blk[4]
    for b in range(3):
        le, re = (env, blk[2][b]) if forward else (blk[2][b], env)
        center, core, env, ls, Q = bkc.k12c_plain(
            blk[0][b], center, le, re, ls, blk[5][b], blk[6][b], blk[7],
            blk[8], blk[9][b], 0.05, 1e-10, **kw)
        for got, want in ((core_b[b], core), (env_b[b], env),
                          (ls_b[b], ls), (q_b[b], Q)):
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(center2, center, rtol=2e-5, atol=2e-6)


def test_complex_cutoff_tie_break_keeps_the_stable_order():
    # the degenerate frozen bond of tests/test_torch_bond_kernels.py with a
    # phase on every operand: the energies are |.|^2, so they tie as in the
    # real case and the lower indices of the tied 2.0s survive
    chi, d, Cc, Nn = 6, 2, 1, 4
    w = np.array([4.0, 2.0, 2.0, 2.0, 1.0, 0.5])
    A = np.zeros((chi, d, chi), np.complex64)
    A.reshape(chi * d, chi)[:chi] = np.eye(chi) * np.exp(0.3j)
    center = np.zeros((Cc, chi, d, chi), np.complex64)
    center[0, :, 0, :] = np.diag(np.sqrt(w)) * np.exp(-1.1j)
    V0 = np.zeros((d * chi, chi), np.complex64)
    V0[:chi] = np.eye(chi)
    env = np.zeros((Nn, chi), np.complex64)
    env[:, 0] = np.exp(0.7j)
    phi = np.full((Nn, d), 0.5 * np.exp(-0.2j), np.complex64)
    ops = _torch((A, center, env, env, np.zeros(Nn, np.float32), phi, phi,
                  np.ones((Nn, Cc), np.float32),
                  np.full(Nn, 1.0 / Nn, np.float32), V0))
    cutoff = float(np.float32(4.5 / w.sum()))
    got = bkc.bond_step_c(*ops, 0.0, cutoff, forward=False, refresh=False,
                          orth="ns")
    kept = (got[1] != 0).any(dim=-1).any(dim=-1).tolist()
    assert kept == [True, True, True, False, False, False]


def test_qr_orth_complex_matches_jax_at_full_rank():
    rng = np.random.default_rng(61)
    Y = rng.standard_normal((18, 6)) + 1j * rng.standard_normal((18, 6))
    Q = tdec._qr_orth(torch.from_numpy(Y))
    np.testing.assert_allclose(Q.numpy(), np.asarray(jdec._qr_orth(
        jnp.asarray(Y))), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose((Q.conj().T @ Q).numpy(), np.eye(6),
                               atol=1e-12)


def test_qr_orth_complex_on_a_rank_deficient_y_keeps_the_invariants():
    # ROADMAP.md queue 3: the fill-in of a deficient tail is rounding's and
    # differs between LAPACK builds; the leading columns (a nested QR) and
    # the span are what both packages share
    rng = np.random.default_rng(62)
    Y = rng.standard_normal((18, 6)) + 1j * rng.standard_normal((18, 6))
    Y[:, 4:] = Y[:, :2] @ (rng.standard_normal((2, 2)) + 1j)
    Q = tdec._qr_orth(torch.from_numpy(Y))
    Qj = np.asarray(jdec._qr_orth(jnp.asarray(Y)))
    np.testing.assert_allclose(Q[:, :4].numpy(), Qj[:, :4], rtol=1e-12,
                               atol=1e-12)
    Yt = torch.from_numpy(Y)
    np.testing.assert_allclose((Q @ (Q.conj().T @ Yt)).numpy(), Y,
                               atol=1e-12)
    np.testing.assert_allclose((Q[:, :4].conj().T @ Q[:, :4]).numpy(),
                               np.eye(4), atol=1e-12)


def test_complex_routes_refuse_what_they_do_not_cover():
    x = _bond(71)
    ops = _torch(_single(x, False))
    # the batch-tiled route runs (K1c-grad per tile, K1c-update, K2c-split,
    # K2c-env per tile; held against JAX in tests/test_torch_complex_dp.py);
    # the data-parallel one is bond_step_c_dp, so axis_name is refused
    bk.reset_counts()
    bkc.bond_step_c(*ops, 0.05, 1e-10, forward=False, stream_tile=4)
    assert {k: v for k, v in bk.PLAIN_CALLS.items() if v} == {
        "k1c_grad": 3, "k1c_update": 1, "k2c_split": 1, "k2c_env": 3}
    with pytest.raises(ValueError, match="bond_step_c_dp"):
        bkc.bond_step_c(*ops, 0.05, 1e-10, forward=False, axis_name="dp")
    # the kernel wrappers refuse another loss or optimiser before launching
    A, center, le, re, ls, phil, phir, y1h, w, V0 = ops
    for kw in (dict(loss="MSE"), dict(bbopt="GD")):
        with pytest.raises(ValueError, match="KLD \\+ TSGO"):
            bkc.k12c_cuda(*ops, 0.05, 1e-10, forward=False, **kw)
        with pytest.raises(ValueError, match="KLD \\+ TSGO"):
            bkc.k1c_cuda(A, center, le, re, phil, phir, y1h, w, V0, 0.05,
                         forward=False, **kw)
    blk = _torch(_bond(72, Bb=2)[k] for k in (
        "A", "center", "envx", "env0", "ls0", "phil", "phir", "y1h", "w",
        "V0"))
    with pytest.raises(ValueError, match="Newton-Schulz"):
        bkc.bond_block_steps_c(*blk, 0.05, 1e-10, forward=False, orth="qr")


def test_launch_checks_complex_operands_before_launching():
    blk = list(_torch(_bond(81, Bb=2)[k] for k in (
        "A", "center", "envx", "env0", "ls0", "phil", "phir", "y1h", "w",
        "V0")))
    calls = []

    def run(args):
        return bk._launch_k12m(*args[:5], None, *args[5:], 0.05, 1e-10,
                               forward=True, refresh=True, power_iters=3,
                               max_rank=None, loss="KLD", bbopt="TSGO",
                               launch=lambda *p: calls.append(p),
                               workspace_floats=lambda *s: 16,
                               dtype=torch.complex64)

    out = run(blk)
    assert len(calls) == 1 and len(calls[0]) == 30
    assert [o.dtype for o in out] == [torch.complex64] * 3 + [
        torch.float32, torch.complex64]
    bad = list(blk)
    bad[3] = bad[3].to(torch.complex128)
    with pytest.raises(ValueError, match="env0 must be complex64"):
        run(bad)
    bad = list(blk)
    bad[7] = bad[7].to(torch.complex64)
    with pytest.raises(ValueError, match="y1h must be float32"):
        run(bad)
    assert len(calls) == 1


def test_k12mc_plain_matches_pallas_k12mc(interpret):
    # a frozen block of 3 (the qr fit's frozen sweeps), forward
    x = _bond(91, Bb=3)
    keys = ("A", "center", "envx", "env0", "ls0", "phil", "phir", "y1h", "w",
            "V0")
    ref = pallas_bond_c.bond_block_steps_c(
        *(_pair(x[k]) for k in keys), jnp.float32(0.05), jnp.float32(1e-10),
        forward=True, refresh=False, power_iters=1, orth="qr")
    got = bkc.bond_block_steps_c(*_torch(x[k] for k in keys), 0.05, 1e-10,
                                 forward=True, refresh=False, orth="qr")
    _close(got, ref)


# ---- the cluster K1c and K1c-update: argument checks and entry points -------

def _no_library(monkeypatch):
    """Make any load of the kernel library fail the test."""
    from mpstime_tpu_torch.kernels import build

    def load_library():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(build, "load_library", load_library)


def _k1c_ops(key, forward=False):
    """K1c's operands, or K1c-update's with the plain K1c-grad gradient."""
    A, center, le, re, ls, phil, phir, y1h, w, V0 = _torch(
        _single(_bond(95), forward))
    if key == "k1c":
        return (A, center, le, re, phil, phir, y1h, w, V0, 0.05)
    G = bkc.k1c_grad_plain(A, center, le, re, phil, phir, y1h, w, ls,
                           forward=forward)
    return (A, center, G, V0, 0.05)


def _k1a_ops(key):
    """K1c-grad's operands, or K1a's (their real parts) with the log-scales
    as gls."""
    x = _bond(97)
    if key == "k1a":
        x = {k: np.ascontiguousarray(v.real) for k, v in x.items()}
    A, center, le, re, ls, phil, phir, y1h, w, _ = _torch(_single(x, False))
    return (A, center, le, re, phil, phir, y1h, w, ls)


def _k1_ops(key):
    """K1's real operands (the log-scales as gls), or K1b's with the plain
    K1a gradient of the same inputs."""
    x = {k: np.ascontiguousarray(v.real) for k, v in _bond(98).items()}
    A, center, le, re, ls, phil, phir, y1h, w, V0 = _torch(_single(x, False))
    if key == "k1":
        return (A, center, le, re, phil, phir, y1h, w, ls, V0, 0.05)
    G = bk.k1a_plain(A, center, le, re, phil, phir, y1h, w, ls,
                     forward=False)
    return (A, center, G, V0, 0.05)


def _k2_ops(key):
    """K2's (K2c's) operands from the plain K1 (K1c) of the same inputs and
    the QR of its Y, (BT, Q, env, env_ls, phi, cutoff) backward, or
    K2-split's (K2c-split's) (BT, Q, cutoff); real for the real kernels."""
    x = _bond(99)
    real = not key.startswith("k2c")
    if real:
        x = {k: np.ascontiguousarray(v.real) for k, v in x.items()}
    A, center, le, re, ls, phil, phir, y1h, w, V0 = _torch(_single(x, False))
    if real:
        BT, Y = bk.k1_plain(A, center, le, re, phil, phir, y1h, w, ls, V0,
                            0.05, forward=False)
    else:
        BT, Y = bkc.k1c_plain(A, center, le, re, phil, phir, y1h, w, V0,
                              0.05, forward=False)
    Q = tdec._qr_orth(Y).contiguous()
    if key.endswith("_split"):
        return (BT, Q, 1e-10)
    return (BT, Q, re, ls, phir, 1e-10)


def _k12_ops(key):
    """A bond's operands (K12c, K12cr) or a block of 2 bonds' (K12m,
    K12mc), complex, or real for the real K12m."""
    x = _bond(96, Bb=1 if key in ("k12c", "k12cr") else 2)
    if key == "k12m":
        x = {k: np.ascontiguousarray(v.real) for k, v in x.items()}
    if key in ("k12m", "k12mc"):
        return _torch(x[k] for k in ("A", "center", "envx", "env0", "ls0",
                                     "phil", "phir", "y1h", "w", "V0"))
    return _torch(_single(x, False))


def _k12m_raw(ops):
    """A block's operands in the launch helpers' order (opp_ls None, eta,
    cutoff)."""
    return ops[:5] + (None,) + ops[5:] + (0.05, 1e-10)


#: The keywords of a raw K12m / K12mc launch.
RAW_KW = dict(forward=False, refresh=True, power_iters=1, max_rank=None)

#: Each cluster wrapper (and the K12m / K12mc cluster launches the checks at
#: other sizes call) and how it is called with a cluster size.
CLUSTER_CALLS = {
    "k1c": lambda n: bkc.k1c_cuda(*_k1c_ops("k1c"), forward=False,
                                  cluster=n),
    "k1c_update": lambda n: bkc.k1c_update_cuda(*_k1c_ops("k1c_update"),
                                                forward=False, cluster=n),
    "k1a": lambda n: bk.k1a_cuda(*_k1a_ops("k1a"), forward=False, cluster=n),
    "k1c_grad": lambda n: bkc.k1c_grad_cuda(*_k1a_ops("k1c_grad"),
                                            forward=False, cluster=n),
    "k1": lambda n: bk.k1_cuda(*_k1_ops("k1"), forward=False, cluster=n),
    "k1b": lambda n: bk.k1b_cuda(*_k1_ops("k1b"), forward=False, cluster=n),
    "k2": lambda n: bk.k2_cuda(*_k2_ops("k2"), forward=False, cluster=n),
    "k2_split": lambda n: bk.k2_split_cuda(*_k2_ops("k2_split"),
                                           forward=False, cluster=n),
    "k2c": lambda n: bkc.k2c_cuda(*_k2_ops("k2c"), forward=False, cluster=n),
    "k2c_split": lambda n: bkc.k2c_split_cuda(*_k2_ops("k2c_split"),
                                              forward=False, cluster=n),
    "occupancy": lambda n: bkc.cluster_occupancy("k1c", n, CHI),
    "k12c": lambda n: bkc.k12c_cuda(*_k12_ops("k12c"), 0.05, 1e-10,
                                    forward=False, cluster=n),
    "k12cr": lambda n: bkc.k12cr_cuda(*_k12_ops("k12cr"), 0.05, 1e-10,
                                      forward=False, cluster=n),
    "k12m": lambda n: bk._k12m_cluster(n, *_k12m_raw(_k12_ops("k12m")),
                                       loss="KLD", bbopt="TSGO", **RAW_KW),
    "k12mc": lambda n: bkc._k12mc_cluster(
        n, *_k12m_raw(_k12_ops("k12mc")), **RAW_KW),
}


@pytest.mark.parametrize("cluster", [0, 17, 32, 4.0, "8", True])
@pytest.mark.parametrize("call", list(CLUSTER_CALLS))
def test_cluster_sizes_are_checked_before_the_library_loads(monkeypatch,
                                                            call, cluster):
    _no_library(monkeypatch)
    bk.reset_counts()
    with pytest.raises(ValueError, match="from 1 to 16"):
        CLUSTER_CALLS[call](cluster)
    assert sum(bk.LAUNCHES.values()) == 0


def test_cluster_occupancy_names_its_kernel(monkeypatch):
    _no_library(monkeypatch)
    assert bkc.CLUSTER_KERNELS == ("k12c", "k12cr", "k1c", "k1c_update",
                                   "k12m", "k12mc", "k1a", "k1c_grad",
                                   "k1", "k1b", "k2", "k2_split", "k2c",
                                   "k2c_split")
    with pytest.raises(ValueError, match="one of"):
        bkc.cluster_occupancy("k12m_block", 4, CHI)


def test_default_cluster_sizes_lie_in_range():
    assert bkc.MAX_CLUSTER == bk.MAX_CLUSTER == 16
    assert bkc._cluster_size is bk._cluster_size
    assert bkc.cluster_occupancy is bk.cluster_occupancy
    for n in (bkc.CLUSTER, bkc.K1C_CLUSTER, bkc.K1C_UPDATE_CLUSTER,
              bkc.K12MC_CLUSTER, bk.K12M_CLUSTER, bk.K1A_CLUSTER,
              bkc.K1C_GRAD_CLUSTER, bk.K1_CLUSTER, bk.K1B_CLUSTER,
              bk.K2_CLUSTER, bk.K2_SPLIT_CLUSTER, bkc.K2C_CLUSTER,
              bkc.K2C_SPLIT_CLUSTER):
        assert type(n) is int and 1 <= n <= bkc.MAX_CLUSTER


@pytest.mark.parametrize("cluster", [None, 1, 8])
@pytest.mark.parametrize("key", ["k1c", "k1c_update"])
def test_k1c_wrappers_launch_the_cluster_entry(monkeypatch, key, cluster):
    """k1c_cuda / k1c_update_cuda launch the cluster entry with the one-block
    entry's arguments and the cluster size (default K1C_CLUSTER /
    K1C_UPDATE_CLUSTER), counted under the kernel's name; the one-block
    wrappers launch the one-block entry, counted apart.  The dp route's
    K1b piece is the cluster wrapper."""
    calls = []

    def launcher(device, entry):
        return (lambda *args: calls.append((entry, args))), (lambda *s: 16)

    monkeypatch.setattr(bkc, "_launcher", launcher)
    ops = _k1c_ops(key)
    if key == "k1c":
        cuda, block, n_in = bkc.k1c_cuda, bkc.k1c_block_cuda, 10
        default = bkc.K1C_CLUSTER
    else:
        cuda, block, n_in = bkc.k1c_update_cuda, bkc.k1c_update_block_cuda, 4
        default = bkc.K1C_UPDATE_CLUSTER
        assert bkc.PIECES["k1b"][2] is cuda
    kw = dict(forward=False, power_iters=3, orth="ns")
    bk.reset_counts()
    BT, Y = cuda(*ops, cluster=cluster, **kw)
    block(*ops, **kw)
    assert BT.shape == (C, CHI * D, D, CHI) and Y.shape == (CHI * D, CHI)
    assert BT.dtype == Y.dtype == torch.complex64
    (e1, a1), (e2, a2) = calls
    assert (e1, e2) == (f"mpst_{key}_cluster_launch", f"mpst_{key}_launch")
    assert a1[:n_in] == a2[:n_in]                  # the same operands
    assert a1[n_in + 3:-1] == a2[n_in + 3:]        # the same sizes and flags
    assert a1[-1] == (default if cluster is None else cluster)
    assert {k: v for k, v in bk.LAUNCHES.items() if v} == {
        key: 1, f"{key}_block": 1}


@pytest.mark.parametrize("cluster", [None, 1, 8])
@pytest.mark.parametrize("key", ["k1a", "k1c_grad"])
def test_k1a_wrappers_launch_the_cluster_entry(monkeypatch, key, cluster):
    """k1a_cuda / k1c_grad_cuda launch the cluster entry with the one-block
    entry's arguments and the cluster size (default K1A_CLUSTER /
    K1C_GRAD_CLUSTER), counted under the kernel's name; the one-block
    wrappers launch the one-block entry, counted apart.  The dp route's K1a
    piece is the cluster wrapper, real and complex."""
    calls = []

    def launcher(device, entry, workspace=None):
        return (lambda *args: calls.append((entry, args))), (lambda *s: 16)

    ops = _k1a_ops(key)
    if key == "k1a":
        monkeypatch.setattr(bk, "_cuda_launch", launcher)
        cuda, block, default = bk.k1a_cuda, bk.k1a_block_cuda, bk.K1A_CLUSTER
        kw = dict(forward=True, loss="MSE")
        assert bk._PIECES["k1a"][2] is cuda
    else:
        monkeypatch.setattr(bkc, "_launcher", launcher)
        cuda, block = bkc.k1c_grad_cuda, bkc.k1c_grad_block_cuda
        default, kw = bkc.K1C_GRAD_CLUSTER, dict(forward=True)
        assert bkc.PIECES["k1a"][2] is cuda
    bk.reset_counts()
    G = cuda(*ops, cluster=cluster, **kw)
    block(*ops, **kw)
    assert G.shape == (C, CHI * D, D, CHI) and G.dtype == ops[1].dtype
    (e1, a1), (e2, a2) = calls
    assert (e1, e2) == (f"mpst_{key}_cluster_launch", f"mpst_{key}_launch")
    assert a1[:9] == a2[:9]                        # the same operands
    assert (a1[4] is not None) == (key == "k1a")   # gls, MSE only
    assert a1[11:-1] == a2[11:]                    # the same sizes and flags
    assert a1[-2:] == (int(key == "k1a"), default if cluster is None
                       else cluster)               # mse, cluster size
    assert {k: v for k, v in bk.LAUNCHES.items() if v} == {
        key: 1, f"{key}_block": 1}


@pytest.mark.parametrize("cluster", [None, 1, 8])
@pytest.mark.parametrize("key", ["k1", "k1b"])
def test_k1_wrappers_launch_the_cluster_entry(monkeypatch, key, cluster):
    """k1_cuda / k1b_cuda launch the cluster entry with the one-block
    entry's arguments and the cluster size (default K1_CLUSTER /
    K1B_CLUSTER), MSE and GD passed through, counted under the kernel's
    name; the one-block wrappers launch the one-block entry, counted apart.
    The dp route's K1b piece is the cluster wrapper."""
    calls = []

    def launcher(device, entry, workspace=None):
        return (lambda *args: calls.append((entry, args))), (lambda *s: 16)

    monkeypatch.setattr(bk, "_cuda_launch", launcher)
    ops = _k1_ops(key)
    if key == "k1":
        cuda, block, default = bk.k1_cuda, bk.k1_block_cuda, bk.K1_CLUSTER
        kw = dict(forward=True, power_iters=3, orth="ns", loss="MSE",
                  bbopt="GD")
        n_in, n_ptr, flags = 10, 13, slice(21, 23)     # mse, gd
    else:
        cuda, block, default = bk.k1b_cuda, bk.k1b_block_cuda, bk.K1B_CLUSTER
        kw = dict(forward=True, power_iters=3, orth="ns", bbopt="GD")
        n_in, n_ptr, flags = 4, 7, slice(14, 15)       # gd
        assert bk._PIECES["k1b"][2] is cuda
    bk.reset_counts()
    BT, Y = cuda(*ops, cluster=cluster, **kw)
    block(*ops, **kw)
    assert BT.shape == (C, CHI * D, D, CHI) and Y.shape == (CHI * D, CHI)
    assert BT.dtype == Y.dtype == torch.float32
    (e1, a1), (e2, a2) = calls
    assert (e1, e2) == (f"mpst_{key}_cluster_launch", f"mpst_{key}_launch")
    assert a1[:n_in] == a2[:n_in]                  # the same operands
    if key == "k1":
        assert a1[4] is not None                   # gls, for MSE
    assert a1[n_ptr:-1] == a2[n_ptr:]              # the same sizes and flags
    assert all(f == 1 for f in a1[flags])          # MSE and GD passed on
    assert a1[-1] == (default if cluster is None else cluster)
    assert {k: v for k, v in bk.LAUNCHES.items() if v} == {
        key: 1, f"{key}_block": 1}


@pytest.mark.parametrize("cluster", [None, 1, 8])
@pytest.mark.parametrize("key", ["k2", "k2_split", "k2c", "k2c_split"])
def test_k2_wrappers_launch_the_cluster_entry(monkeypatch, key, cluster):
    """k2_cuda / k2_split_cuda / k2c_cuda / k2c_split_cuda launch the
    cluster entry with the one-block entry's operands, sizes and flags and
    the cluster size (default K2_CLUSTER / K2_SPLIT_CLUSTER / K2C_CLUSTER /
    K2C_SPLIT_CLUSTER), counted under the kernel's name; the one-block
    wrappers launch the one-block entry, counted apart.  The dp route's
    K2-split piece is the cluster wrapper, real and complex."""
    calls = []

    def launcher(device, entry, workspace=None):
        return (lambda *args: calls.append((entry, args))), (lambda *s: 16)

    cplx, split = key.startswith("k2c"), key.endswith("_split")
    mod = bkc if cplx else bk
    monkeypatch.setattr(mod, "_launcher" if cplx else "_cuda_launch",
                        launcher)
    cuda, block = getattr(mod, f"{key}_cuda"), getattr(mod, f"{key}_block_cuda")
    default = getattr(mod, f"{key.upper()}_CLUSTER")
    assert (bkc.PIECES if cplx else bk._PIECES)["k2_split"][2] is (
        bkc.k2c_split_cuda if cplx else bk.k2_split_cuda)
    ops = _k2_ops(key)
    kw = dict(forward=True, max_rank=4)
    bk.reset_counts()
    out = cuda(*ops, cluster=cluster, **kw)
    block(*ops, **kw)
    assert out[0].shape == (C, CHI, D, CHI) and out[1].shape == (CHI, D, CHI)
    assert out[-1].shape == ((CHI * D, CHI) if split else (N,))
    assert out[0].dtype == (torch.complex64 if cplx else torch.float32)
    (e1, a1), (e2, a2) = calls
    assert (e1, e2) == (f"mpst_{key}_cluster_launch", f"mpst_{key}_launch")
    n_in, n_ptr = (2, 6) if split else (5, 10)
    assert a1[:n_in] == a2[:n_in]                  # the same operands
    assert a1[n_ptr:-1] == a2[n_ptr:]              # the same sizes and flags
    assert a1[-4:-1] == (1, 1e-10, 4.0)            # forward, cutoff, max_rank
    assert a1[-1] == (default if cluster is None else cluster)
    assert {k: v for k, v in bk.LAUNCHES.items() if v} == {
        key: 1, f"{key}_block": 1}


# ---- K2-env and K2c-env over row tiles: entry points -------------------------

def _record_env_launches(monkeypatch, cplx):
    """Replace K2-env's (K2c-env's) launcher with one that records (entry,
    C arguments) and launches nothing."""
    calls = []

    def launcher(device, entry, workspace=None):
        return (lambda *args: calls.append((entry, args))), (lambda *s: 16)

    monkeypatch.setattr(bkc if cplx else bk,
                        "_launcher" if cplx else "_cuda_launch", launcher)
    return calls


def _env_ops(cplx):
    """K2-env's (K2c-env's) operands, backward: an isometry (the basis of
    _k2_ops' bond), the advancing environment, log-scales and features."""
    _, Q, env, ls, phi, _ = _k2_ops("k2c" if cplx else "k2")
    return Q, env, ls, phi


@pytest.mark.parametrize("rows", [None, 1, 32])
@pytest.mark.parametrize("key", ["k2_env", "k2c_env"])
def test_env_wrappers_launch_the_row_tile_entry(monkeypatch, key, rows):
    """k2_env_cuda / k2c_env_cuda launch the row-tile entry with the
    one-block entry's operands, sizes and direction, the rows a block
    (default K2_ENV_ROWS / K2C_ENV_ROWS) and staging on, counted under the
    kernel's name;
    the one-block wrappers launch the one-block entry, counted apart.  The
    dp route's K2-env piece is the row-tile wrapper, real and complex."""
    cplx = key == "k2c_env"
    mod = bkc if cplx else bk
    calls = _record_env_launches(monkeypatch, cplx)
    cuda, block = getattr(mod, f"{key}_cuda"), getattr(mod, f"{key}_block_cuda")
    default = bkc.K2C_ENV_ROWS if cplx else bk.K2_ENV_ROWS
    assert (bkc.PIECES if cplx else bk._PIECES)["k2_env"][2] is cuda
    ops = _env_ops(cplx)
    bk.reset_counts()
    out = cuda(*ops, forward=True, rows=rows)
    block(*ops, forward=True)
    assert out[0].shape == (N, CHI) and out[1].shape == (N,)
    assert out[0].dtype == (torch.complex64 if cplx else torch.float32)
    assert out[1].dtype == torch.float32
    (e1, a1), (e2, a2) = calls
    assert (e1, e2) == (f"mpst_{key}_rows_launch", f"mpst_{key}_launch")
    assert a1[:4] == a2[:4] == tuple(t.data_ptr() for t in ops)
    assert a1[7:-2] == a2[7:] == (CHI, D, N, 1)    # chi, d, N, forward
    assert a1[-2:] == (default if rows is None else rows, 1)   # rows, staged
    assert {k: v for k, v in bk.LAUNCHES.items() if v} == {
        key: 1, f"{key}_block": 1}


@pytest.mark.parametrize("rows", [0, -3, bk.MAX_ENV_ROWS + 1, 8.0, True])
def test_env_wrappers_refuse_rows_out_of_range(monkeypatch, rows):
    """A row count outside 1-MAX_ENV_ROWS, or not an integer, raises
    ValueError before the library is asked for an entry; nothing counts."""
    asked = []
    monkeypatch.setattr(bk, "_cuda_launch", lambda *a: asked.append(a))
    monkeypatch.setattr(bkc, "_launcher", lambda *a: asked.append(a))
    bk.reset_counts()
    for cplx, cuda in ((False, bk.k2_env_cuda), (True, bkc.k2c_env_cuda)):
        with pytest.raises(ValueError, match="rows must be an integer"):
            cuda(*_env_ops(cplx), forward=False, rows=rows)
    assert asked == [] and not any(bk.LAUNCHES.values())


def test_env_rows_defaults_lie_in_range():
    """The default rows a block are among the sizes the card timed."""
    for rows in (bk.K2_ENV_ROWS, bkc.K2C_ENV_ROWS):
        assert rows in (1, 2, 4, 8, 16, 32)
        assert bk._env_rows(rows) == rows
    assert bkc.MAX_ENV_ROWS == bk.MAX_ENV_ROWS == 512


# ---- the cluster K12mc: entry points ----------------------------------------

def _record_launches(monkeypatch):
    """Replace the complex kernels' launcher with one that records (entry,
    C arguments) and launches nothing."""
    calls = []

    def launcher(device, entry):
        return (lambda *args: calls.append((entry, args))), (lambda *s: 16)

    monkeypatch.setattr(bkc, "_launcher", launcher)
    return calls


@pytest.mark.parametrize("cluster", [None, 1, 8])
@pytest.mark.parametrize("key", ["k12mc", "k12c"])
def test_k12mc_wrapper_launches_the_cluster_entry(monkeypatch, key, cluster):
    """k12mc_cuda (cluster None; 1 and 8 through the cluster launch the
    checks at other sizes call) launches the cluster K12mc entry, and
    k12c_cuda (a bond, Bb = 1) its own, each with the one-block K12mc
    entry's arguments and the cluster size (default K12MC_CLUSTER /
    CLUSTER), counted under the kernel's name; k12mc_block_cuda launches
    the one-block entry, counted apart."""
    calls = _record_launches(monkeypatch)
    kw = dict(forward=True, refresh=False, power_iters=3, max_rank=4)
    bk.reset_counts()
    if key == "k12c":
        ops = _k12_ops("k12c")
        A, center, le, re, ls, phil, phir, y1h, w, V0 = ops
        out = bkc.k12c_cuda(*ops, 0.05, 1e-10, cluster=cluster, **kw)
        ops = (A[None], center, re[None], le, ls, phil[None], phir[None],
               y1h, w, V0[None])
        default = bkc.CLUSTER
    else:
        ops = _k12_ops("k12mc")
        out = (bkc.k12mc_cuda(*ops, 0.05, 1e-10, **kw) if cluster is None
               else bkc._k12mc_cluster(cluster, *_k12m_raw(ops), **kw))
        default = bkc.K12MC_CLUSTER
    bkc.k12mc_block_cuda(*ops, 0.05, 1e-10, **kw)
    assert [t.dtype for t in out] == [torch.complex64] * 3 + [
        torch.float32, torch.complex64]
    (e1, a1), (e2, a2) = calls
    assert (e1, e2) == ("mpst_k12c_launch" if key == "k12c" else
                        "mpst_k12mc_cluster_launch", "mpst_k12mc_launch")
    assert a1[:11] == a2[:11]                      # the same operands
    assert a1[17:-1] == a2[17:]                    # the same sizes and flags
    assert a1[17] == (1 if key == "k12c" else 2)   # Bb
    assert a1[-1] == (default if cluster is None else cluster)
    assert {k: v for k, v in bk.LAUNCHES.items() if v} == {
        **({key: 1} if key == "k12c" or cluster is None else {}),
        "k12mc_block": 1}


def test_bond_block_steps_c_on_the_card_reaches_the_cluster_k12mc(
        monkeypatch):
    calls = _record_launches(monkeypatch)
    monkeypatch.setattr(bk, "_device_of", lambda t: "cuda")
    bk.reset_counts()
    bkc.bond_block_steps_c(*_k12_ops("k12mc"), 0.05, 1e-10, forward=False,
                           refresh=False, orth="qr")
    assert [(e, a[-1]) for e, a in calls] == [
        ("mpst_k12mc_cluster_launch", bkc.K12MC_CLUSTER)]
    assert {k: v for k, v in bk.LAUNCHES.items() if v} == {"k12mc": 1}
    assert sum(bk.PLAIN_CALLS.values()) == 0

"""The port's split-tail bond route: the plain versions of K1-tail and
K1c-tail held against the JAX package's Pallas kernels ``_k1_tail_call`` /
``_k1c_tail_call`` (run in interpret mode, as tests/test_pallas_bond.py runs
them), ``bond_step(split_tail=True)``, ``bond_step_c(split_tail=True)`` and
the streamed steps against the JAX package's split-tail route (forced at
these tiny shapes with ``SPLIT_TAIL_FOOTPRINT = 0``, as
tests/test_pallas_bond.py:183-203 and tests/test_pallas_bond_c.py:143-167
force it), the split and fused plain routes bit for bit, the route rule
``SPLIT_TAIL_CHI`` through the sweep, and one float32 qr sweep against the
JAX package's Pallas fit on its split-tail route.  The CUDA kernels are held
against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: a tail or a bond at the per-bond bound rtol 1e-4 / atol 3e-5
(tests/test_pallas_bond.py:73-82, f32 reassociation); the complex streamed
step at rtol 2e-4 / atol 1e-5 (tests/test_pallas_bond_c.py:602, the tiles'
gradients sum in another order); the fit at tests/test_torch_qr_route.py's
rtol 1e-3 / atol 1e-4 with identical predictions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpstime_tpu as mj
import mpstime_tpu_torch as mt
from mpstime_tpu.ops import pallas_bond, pallas_bond_c
from mpstime_tpu.ops.decomp import warm_sketch_init as jax_sketch
from mpstime_tpu_torch.ops import bond_kernels as bk
from mpstime_tpu_torch.ops import bond_kernels_c as bkc
from mpstime_tpu_torch.parallel import Mesh

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 3e-5
STREAM_RTOL, STREAM_ATOL = 2e-4, 1e-5
C, CHI, D, N = 2, 6, 3, 12
NAMES = ("A", "center", "le", "re", "ls", "phil", "phir", "y1h", "w", "V0")


@pytest.fixture(scope="module")
def interpret():
    pallas_bond.set_interpret(True)
    jax.clear_caches()
    yield
    pallas_bond.set_interpret(False)
    jax.clear_caches()


@pytest.fixture(scope="module")
def jax_split_route(interpret):
    """The JAX package on its split-tail route at every refresh bond."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_bond, "SPLIT_TAIL_FOOTPRINT", 0)
        jax.clear_caches()
        yield
    jax.clear_caches()


def _bond(seed):
    """One float32 bond's operands (numpy), as tests/test_torch_qr_route.py
    makes them."""
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
        V0=np.asarray(jax_sketch(CHI * D, CHI, f32)))


def _bond_c(seed):
    """One complex64 bond's operands (numpy): unit environment rows and
    unit-modulus conjugated features, as tests/test_torch_complex_dp.py
    makes them."""
    rng = np.random.default_rng(seed)

    def c(*shape, scale=1.0):
        return (scale * (rng.standard_normal(shape)
                         + 1j * rng.standard_normal(shape))
                ).astype(np.complex64)

    def unit_rows():
        a = c(N, CHI)
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    def phi():
        th = rng.uniform(-np.pi, np.pi, (N, D))
        return (np.exp(-1j * th) / np.sqrt(D)).astype(np.complex64)

    return dict(
        A=c(CHI, D, CHI, scale=0.5), center=c(C, CHI, D, CHI, scale=0.5),
        le=unit_rows(), re=unit_rows(),
        ls=(0.3 * rng.standard_normal(N)).astype(np.float32),
        phil=phi(), phir=phi(),
        y1h=np.eye(C, dtype=np.float32)[rng.integers(0, C, N)],
        w=np.full(N, 1.0 / N, np.float32),
        V0=np.asarray(jax_sketch(CHI * D, CHI, np.complex64)))


def _stepped_bt(seed, dtype):
    """A stepped (unit-norm) bond tensor [C, chi*d, d, chi], as K1 leaves
    it for the tail."""
    rng = np.random.default_rng(seed)
    shape = (C, CHI * D, D, CHI)
    BT = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        BT = BT + 1j * rng.standard_normal(shape)
    return (BT / np.linalg.norm(BT)).astype(dtype)


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


def _counts():
    return {k: v for k, v in bk.PLAIN_CALLS.items() if v}


# ---------------------------------------------------------------- the tails

@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("orth", ["ns", "qr"])
@pytest.mark.parametrize("q", [1, 3])
def test_k1_tail_plain_matches_pallas_k1_tail(interpret, forward, orth, q):
    """Y after q power steps of a stored bond tensor: orthonormal under
    "ns", the column-normalised iterate under "qr"."""
    BT = _stepped_bt(1 + q + 2 * forward, np.float32)
    V0 = np.asarray(jax_sketch(CHI * D, CHI, np.float32))
    ref = pallas_bond._k1_tail_call(jnp.asarray(BT), jnp.asarray(V0), C=C,
                                    chi=CHI, d=D, forward=forward, q=q,
                                    orth=orth)
    got = bk.k1_tail_plain(_t(BT), _t(V0), forward=forward, power_iters=q,
                           orth=orth)
    assert got.shape == (CHI * D, CHI) and got.dtype == torch.float32
    _close([got], [ref])


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("orth", ["ns", "qr"])
@pytest.mark.parametrize("q", [1, 3])
def test_k1c_tail_plain_matches_pallas_k1c_tail(interpret, forward, orth, q):
    BT = _stepped_bt(11 + q + 2 * forward, np.complex64)
    V0 = np.asarray(jax_sketch(CHI * D, CHI, np.complex64))
    ref = pallas_bond_c._k1c_tail_call(_pair(BT), _pair(V0), C=C, chi=CHI,
                                       d=D, forward=forward, q=q, orth=orth)
    got = bkc.k1c_tail_plain(_t(BT), _t(V0), forward=forward, power_iters=q,
                             orth=orth)
    assert got.shape == (CHI * D, CHI) and got.dtype == torch.complex64
    _close([got], [ref])


def test_k1_tail_launch_checks_operands_before_launching():
    BT, V0 = _t(_stepped_bt(21, np.float32)), _t(_bond(21)["V0"])
    calls = []
    Y = bk._launch_k1_tail(BT, V0, forward=True, power_iters=3, orth="ns",
                           launch=lambda *p: calls.append(p),
                           workspace_floats=lambda *s: 16)
    assert Y.shape == (CHI * D, CHI) and Y.dtype == torch.float32
    assert len(calls[0]) == 10 and calls[0][4:] == (C, CHI, D, 1, 3, 0)
    assert calls[0][:2] == (BT.data_ptr(), V0.data_ptr())
    bad = dict(launch=None, workspace_floats=lambda *s: 16)
    with pytest.raises(ValueError, match="shape"):
        bk._launch_k1_tail(BT, V0[:, :3], forward=False, power_iters=1,
                           orth="qr", **bad)
    with pytest.raises(ValueError, match="complex64"):
        bk._launch_k1_tail(BT, V0, forward=False, power_iters=1, orth="qr",
                           dtype=torch.complex64, **bad)
    with pytest.raises(ValueError, match="contiguous"):
        bk._launch_k1_tail(BT, V0.T.contiguous().T, forward=False,
                           power_iters=1, orth="qr", **bad)
    with pytest.raises(ValueError, match="orth"):
        bk._launch_k1_tail(BT, V0, forward=False, power_iters=1, orth="tri",
                           **bad)
    assert len(calls) == 1


@pytest.mark.parametrize("blocks", [None, 1, 66, 500])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_tail_wrappers_launch_the_grid_entry(monkeypatch, cplx, blocks):
    """k1_tail_cuda / k1c_tail_cuda launch the cooperative-grid entry with
    the one-block entry's operands, sizes and flags and the grid size
    (default K1_TAIL_BLOCKS / K1C_TAIL_BLOCKS; one past what a card holds,
    500, is the card's to refuse), counted under the kernel's name; the
    one-block wrappers launch the one-block entry, counted apart.  The
    split tail's piece is the grid wrapper."""
    calls = []

    def launcher(device, entry, workspace=None):
        return (lambda *args: calls.append((entry, args))), (lambda *s: 16)

    mod = bkc if cplx else bk
    monkeypatch.setattr(mod, "_launcher" if cplx else "_cuda_launch",
                        launcher)
    key = "k1c_tail" if cplx else "k1_tail"
    cuda, block = getattr(mod, f"{key}_cuda"), getattr(mod, f"{key}_block_cuda")
    default = bkc.K1C_TAIL_BLOCKS if cplx else bk.K1_TAIL_BLOCKS
    assert (bkc.PIECES if cplx else bk._PIECES)["k1_tail"][2] is cuda
    dtype = np.complex64 if cplx else np.float32
    BT = _t(_stepped_bt(22, dtype))
    V0 = _t((_bond_c if cplx else _bond)(22)["V0"])
    kw = dict(forward=True, power_iters=3, orth="ns")
    bk.reset_counts()
    Y = cuda(BT, V0, blocks=blocks, **kw)
    block(BT, V0, **kw)
    assert Y.shape == (CHI * D, CHI) and Y.dtype == BT.dtype
    (e1, a1), (e2, a2) = calls
    assert (e1, e2) == (f"mpst_{key}_grid_launch", f"mpst_{key}_launch")
    assert a1[:2] == a2[:2] == (BT.data_ptr(), V0.data_ptr())
    assert a1[4:-1] == a2[4:] == (C, CHI, D, 1, 3, 0)  # sizes, flags
    assert a1[-1] == (default if blocks is None else blocks)
    assert {k: v for k, v in bk.LAUNCHES.items() if v} == {
        key: 1, f"{key}_block": 1}


@pytest.mark.parametrize("blocks", [0, -1, 2.5, True, "132"])
def test_tail_wrappers_refuse_a_grid_out_of_range(monkeypatch, blocks):
    """A grid size that is not a positive integer raises ValueError before
    the library is asked for an entry; nothing counts."""
    asked = []
    monkeypatch.setattr(bk, "_cuda_launch", lambda *a: asked.append(a))
    monkeypatch.setattr(bkc, "_launcher", lambda *a: asked.append(a))
    bk.reset_counts()
    for cplx, cuda in ((False, bk.k1_tail_cuda), (True, bkc.k1c_tail_cuda)):
        dtype = np.complex64 if cplx else np.float32
        BT = _t(_stepped_bt(23, dtype))
        V0 = _t((_bond_c if cplx else _bond)(23)["V0"])
        with pytest.raises(ValueError, match="blocks must be a positive"):
            cuda(BT, V0, forward=False, blocks=blocks)
    assert asked == [] and not any(bk.LAUNCHES.values())


def test_tail_grid_defaults_and_occupancy_query_names():
    """The default grids are among the sizes the card timed, and the
    occupancy query names its kernels before it loads the library."""
    for blocks in (bk.K1_TAIL_BLOCKS, bkc.K1C_TAIL_BLOCKS):
        assert blocks in (16, 32, 66, 132)
    assert bk.GRID_KERNELS == bkc.GRID_KERNELS == ("k1_tail", "k1c_tail")
    with pytest.raises(ValueError, match="kernel must be one of"):
        bk.grid_occupancy("k2_env")


# ------------------------------------------------------------- the routes

STEP_GRID = [(1, "ns", "KLD"), (3, "ns", "MSE"), (1, "qr", "MSE"),
             (3, "qr", "KLD")]


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("q,orth,loss", STEP_GRID)
def test_split_tail_bond_step_matches_jax(jax_split_route, forward, q, orth,
                                          loss):
    """K1 (emit_y=False) -> q K1-tail calls (-> QR) -> K2 against the JAX
    package's K1 -> _k1_tail_call chain -> K2 (pallas_bond.py:1320-1372).
    Y has full rank here, so the two QRs agree column for column."""
    x = _bond(31 + q + 2 * forward)
    kw = dict(forward=forward, refresh=True, power_iters=q, orth=orth,
              loss=loss)
    ref = pallas_bond.bond_step(*(jnp.asarray(x[k]) for k in NAMES),
                                jnp.float32(0.05), jnp.float32(1e-10),
                                opp_ls=jnp.asarray(x["opp"]), **kw)
    bk.reset_counts()
    got = bk.bond_step(*(_t(x[k]) for k in NAMES), 0.05, 1e-10,
                       opp_ls=_t(x["opp"]), split_tail=True, **kw)
    assert _counts() == {"k1": 1, "k1_tail": q, "k2": 1}
    _close(got, ref)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("orth", ["ns", "qr"])
def test_complex_split_tail_bond_step_matches_jax(jax_split_route, forward,
                                                  orth):
    """K1c (emit_y=False) -> 3 K1c-tail calls (-> realified QR) -> K2c
    against the JAX package's pair chain (pallas_bond_c.py:1363-1412)."""
    x = _bond_c(41 + 2 * forward)
    kw = dict(forward=forward, refresh=True, power_iters=3, orth=orth)
    ref = pallas_bond_c.bond_step_c(*(_pair(x[k]) for k in NAMES),
                                    jnp.float32(0.05), jnp.float32(1e-10),
                                    **kw)
    bk.reset_counts()
    got = bkc.bond_step_c(*(_t(x[k]) for k in NAMES), 0.05, 1e-10,
                          split_tail=True, **kw)
    assert _counts() == {"k1c": 1, "k1c_tail": 3, "k2c": 1}
    assert got[0].dtype == torch.complex64 and got[3].dtype == torch.float32
    _close(got, ref)


@pytest.mark.parametrize("cplx,forward,orth,q", [
    (False, False, "ns", 3), (True, True, "qr", 3)])
def test_streamed_split_tail_matches_jax_streamed(jax_split_route, cplx,
                                                  forward, orth, q):
    """12 rows in tiles of 5 (the last holds 2 rows and 3 pad rows): K1a
    per tile, one K1b without its power step, q K1-tail calls, K2-split,
    K2-env per tile, against JAX's streamed route with its tails
    (pallas_bond.py:1205-1214, pallas_bond_c.py:1274-1284).  This stands in
    for the dp chain, which shares the code."""
    kw = dict(forward=forward, refresh=True, power_iters=q, orth=orth)
    bk.reset_counts()
    if cplx:
        x = _bond_c(51 + 2 * forward)
        ref = pallas_bond_c.bond_step_c(*(_pair(x[k]) for k in NAMES),
                                        jnp.float32(0.05), jnp.float32(1e-10),
                                        stream_tile=5, **kw)
        got = bkc.bond_step_c(*(_t(x[k]) for k in NAMES), 0.05, 1e-10,
                              stream_tile=5, split_tail=True, **kw)
        assert _counts() == {"k1c_grad": 3, "k1c_update": 1, "k1c_tail": q,
                             "k2c_split": 1, "k2c_env": 3}
        _close(got, ref, rtol=STREAM_RTOL, atol=STREAM_ATOL)
    else:
        x = _bond(51 + 2 * forward)
        ref = pallas_bond.bond_step(*(jnp.asarray(x[k]) for k in NAMES),
                                    jnp.float32(0.05), jnp.float32(1e-10),
                                    stream_tile=5, **kw)
        got = bk.bond_step(*(_t(x[k]) for k in NAMES), 0.05, 1e-10,
                           stream_tile=5, split_tail=True, **kw)
        assert _counts() == {"k1a": 3, "k1b": 1, "k1_tail": q,
                             "k2_split": 1, "k2_env": 3}
        _close(got, ref)


def _dp(step, args, n, **kw):
    """``step`` (bond_step_dp or bond_step_c_dp) on Mesh(["cpu"] * n), its
    per-shard outputs joined."""
    out = step(Mesh(["cpu"] * n), [args[0]], [args[1]],
               *(list(t.chunk(n)) for t in args[2:9]), [args[9]], 0.05,
               1e-10, **kw)
    return (out[0][0], out[1][0], torch.cat(out[2]), torch.cat(out[3]),
            out[4][0])


ROUTES = {
    "bond_step": lambda a, **kw: bk.bond_step(*a, 0.05, 1e-10, **kw),
    "bond_step_c": lambda a, **kw: bkc.bond_step_c(*a, 0.05, 1e-10, **kw),
    "bond_step_dp": lambda a, **kw: _dp(bk.bond_step_dp, a, 2, **kw),
    "bond_step_c_dp": lambda a, **kw: _dp(bkc.bond_step_c_dp, a, 2, **kw),
    "stream": lambda a, **kw: bk.bond_step(*a, 0.05, 1e-10, stream_tile=5,
                                           **kw),
    "stream_c": lambda a, **kw: bkc.bond_step_c(*a, 0.05, 1e-10,
                                                stream_tile=5, **kw)}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("orth", ["ns", "qr"])
def test_split_and_fused_plain_routes_are_bitwise_equal(route, orth):
    """The chained tails do K1's in-kernel power steps, step by step: on
    every route the split tail changes no bit, at q 1 and 3, both
    directions; a frozen bond ignores split_tail (Q stays V0)."""
    cplx = route.endswith("_c") or route.endswith("_c_dp")
    x = _bond_c(61) if cplx else _bond(61)
    args = tuple(_t(x[k]) for k in NAMES)
    for forward in (False, True):
        for q in (1, 3):
            kw = dict(forward=forward, power_iters=q, orth=orth)
            fused = ROUTES[route](args, split_tail=False, **kw)
            bk.reset_counts()
            split = ROUTES[route](args, split_tail=True, **kw)
            assert bk.PLAIN_CALLS["k1c_tail" if cplx else "k1_tail"] == q
            for f, s in zip(fused, split):
                assert torch.equal(f, s)
    bk.reset_counts()
    frozen = ROUTES[route](args, forward=True, refresh=False, orth=orth,
                           split_tail=True)
    assert bk.PLAIN_CALLS["k1c_tail" if cplx else "k1_tail"] == 0
    assert torch.equal(frozen[4], args[9])


def test_split_tail_chi_selects_the_route(monkeypatch):
    """``split_tail=None`` reads SPLIT_TAIL_CHI: refresh bonds with chi >=
    it split, None never; an explicit split_tail wins."""
    monkeypatch.setattr(bk, "SPLIT_TAIL_CHI", None)
    assert not bk.splits_tail(10 ** 4) and bk.splits_tail(4, True)
    monkeypatch.setattr(bk, "SPLIT_TAIL_CHI", CHI + 1)
    assert not bk.splits_tail(CHI) and bk.splits_tail(CHI + 1)
    assert not bk.splits_tail(CHI + 1, False)
    args = tuple(_t(v) for v in (_bond(71)[k] for k in NAMES))
    for chi_min, want in ((CHI + 1, {"k12": 1}),
                          (CHI, {"k1": 1, "k1_tail": 1, "k2": 1})):
        monkeypatch.setattr(bk, "SPLIT_TAIL_CHI", chi_min)
        bk.reset_counts()
        bk.bond_step(*args, 0.05, 1e-10, forward=False, orth="ns")
        assert _counts() == want


# ---------------------------------------------------------------- the sweep

@pytest.fixture(scope="module")
def short(ecg200):
    Xtr, ytr, Xte, _ = ecg200
    return Xtr[:30, :8], ytr[:30], Xte[:40, :8]


@pytest.mark.parametrize("opts,tails", [
    (dict(), {"k1": 14, "k1_tail": 14, "k2": 14}),
    (dict(encoding="fourier"), {"k1c": 14, "k1c_tail": 42, "k2c": 14})],
    ids=["legendre", "fourier"])
def test_fit_runs_refresh_sweeps_bond_by_bond_on_the_split_tail(
        monkeypatch, short, opts, tails):
    """With SPLIT_TAIL_CHI = 0 a refresh sweep runs bond_step bond by bond
    (K1 -> K1-tail calls -> K2, q 1 real and 3 complex), a frozen sweep
    keeps its K12m / K12mc blocks, and the fit equals the default route's
    bit for bit (the plain versions do the same arithmetic)."""
    Xtr, ytr, Xte = short
    o = mt.MPSOptions(nsweeps=2, subspace_refresh_every=2, chi_max=4, d=3,
                      svd_alg="randomized_warm", orth_alg="ns", verbosity=-1,
                      log_level=-1, **opts)
    ref, _, _ = mt.fit_mps(Xtr, ytr, opts=o, device="cpu")
    monkeypatch.setattr(bk, "SPLIT_TAIL_CHI", 0)
    bk.reset_counts()
    got, _, _ = mt.fit_mps(Xtr, ytr, opts=o, device="cpu")
    block = "k12mc" if "encoding" in opts else "k12m"
    counts = _counts()
    assert counts.pop(block) > 0 and counts == tails
    assert torch.equal(got.mps.cores, ref.mps.cores)
    assert torch.equal(got.mps.center, ref.mps.center)
    np.testing.assert_array_equal(mt.classify(got, Xte), mt.classify(ref,
                                                                     Xte))


def test_f32_qr_fit_on_the_split_tail_matches_jax_pallas_fit(
        jax_split_route, monkeypatch, short):
    """One float32 qr sweep at T=8 through both packages' split-tail route
    (K1 -> K1-tail -> QR -> K2 per bond; JAX's Pallas kernels in interpret
    mode with SPLIT_TAIL_FOOTPRINT = 0), at tests/test_torch_qr_route.py's
    full-rank options and tolerances.  orth "qr" because JAX's sweep demotes
    "ns" to "qr" past the footprint (sweep.py:349-358), which the port
    does not."""
    Xtr, ytr, Xte = short
    opts = dict(chi_max=3, d=3, chi_init=3, verbosity=-1, log_level=-1,
                svd_alg="randomized_warm", orth_alg="qr", nsweeps=1,
                dtype="float32")
    jax.clear_caches()          # no sweep traced before the patch
    jf, _, _ = mj.fit_mps(Xtr, ytr, opts=mj.MPSOptions(**opts))
    monkeypatch.setattr(bk, "SPLIT_TAIL_CHI", 0)
    bk.reset_counts()
    tf, _, _ = mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(**opts), device="cpu")
    assert _counts() == {"k1": 14, "k1_tail": 14, "k2": 14}
    np.testing.assert_allclose(tf.mps.cores.numpy(), np.asarray(jf.mps.cores),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tf.mps.center.numpy(),
                               np.asarray(jf.mps.center), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_array_equal(mt.classify(tf, Xte), mj.classify(jf, Xte))

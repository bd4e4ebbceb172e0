"""The port's CUDA bond kernels (K12, K12m, K1, K2, the dp pieces K1a,
K1b, K2-split, K2-env, the complex K12c, K12mc, K1c, K2c, K12cr, the
complex dp pieces K1c-grad, K1c-update, K2c-split, K2c-env and the split
tails K1-tail, K1c-tail) held against their plain PyTorch versions on the
card, and the cluster kernels (K12c, K12cr, K1c, K1c-update, K1 and K1b,
one bond over a thread-block cluster; K12, K12m and K12mc, a block of
bonds; K1a and K1c-grad, one shard's gradient; K2, K2c, K2-split and
K2c-split, the split) held bit for bit against their one-block kernels and
across cluster sizes, and so the row-tile K2-env and K2c-env across rows a
block and the grid K1-tail and K1c-tail across grid sizes; the
imputation scan and the analysis sweeps on the card against the CPU; a
padded fit's launches and rank cap, save/load, MPSClassifier and a
two-thread DeviceFarm on one card; K12 and K12m at three classes, a
three-class fit from the UCR loader, and a profile_trace of a fit.
These tests need an NVIDIA GPU with nvcc and skip without one.
This file imports nothing of JAX, so it runs where JAX is not installed;
tests/conftest.py does import JAX, hence --noconftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

# the per-bond bound of tests/test_pallas_bond.py:73-82 (f32 reassociation)
RTOL, ATOL = 1e-4, 3e-5
SHAPE = dict(C=2, chi=25, d=5, N=100)      # the main path's bond shape


@pytest.fixture(scope="module")
def bk():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from mpstime_tpu_torch.kernels.build import load_library
    from mpstime_tpu_torch.ops import bond_kernels
    load_library()
    return bond_kernels


def _inputs(seed, Bb, C, chi, d, N):
    from mpstime_tpu_torch.ops.decomp import warm_sketch_init
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    return dict(
        A=t(rng.standard_normal((Bb, chi, d, chi))),
        center=t(rng.standard_normal((C, chi, d, chi))),
        envx=t(rng.standard_normal((Bb, N, chi))),
        env0=t(rng.standard_normal((N, chi))), ls0=t(rng.standard_normal(N)),
        opp=t(0.3 * rng.standard_normal(N)),
        phil=t(rng.uniform(-0.8, 0.8, (Bb, N, d))),
        phir=t(rng.uniform(-0.8, 0.8, (Bb, N, d))),
        y1h=t(np.eye(C)[rng.integers(0, C, N)]), w=t(np.full(N, 1.0 / N)),
        V0=torch.stack([warm_sketch_init(chi * d, chi, np.float32, "cuda")] * Bb))


def _single(x, forward):
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0], x["env0"])
    return (x["A"][0], x["center"], le, re, x["ls0"], x["phil"][0],
            x["phir"][0], x["y1h"], x["w"], x["V0"][0], 0.05, 1e-10)


def _block(x):
    return (x["A"], x["center"], x["envx"], x["env0"], x["ls0"], x["phil"],
            x["phir"], x["y1h"], x["w"], x["V0"], 0.05, 1e-10)


def _close(got, ref, rtol=RTOL, atol=ATOL):
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh,q,loss,bbopt,mr", [
    (True, 1, "KLD", "TSGO", None), (True, 3, "KLD", "TSGO", None),
    (False, 1, "KLD", "TSGO", None), (True, 1, "KLD", "GD", None),
    (True, 1, "MSE", "TSGO", None), (True, 1, "MSE", "GD", None),
    (True, 1, "KLD", "TSGO", 17)])
def test_k12_kernel_matches_plain(bk, forward, refresh, q, loss, bbopt, mr):
    x = _inputs(7, 1, **SHAPE)
    kw = dict(forward=forward, refresh=refresh, power_iters=q, max_rank=mr,
              loss=loss, bbopt=bbopt, opp_ls=x["opp"])
    n0 = bk.LAUNCHES["k12"]
    got = bk.bond_step(*_single(x, forward), orth="ns", **kw)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["k12"] == n0 + 1
    _close(got, bk.k12_plain(*_single(x, forward), **kw))


@pytest.mark.parametrize("Bb", [8, 7])
@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh", [True, False])
def test_k12m_kernel_matches_plain_and_chained_k12(bk, Bb, forward, refresh):
    x = _inputs(8, Bb, **SHAPE)
    kw = dict(forward=forward, refresh=refresh, power_iters=1)
    got = bk.bond_block_steps(*_block(x), **kw)
    torch.cuda.synchronize()
    _close(got, bk.k12m_plain(*_block(x), **kw))
    center, env, ls = x["center"], x["env0"], x["ls0"]
    for b in range(Bb):
        le, re = (env, x["envx"][b]) if forward else (x["envx"][b], env)
        center, core, env, ls, Q = bk.k12_cuda(
            x["A"][b], center, le, re, ls, x["phil"][b], x["phir"][b],
            x["y1h"], x["w"], x["V0"][b], 0.05, 1e-10, **kw)
        # one kernel: the block equals the chained single-bond launches
        _close((core, env, ls, Q), (got[1][b], got[2][b], got[3][b],
                                    got[4][b]), rtol=0, atol=1e-6)
    _close((center,), (got[0],), rtol=0, atol=1e-6)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("emit_y,q", [(True, 1), (True, 3), (False, 1)])
@pytest.mark.parametrize("loss,bbopt", [("KLD", "TSGO"), ("MSE", "GD")])
def test_k1_kernel_matches_plain(bk, forward, emit_y, q, loss, bbopt):
    x = _inputs(10, 1, **SHAPE)
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                       x["env0"])
    args = (x["A"][0], x["center"], le, re, x["phil"][0], x["phir"][0],
            x["y1h"], x["w"], x["ls0"] + x["opp"], x["V0"][0], 0.05)
    kw = dict(forward=forward, emit_y=emit_y, power_iters=q, orth="qr",
              loss=loss, bbopt=bbopt)
    n0 = bk.LAUNCHES["k1"]
    got = bk.k1_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["k1"] == n0 + 1
    _close(got, bk.k1_plain(*args, **kw))


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("mr", [None, 17])
def test_k2_kernel_matches_plain(bk, forward, mr):
    x = _inputs(11, 1, **SHAPE)
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                       x["env0"])
    BT, Y = bk.k1_plain(x["A"][0], x["center"], le, re, x["phil"][0],
                        x["phir"][0], x["y1h"], x["w"], x["ls0"], x["V0"][0],
                        0.05, forward=forward)
    Q = torch.linalg.qr(Y).Q.contiguous()
    env, phi = (le, x["phil"][0]) if forward else (re, x["phir"][0])
    args = (BT, Q, env, x["ls0"], phi, 1e-10)
    got = bk.k2_cuda(*args, forward=forward, max_rank=mr)
    torch.cuda.synchronize()
    _close(got, bk.k2_plain(*args, forward=forward, max_rank=mr))


@pytest.mark.parametrize("forward", [False, True])
def test_qr_bond_kernels_match_the_plain_qr_bond(bk, forward):
    # K1 -> torch.linalg.qr -> K2 against the plain versions around the same
    # QR call, so the column signs agree
    x = _inputs(12, 1, **SHAPE)
    kw = dict(forward=forward, loss="MSE", opp_ls=x["opp"])
    bk.reset_counts()
    got = bk.bond_step(*_single(x, forward), orth="qr", **kw)
    torch.cuda.synchronize()
    assert bk.LAUNCHES == {**dict.fromkeys(bk.LAUNCHES, 0), "k1": 1, "k2": 1}
    _close(got, bk.qr_bond_step(*_single(x, forward), plain=True, **kw))


def test_kernel_rejects_operands_off_the_card(bk):
    x = _inputs(9, 1, **SHAPE)
    args = list(_single(x, False))
    args[2] = args[2].cpu()
    with pytest.raises(ValueError, match="is on cpu"):
        bk.k12_cuda(*args, forward=False)
    args = list(_single(x, False))
    args[0] = args[0].double()
    with pytest.raises(ValueError, match="float32"):
        bk.k12_cuda(*args, forward=False)


def test_fit_on_cuda_runs_the_kernels(bk):
    import mpstime_tpu_torch as mt
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    Xtr, ytr = data["X_train"][:40], data["y_train"][:40]
    bk.reset_counts()
    trained, info, _ = mt.fit_mps(
        Xtr, ytr, opts=mt.MPSOptions(nsweeps=3, chi_max=12, d=3,
                                     verbosity=-1, log_level=-1),
        device="cuda")
    assert bk.LAUNCHES["k12m"] == 3 * 2 * 12 and bk.LAUNCHES["k12"] == 0
    assert sum(bk.PLAIN_CALLS.values()) == 0
    assert trained.mps.center.is_cuda and len(info["sweep_seconds"]) == 3
    assert np.mean(mt.classify(trained, Xtr) == ytr) >= 0.9


def test_qr_fit_on_cuda_runs_k1_and_k2(bk):
    import mpstime_tpu_torch as mt
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    Xtr, ytr = data["X_train"][:40], data["y_train"][:40]
    bk.reset_counts()
    trained, _, _ = mt.fit_mps(
        Xtr, ytr, opts=mt.MPSOptions(nsweeps=2, chi_max=12, d=3,
                                     verbosity=-1, log_level=-1,
                                     orth_alg="qr", subspace_refresh_every=2),
        device="cuda")
    # refresh sweep: one K1 and one K2 per bond; frozen sweep: K12m blocks
    assert bk.LAUNCHES == {**dict.fromkeys(bk.LAUNCHES, 0), "k12m": 2 * 12,
                           "k1": 2 * 95, "k2": 2 * 95}
    assert sum(bk.PLAIN_CALLS.values()) == 0
    assert trained.mps.center.is_cuda
    assert np.mean(mt.classify(trained, Xtr) == ytr) >= 0.9


@pytest.mark.parametrize("kw", [
    dict(svd_alg="gram_eigh", track_cost=True),
    dict(dtype="float64", bbopt="CGD", update_iters=2),
    dict(svd_alg="randomized_lean", loss_grad="Mixed")])
def test_unfused_fit_on_cuda_runs_no_kernel(bk, kw):
    import mpstime_tpu_torch as mt
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    Xtr, ytr = data["X_train"][:40, :24], data["y_train"][:40]
    bk.reset_counts()
    trained, info, _ = mt.fit_mps(
        Xtr, ytr, opts=mt.MPSOptions(nsweeps=1, chi_max=8, d=3, verbosity=-1,
                                     log_level=-1, **kw),
        device="cuda")
    assert sum(bk.LAUNCHES.values()) == sum(bk.PLAIN_CALLS.values()) == 0
    assert trained.mps.cores.is_cuda
    assert bool(torch.isfinite(trained.mps.center).all())
    if kw.get("track_cost"):
        assert len(info["bond_costs"][0]) == 46


# ---- the dp and batch-tiled pieces: K1a, K1b, K2-split, K2-env -------------

def _dp_inputs(seed, forward):
    """One bond's operands with unit environment rows, as a sweep hands
    them over: (A, center, le, re, phil, phir, y1h, w, gls, V0, env, phi)."""
    x = _inputs(seed, 1, **SHAPE)
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                       x["env0"])
    le, re = (t / t.norm(dim=1, keepdim=True) for t in (le, re))
    env, phi = (le, x["phil"][0]) if forward else (re, x["phir"][0])
    return (x["A"][0], x["center"], le, re, x["phil"][0], x["phir"][0],
            x["y1h"], x["w"], x["ls0"] + x["opp"], x["V0"][0], env, phi,
            x["ls0"])


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("loss", ["KLD", "MSE"])
def test_k1a_kernel_matches_plain(bk, forward, loss):
    a = _dp_inputs(60, forward)[:9]
    n0 = bk.LAUNCHES["k1a"]
    got = bk.k1a_cuda(*a, forward=forward, loss=loss)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["k1a"] == n0 + 1
    _close([got], [bk.k1a_plain(*a, forward=forward, loss=loss)])


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("emit_y,q,orth,bbopt", [
    (True, 1, "ns", "TSGO"), (True, 3, "ns", "TSGO"), (True, 1, "qr", "GD"),
    (True, 3, "qr", "TSGO"), (False, 1, "qr", "TSGO")])
def test_k1b_kernel_matches_plain(bk, forward, emit_y, q, orth, bbopt):
    a = _dp_inputs(61, forward)
    G = bk.k1a_plain(*a[:9], forward=forward)
    kw = dict(forward=forward, emit_y=emit_y, power_iters=q, orth=orth,
              bbopt=bbopt)
    n0 = bk.LAUNCHES["k1b"]
    got = bk.k1b_cuda(a[0], a[1], G, a[9], 0.05, **kw)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["k1b"] == n0 + 1
    _close(got, bk.k1b_plain(a[0], a[1], G, a[9], 0.05, **kw))


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("mr", [None, 17])
def test_k2_split_and_k2_env_kernels_match_plain(bk, forward, mr):
    a = _dp_inputs(62, forward)
    BT, Y = bk.k1_plain(*a[:10], 0.05, forward=forward)
    Q = torch.linalg.qr(Y).Q.contiguous()
    got = bk.k2_split_cuda(BT, Q, 1e-10, forward=forward, max_rank=mr)
    ref = bk.k2_split_plain(BT, Q, 1e-10, forward=forward, max_rank=mr)
    _close(got, ref)
    assert torch.equal(got[2] != 0, ref[2] != 0)        # equal kept ranks
    env, phi, ls = a[10:]
    _close(bk.k2_env_cuda(ref[2], env, ls, phi, forward=forward),
           bk.k2_env_plain(ref[2], env, ls, phi, forward=forward))


@pytest.mark.parametrize("forward", [False, True])
def test_dp_bond_on_one_and_two_shards_of_the_card(bk, forward):
    """One shard: K1a -> K1b -> K2-split -> K2-env does K12's and K1 ->
    K2's arithmetic; two shards of one card sum the gradient in another
    order (the per-bond bound of several shards, tests/test_parallel.py:
    199-212)."""
    from mpstime_tpu_torch.parallel import Mesh
    x = _inputs(63, 1, **SHAPE)
    args = _single(x, forward)

    def dp(n, **kw):
        def shards(t):
            return list(t.chunk(n))
        out = bk.bond_step_dp(Mesh(["cuda:0"] * n), [args[0]], [args[1]],
                              *(shards(t) for t in args[2:9]), [args[9]],
                              0.05, 1e-10, forward=forward, **kw)
        return (out[0][0], out[1][0], torch.cat(out[2]), torch.cat(out[3]),
                out[4][0])

    _close(dp(1, orth="ns"), bk.k12_cuda(*args, forward=forward),
           rtol=0, atol=1e-6)
    _close(dp(1, orth="qr"), bk.qr_bond_step(*args, forward=forward,
                                             plain=False), rtol=0, atol=1e-6)
    _close(dp(2, orth="ns"), dp(1, orth="ns"), rtol=0, atol=1e-4)


def test_streamed_bond_step_on_the_card(bk):
    x = _inputs(64, 1, **SHAPE)
    for forward in (False, True):
        args = _single(x, forward)
        n0 = bk.LAUNCHES["k1a"]
        got = bk.bond_step(*args, forward=forward, orth="ns", stream_tile=32)
        assert bk.LAUNCHES["k1a"] == n0 + 4                 # 100 rows -> 4
        _close(got, bk.bond_step(*args, forward=forward, orth="ns"),
               rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2])
def test_mesh_fit_on_one_card_runs_the_dp_kernels(bk, n):
    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch.parallel import Mesh
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    Xtr, ytr = data["X_train"][:40], data["y_train"][:40]
    bk.reset_counts()
    trained, info, _ = mt.fit_mps(
        Xtr, ytr, opts=mt.MPSOptions(nsweeps=3, chi_max=12, d=3,
                                     verbosity=-1, log_level=-1),
        mesh=Mesh(["cuda:0"] * n))
    bonds = 3 * 2 * 95
    assert bk.LAUNCHES == {**dict.fromkeys(bk.LAUNCHES, 0), "k1a": n * bonds,
                           "k1b": bonds, "k2_split": bonds,
                           "k2_env": n * bonds}
    # K1a and K1c-grad run over a cluster, never on one block
    assert bk.LAUNCHES["k1a_block"] == bk.LAUNCHES["k1c_grad_block"] == 0
    assert sum(bk.PLAIN_CALLS.values()) == 0
    assert trained.mps.center.is_cuda and len(info["sweep_seconds"]) == 3
    assert np.mean(mt.classify(trained, Xtr) == ytr) >= 0.9


@pytest.mark.parametrize("encoding,pieces", [
    ("legendre_no_norm", ("k1a", "k1b", "k2_split", "k2_env")),
    ("fourier", ("k1c_grad", "k1c_update", "k2c_split", "k2c_env"))])
def test_mesh_over_several_cards_is_the_same_shards_on_one(bk, encoding,
                                                           pieces):
    """A mesh over cuda:0 .. cuda:n-1 (n <= 4) sums the same shards in the
    same order as n shards on cuda:0, and each card's replica computes the
    same: the fits agree bit for bit, real and complex."""
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two CUDA devices")
    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch.parallel import Mesh, make_mesh
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    Xtr, ytr = data["X_train"][:40], data["y_train"][:40]
    opts = mt.MPSOptions(nsweeps=2, chi_max=12, d=3, verbosity=-1,
                         log_level=-1, encoding=encoding)
    bk.reset_counts()
    mesh = make_mesh(n)
    several, _, _ = mt.fit_mps(Xtr, ytr, opts=opts, mesh=mesh)
    bonds = 2 * 2 * 95
    # the update and split once on each card's replica, the gradient and
    # the env advance per shard
    assert bk.LAUNCHES == {**dict.fromkeys(bk.LAUNCHES, 0),
                           **dict.fromkeys(pieces, n * bonds)}
    assert mesh.reductions == bonds and len(mesh.replicas) == n
    one, _, _ = mt.fit_mps(Xtr, ytr, opts=opts, mesh=Mesh(["cuda:0"] * n))
    assert several.mps.center.device == torch.device("cuda", 0)
    torch.testing.assert_close(several.mps.cores, one.mps.cores, rtol=0,
                               atol=0)
    torch.testing.assert_close(several.mps.center, one.mps.center, rtol=0,
                               atol=0)


# ---- the complex kernels (ops/bond_kernels_c.py) ---------------------------

@pytest.fixture(scope="module")
def bkc(bk):
    from mpstime_tpu_torch.ops import bond_kernels_c
    return bond_kernels_c


def _inputs_c(seed, Bb, C, chi, d, N):
    """Complex64 operands of Bb bonds on the card: unit-modulus conjugated
    features, as tests/test_torch_complex_kernels.py makes them."""
    from mpstime_tpu_torch.ops.decomp import warm_sketch_init
    rng = np.random.default_rng(seed)

    def c(*shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(z.astype(np.complex64)).cuda()

    def phi(*shape):
        z = np.exp(1j * rng.uniform(-np.pi, np.pi, shape)) / np.sqrt(d)
        return torch.from_numpy(z.astype(np.complex64)).cuda()

    def r(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    return dict(
        A=c(Bb, chi, d, chi), center=c(C, chi, d, chi), envx=c(Bb, N, chi),
        env0=c(N, chi), ls0=r(rng.standard_normal(N)),
        phil=phi(Bb, N, d), phir=phi(Bb, N, d),
        y1h=r(np.eye(C)[rng.integers(0, C, N)]), w=r(np.full(N, 1.0 / N)),
        V0=torch.stack([warm_sketch_init(chi * d, chi, np.complex64, "cuda")]
                       * Bb))


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh,q,mr", [(True, 3, None), (True, 1, None),
                                          (False, 1, None), (True, 3, 17)])
def test_k12c_kernel_matches_plain(bk, bkc, forward, refresh, q, mr):
    x = _inputs_c(21, 1, **SHAPE)
    kw = dict(forward=forward, refresh=refresh, power_iters=q, max_rank=mr)
    n0 = bk.LAUNCHES["k12c"]
    got = bkc.bond_step_c(*_single(x, forward), orth="ns", **kw)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["k12c"] == n0 + 1
    _close(got, bkc.k12c_plain(*_single(x, forward), **kw))


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh", [True, False])
def test_k12mc_kernel_matches_plain_and_chained_k12c(bkc, forward, refresh):
    x = _inputs_c(22, 4, **SHAPE)
    kw = dict(forward=forward, refresh=refresh, power_iters=1)
    got = bkc.bond_block_steps_c(*_block(x), **kw)
    torch.cuda.synchronize()
    _close(got, bkc.k12mc_plain(*_block(x), **kw))
    center, env, ls = x["center"], x["env0"], x["ls0"]
    for b in range(4):
        le, re = (env, x["envx"][b]) if forward else (x["envx"][b], env)
        center, core, env, ls, Q = bkc.k12c_cuda(
            x["A"][b], center, le, re, ls, x["phil"][b], x["phir"][b],
            x["y1h"], x["w"], x["V0"][b], 0.05, 1e-10, **kw)
        _close((core, env, ls, Q), (got[1][b], got[2][b], got[3][b],
                                    got[4][b]), rtol=0, atol=1e-6)
    _close((center,), (got[0],), rtol=0, atol=1e-6)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("emit_y,q,orth", [(True, 1, "qr"), (True, 3, "qr"),
                                           (False, 1, "qr"), (True, 3, "ns")])
def test_k1c_kernel_matches_plain(bk, bkc, forward, emit_y, q, orth):
    x = _inputs_c(23, 1, **SHAPE)
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                       x["env0"])
    args = (x["A"][0], x["center"], le, re, x["phil"][0], x["phir"][0],
            x["y1h"], x["w"], x["V0"][0], 0.05)
    kw = dict(forward=forward, emit_y=emit_y, power_iters=q, orth=orth)
    n0 = bk.LAUNCHES["k1c"]
    got = bkc.k1c_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["k1c"] == n0 + 1
    _close(got, bkc.k1c_plain(*args, **kw))


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("mr", [None, 17])
def test_k2c_kernel_matches_plain(bkc, forward, mr):
    from mpstime_tpu_torch.ops.decomp import _qr_orth
    x = _inputs_c(24, 1, **SHAPE)
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                       x["env0"])
    BT, Y = bkc.k1c_plain(x["A"][0], x["center"], le, re, x["phil"][0],
                          x["phir"][0], x["y1h"], x["w"], x["V0"][0], 0.05,
                          forward=forward, power_iters=3)
    Q = _qr_orth(Y).contiguous()
    env, phi = (le, x["phil"][0]) if forward else (re, x["phir"][0])
    args = (BT, Q, env, x["ls0"], phi, 1e-10)
    got = bkc.k2c_cuda(*args, forward=forward, max_rank=mr)
    torch.cuda.synchronize()
    _close(got, bkc.k2c_plain(*args, forward=forward, max_rank=mr))


@pytest.mark.parametrize("forward", [False, True])
def test_complex_qr_bond_kernels_match_the_plain_qr_bond(bk, bkc, forward):
    x = _inputs_c(25, 1, **SHAPE)
    bk.reset_counts()
    got = bkc.bond_step_c(*_single(x, forward), orth="qr", forward=forward,
                          power_iters=3)
    torch.cuda.synchronize()
    assert bk.LAUNCHES == {**dict.fromkeys(bk.LAUNCHES, 0), "k1c": 1,
                           "k2c": 1}
    _close(got, bkc.qr_bond_step_c(*_single(x, forward), forward=forward,
                                   plain=True, power_iters=3))


def test_complex_kernels_refuse_what_they_do_not_cover(bkc):
    x = _inputs_c(26, 1, **SHAPE)
    with pytest.raises(ValueError, match="KLD"):
        bkc.k12c_cuda(*_single(x, False), forward=False, loss="MSE")
    args = list(_single(x, False))
    args[1] = args[1].to(torch.complex128)
    with pytest.raises(ValueError, match="complex64"):
        bkc.k12c_cuda(*args, forward=False)


@pytest.mark.parametrize("kw,want", [
    (dict(), {"k12c": 2 * 2 * 23}),
    (dict(orth_alg="qr", subspace_refresh_every=2),
     {"k1c": 2 * 23, "k2c": 2 * 23, "k12mc": 2 * 6})])
def test_complex_fit_on_cuda_runs_the_complex_kernels(bk, kw, want):
    import mpstime_tpu_torch as mt
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    Xtr, ytr = data["X_train"][:40, :24], data["y_train"][:40]
    bk.reset_counts()
    trained, _, _ = mt.fit_mps(
        Xtr, ytr, opts=mt.MPSOptions(encoding="fourier", nsweeps=2,
                                     chi_max=12, d=3, verbosity=-1,
                                     log_level=-1, **kw),
        device="cuda")
    assert bk.LAUNCHES == {**dict.fromkeys(bk.LAUNCHES, 0), **want}
    assert sum(bk.PLAIN_CALLS.values()) == 0
    assert trained.mps.center.is_cuda
    assert trained.mps.center.dtype == torch.complex64
    assert bool(torch.isfinite(trained.mps.center).all())


# ---- the ritz kernel K12cr --------------------------------------------------

RITZ_SHAPE = dict(C=2, chi=64, d=5, N=100)     # the ritz cell's bond shape
# the raw outputs at a wider bound than the other kernels': Jacobi rounds on
# a random Gram turn float32 rounding into rotations inside near-degenerate
# pairs (a gauge); the gauge invariants at RTOL / ATOL
RITZ_RTOL, RITZ_ATOL = 1e-3, 2e-4


def _ritz_invariants(out, forward):
    center, core, env, ls, Q = out
    if forward:
        rec = torch.einsum("aim,cmkb->caikb", core, center)
        inv = torch.einsum("nm,akm->nak", env, core.conj())
    else:
        rec = torch.einsum("caim,mkb->caikb", center, core)
        inv = torch.einsum("nm,mkb->nkb", env, core.conj())
    return rec, inv, ls, Q @ Q.conj().T


def _kept(core, forward):
    if forward:
        return (core != 0).any(dim=0).any(dim=0)
    return (core != 0).any(dim=-1).any(dim=-1)


@pytest.mark.parametrize("shape", [RITZ_SHAPE, dict(C=2, chi=8, d=3, N=16)],
                         ids=["chi64", "chi8"])
@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh,q,rounds,mr", [
    (True, 1, 6, None), (False, 1, 6, None), (True, 3, 24, None),
    (True, 1, 6, 5)])
def test_k12cr_kernel_matches_plain(bk, bkc, shape, forward, refresh, q,
                                    rounds, mr):
    x = _inputs_c(27, 1, **shape)
    kw = dict(forward=forward, refresh=refresh, power_iters=q,
              rounds=rounds, max_rank=mr)
    n0 = bk.LAUNCHES["k12cr"]
    got = bkc.bond_step_c_ritz(*_single(x, forward),
                               rot="jacobi" if rounds == 6 else "jacobi_warm",
                               **{k: v for k, v in kw.items()
                                  if k != "rounds"})
    torch.cuda.synchronize()
    assert bk.LAUNCHES["k12cr"] == n0 + 1
    ref = bkc.k12cr_plain(*_single(x, forward), **kw)
    _close(got, ref, rtol=RITZ_RTOL, atol=RITZ_ATOL)
    _close(_ritz_invariants(got, forward), _ritz_invariants(ref, forward))
    assert torch.equal(_kept(got[1], forward), _kept(ref[1], forward))


def test_k12cr_refuses_what_it_does_not_cover(bkc):
    x = _inputs_c(28, 1, **RITZ_SHAPE)
    with pytest.raises(ValueError, match="Jacobi"):
        bkc.bond_step_c_ritz(*_single(x, False), forward=False, rot="eigh")
    args = list(_single(x, False))
    args[1] = args[1].to(torch.complex128)
    with pytest.raises(ValueError, match="complex64"):
        bkc.k12cr_cuda(*args, forward=False)


@pytest.mark.parametrize("kw,want", [
    (dict(), {"k12cr": 2 * 23}),
    (dict(ritz_rot_exact="jacobi"), {"k12cr": 3 * 2 * 23}),
    (dict(ritz_rot_track="track"), {})])
def test_ritz_fit_on_cuda_runs_k12cr_on_jacobi_sweeps(bk, kw, want):
    # 3 sweeps at ritz_exact_sweeps=2: two exact (unfused), one tracked
    import mpstime_tpu_torch as mt
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    Xtr, ytr = data["X_train"][:40, :24], data["y_train"][:40]
    bk.reset_counts()
    trained, _, _ = mt.fit_mps(
        Xtr, ytr, opts=mt.MPSOptions(encoding="fourier", nsweeps=3,
                                     chi_max=12, d=3, verbosity=-1,
                                     log_level=-1,
                                     svd_alg="randomized_warm_ritz", **kw),
        device="cuda")
    assert bk.LAUNCHES == {**dict.fromkeys(bk.LAUNCHES, 0), **want}
    assert sum(bk.PLAIN_CALLS.values()) == 0
    assert trained.mps.center.dtype == torch.complex64
    assert bool(torch.isfinite(trained.mps.center).all())


# ---- K12c and K12cr over a thread-block cluster ------------------------------

def _equal(got, ref):
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        assert torch.equal(g, r), float((g - r).abs().max())


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh,q,mr", [(True, 3, None), (True, 1, None),
                                          (False, 1, None), (True, 3, 17)])
def test_k12c_cluster_equals_k12mc_at_one_block(bkc, forward, refresh, q,
                                                mr):
    # K12c runs one bond over a cluster; the one-block K12mc at Bb = 1 is
    # the one-block kernel over the same device functions: the same bits
    x = _inputs_c(31, 1, **SHAPE)
    kw = dict(forward=forward, refresh=refresh, power_iters=q, max_rank=mr)
    got = bkc.k12c_cuda(*_single(x, forward), **kw)
    one = bkc.k12mc_block_cuda(*_block(x), **kw)
    torch.cuda.synchronize()
    _equal(got, (one[0],) + tuple(t[0] for t in one[1:]))


@pytest.mark.parametrize("shape", [RITZ_SHAPE, dict(C=2, chi=8, d=3, N=16)],
                         ids=["chi64", "chi8"])
@pytest.mark.parametrize("forward", [False, True])
def test_k12cr_is_equal_across_cluster_sizes(bkc, shape, forward):
    x = _inputs_c(32, 1, **shape)
    kw = dict(forward=forward, refresh=True, power_iters=1, rounds=6)
    ref = bkc.k12cr_cuda(*_single(x, forward), cluster=1, **kw)
    for n in (2, 4, 8, 16):
        if bkc.cluster_occupancy("k12cr", n, shape["chi"]) >= 1:
            _equal(bkc.k12cr_cuda(*_single(x, forward), cluster=n, **kw), ref)
    torch.cuda.synchronize()


@pytest.mark.parametrize("ritz", [False, True])
def test_a_cluster_the_card_refuses_raises(bk, bkc, ritz):
    """A cluster of 32 blocks: the wrapper refuses it (ValueError), and past
    the wrapper the card refuses the launch itself (RuntimeError);
    nothing launches, and the next launch runs."""
    x = _inputs_c(33, 1, **(RITZ_SHAPE if ritz else SHAPE))
    step = bkc.k12cr_cuda if ritz else bkc.k12c_cuda
    key = "k12cr" if ritz else "k12c"
    n0 = bk.LAUNCHES[key]
    with pytest.raises(ValueError, match="from 1 to 16"):
        step(*_single(x, False), forward=False, cluster=32)
    entry, extra = (("mpst_k12cr_launch", (6, 32)) if ritz
                    else ("mpst_k12c_launch", (32,)))
    with pytest.raises(RuntimeError, match="CUDA error"):
        bkc._k12mc(entry, extra, *_raw_block(x), forward=False,
                   refresh=True, power_iters=1, max_rank=None)
    assert bk.LAUNCHES[key] == n0
    # the refusal leaves no error behind for the next launch
    step(*_single(x, False), forward=False)
    torch.cuda.synchronize()
    assert bk.LAUNCHES[key] == n0 + 1


# ---- K1c and K1c-update over a thread-block cluster -------------------------

K1C_GRID = [(True, 1, "qr"), (True, 3, "qr"), (False, 1, "qr"),
            (True, 1, "ns"), (True, 3, "ns")]


def _k1c_operands(bkc, key, seed, forward):
    """K1c's operands, or K1c-update's with K1c-grad's gradient of the same
    inputs, at the main-path shape."""
    if key == "k1c":
        x = _inputs_c(seed, 1, **SHAPE)
        le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                           x["env0"])
        return (x["A"][0], x["center"], le, re, x["phil"][0], x["phir"][0],
                x["y1h"], x["w"], x["V0"][0], 0.05)
    a = _dp_inputs_c(seed, forward)
    return (a[0], a[1], bkc.k1c_grad_cuda(*a[:9], forward=forward), a[9],
            0.05)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("emit_y,q,orth", K1C_GRID)
def test_k1c_cluster_equals_one_block(bk, bkc, forward, emit_y, q, orth):
    # K1c runs one bond update over a cluster; k1c_block_cuda is the
    # one-block kernel over the same device functions: the same bits
    args = _k1c_operands(bkc, "k1c", 34, forward)
    kw = dict(forward=forward, emit_y=emit_y, power_iters=q, orth=orth)
    n0, b0 = bk.LAUNCHES["k1c"], bk.LAUNCHES["k1c_block"]
    got = bkc.k1c_cuda(*args, **kw)
    one = bkc.k1c_block_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert (bk.LAUNCHES["k1c"], bk.LAUNCHES["k1c_block"]) == (n0 + 1, b0 + 1)
    _equal(got, one)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("emit_y,q,orth", K1C_GRID)
def test_k1c_update_cluster_equals_one_block(bk, bkc, forward, emit_y, q,
                                             orth):
    args = _k1c_operands(bkc, "k1c_update", 35, forward)
    kw = dict(forward=forward, emit_y=emit_y, power_iters=q, orth=orth)
    n0 = bk.LAUNCHES["k1c_update"]
    b0 = bk.LAUNCHES["k1c_update_block"]
    got = bkc.k1c_update_cuda(*args, **kw)
    one = bkc.k1c_update_block_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert (bk.LAUNCHES["k1c_update"],
            bk.LAUNCHES["k1c_update_block"]) == (n0 + 1, b0 + 1)
    _equal(got, one)


@pytest.mark.parametrize("key", ["k1c", "k1c_update"])
@pytest.mark.parametrize("forward", [False, True])
def test_k1c_kernels_equal_across_cluster_sizes(bkc, key, forward):
    cuda = bkc.k1c_cuda if key == "k1c" else bkc.k1c_update_cuda
    args = _k1c_operands(bkc, key, 36, forward)
    kw = dict(forward=forward, power_iters=3, orth="ns")
    ref = cuda(*args, cluster=1, **kw)
    for n in (2, 4, 8, 16):
        if bkc.cluster_occupancy(key, n, SHAPE["chi"]) >= 1:
            _equal(cuda(*args, cluster=n, **kw), ref)
    torch.cuda.synchronize()


@pytest.mark.parametrize("key", ["k1c", "k1c_update"])
def test_a_k1c_cluster_past_the_limit_is_refused(bk, bkc, key):
    """A cluster of 32 blocks: the wrapper refuses it (ValueError), and the
    card refuses the launch itself (RuntimeError); nothing launches, no
    one-block kernel stands in, and the next launch runs."""
    cuda = bkc.k1c_cuda if key == "k1c" else bkc.k1c_update_cuda
    raw, entry = ((bkc._k1c, "mpst_k1c_cluster_launch") if key == "k1c" else
                  (bkc._k1c_update, "mpst_k1c_update_cluster_launch"))
    args = _k1c_operands(bkc, key, 37, False)
    before = dict(bk.LAUNCHES)
    with pytest.raises(ValueError, match="from 1 to 16"):
        cuda(*args, forward=False, cluster=32)
    with pytest.raises(RuntimeError, match="CUDA error"):
        raw(entry, (32,), *args, forward=False, emit_y=True, power_iters=1,
            orth="qr")
    assert dict(bk.LAUNCHES) == before
    cuda(*args, forward=False)
    torch.cuda.synchronize()
    assert bk.LAUNCHES[key] == before[key] + 1


def test_complex_fits_launch_no_one_block_k1c(bk):
    """The fourier qr fit and the complex dp fit launch K1c and K1c-update
    over a cluster only."""
    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch.parallel import make_mesh
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    Xtr, ytr = data["X_train"][:40, :24], data["y_train"][:40]
    opts = mt.MPSOptions(encoding="fourier", nsweeps=2, chi_max=12, d=3,
                         verbosity=-1, log_level=-1)
    bk.reset_counts()
    mt.fit_mps(Xtr, ytr, opts=opts.replace(orth_alg="qr",
                                           subspace_refresh_every=2),
               device="cuda")
    mt.fit_mps(Xtr, ytr, opts=opts, mesh=make_mesh(1))
    torch.cuda.synchronize()
    assert bk.LAUNCHES["k1c"] == 2 * 23
    assert bk.LAUNCHES["k1c_update"] == 2 * 2 * 23
    assert bk.LAUNCHES["k1c_block"] == bk.LAUNCHES["k1c_update_block"] == 0


# ---- K1a and K1c-grad over a thread-block cluster ---------------------------

def _k1a_operands(key, seed, forward, N=SHAPE["N"], chi=SHAPE["chi"]):
    """K1a's (real, gls the total log-scale) or K1c-grad's (complex)
    operands with N rows of unit environments, as a shard or a stream tile
    hands them over: (A, center, le, re, phil, phir, y1h, w, gls)."""
    x = (_inputs if key == "k1a" else _inputs_c)(
        seed, 1, **dict(SHAPE, N=N, chi=chi))
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                       x["env0"])
    le, re = (t / t.norm(dim=1, keepdim=True) for t in (le, re))
    gls = x["ls0"] + x["opp"] if key == "k1a" else x["ls0"]
    return (x["A"][0], x["center"], le, re, x["phil"][0], x["phir"][0],
            x["y1h"], x["w"], gls)


def _k1a_fns(bk, bkc, key):
    """(cluster wrapper, one-block wrapper) of K1a or K1c-grad."""
    if key == "k1a":
        return bk.k1a_cuda, bk.k1a_block_cuda
    return bkc.k1c_grad_cuda, bkc.k1c_grad_block_cuda


#: (kernel, loss, N): one shard of 100 rows and a stream tile of 32, MSE
#: (with its log-scales) for the real K1a only
K1A_CASES = [("k1a", "KLD", 100), ("k1a", "MSE", 100), ("k1a", "KLD", 32),
             ("k1a", "MSE", 32), ("k1c_grad", "KLD", 100),
             ("k1c_grad", "KLD", 32)]


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("key,loss,N", K1A_CASES)
def test_k1a_cluster_equals_one_block(bk, bkc, forward, key, loss, N):
    # K1a and K1c-grad run one shard's gradient over a cluster; the
    # one-block kernel is k1a_kernel over the same device functions: the
    # same bits
    cuda, block = _k1a_fns(bk, bkc, key)
    args = _k1a_operands(key, 38, forward, N)
    kw = dict(forward=forward, loss=loss)
    n0, b0 = bk.LAUNCHES[key], bk.LAUNCHES[f"{key}_block"]
    got = cuda(*args, **kw)
    one = block(*args, **(kw if key == "k1a" else dict(forward=forward)))
    torch.cuda.synchronize()
    assert (bk.LAUNCHES[key], bk.LAUNCHES[f"{key}_block"]) == (n0 + 1,
                                                               b0 + 1)
    _equal([got], [one])


@pytest.mark.parametrize("key", ["k1a", "k1c_grad"])
@pytest.mark.parametrize("forward", [False, True])
def test_k1a_kernels_equal_across_cluster_sizes(bk, bkc, key, forward):
    cuda, block = _k1a_fns(bk, bkc, key)
    args = _k1a_operands(key, 39, forward)
    ref = block(*args, forward=forward)
    for n in range(1, 17):
        if bkc.cluster_occupancy(key, n, SHAPE["chi"]) >= 1:
            _equal([cuda(*args, forward=forward, cluster=n)], [ref])
    torch.cuda.synchronize()


@pytest.mark.parametrize("key", ["k1a", "k1c_grad"])
def test_a_k1a_cluster_past_the_limit_is_refused(bk, bkc, key):
    """A cluster of 32 blocks: the wrapper refuses it (ValueError), and the
    card refuses the launch itself (RuntimeError); nothing launches, no
    one-block kernel stands in, and the next launch runs."""
    cuda, _ = _k1a_fns(bk, bkc, key)
    args = _k1a_operands(key, 40, False)
    before = dict(bk.LAUNCHES)
    with pytest.raises(ValueError, match="from 1 to 16"):
        cuda(*args, forward=False, cluster=32)
    with pytest.raises(RuntimeError, match="CUDA error"):
        if key == "k1a":
            bk._k1a("mpst_k1a_cluster_launch", (32,), *args, forward=False,
                    loss="KLD")
        else:
            bkc._k1c_grad("mpst_k1c_grad_cluster_launch", (32,), *args[:8],
                          forward=False)
    assert dict(bk.LAUNCHES) == before
    cuda(*args, forward=False)
    torch.cuda.synchronize()
    assert bk.LAUNCHES[key] == before[key] + 1


# ---- K1 and K1b over a thread-block cluster ---------------------------------

def _k1_operands(bk, key, seed, forward, chi=SHAPE["chi"]):
    """K1's operands (gls the total log-scale), or K1b's with the cluster
    K1a's gradient of the same inputs (unit environment rows)."""
    if key == "k1":
        x = _inputs(seed, 1, **dict(SHAPE, chi=chi))
        le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                           x["env0"])
        return (x["A"][0], x["center"], le, re, x["phil"][0], x["phir"][0],
                x["y1h"], x["w"], x["ls0"] + x["opp"], x["V0"][0], 0.05)
    from mpstime_tpu_torch.ops.decomp import warm_sketch_init
    a = _k1a_operands("k1a", seed, forward, chi=chi)
    V0 = warm_sketch_init(chi * SHAPE["d"], chi, np.float32, "cuda")
    return (a[0], a[1], bk.k1a_cuda(*a, forward=forward), V0, 0.05)


def _k1_fns(bk, key):
    """(cluster wrapper, one-block wrapper) of K1 or K1b."""
    if key == "k1":
        return bk.k1_cuda, bk.k1_block_cuda
    return bk.k1b_cuda, bk.k1b_block_cuda


#: (kernel, loss, bbopt): K1 with KLD, MSE (its log-scales) and GD; K1b
#: (the summed gradient: no loss) with TSGO and GD
K1_CASES = [("k1", "KLD", "TSGO"), ("k1", "MSE", "TSGO"), ("k1", "KLD", "GD"),
            ("k1", "MSE", "GD"), ("k1b", None, "TSGO"), ("k1b", None, "GD")]


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("emit_y,q,orth", K1C_GRID)
@pytest.mark.parametrize("key,loss,bbopt", K1_CASES)
def test_k1_cluster_equals_one_block(bk, forward, emit_y, q, orth, key, loss,
                                     bbopt):
    # K1 and K1b run one bond update over a cluster; the one-block kernel is
    # k1_kernel / k1b_kernel over the same device functions: the same bits
    cuda, block = _k1_fns(bk, key)
    args = _k1_operands(bk, key, 41, forward)
    kw = dict(forward=forward, emit_y=emit_y, power_iters=q, orth=orth,
              bbopt=bbopt, **({"loss": loss} if loss else {}))
    n0, b0 = bk.LAUNCHES[key], bk.LAUNCHES[f"{key}_block"]
    got = cuda(*args, **kw)
    one = block(*args, **kw)
    torch.cuda.synchronize()
    assert (bk.LAUNCHES[key], bk.LAUNCHES[f"{key}_block"]) == (n0 + 1,
                                                               b0 + 1)
    _equal(got, one)


@pytest.mark.parametrize("key", ["k1", "k1b"])
@pytest.mark.parametrize("forward", [False, True])
def test_k1_kernels_equal_across_cluster_sizes(bk, key, forward):
    cuda, block = _k1_fns(bk, key)
    args = _k1_operands(bk, key, 42, forward)
    kw = dict(forward=forward, power_iters=3, orth="ns")
    ref = block(*args, **kw)
    for n in range(1, 17):
        if bk.cluster_occupancy(key, n, SHAPE["chi"]) >= 1:
            _equal(cuda(*args, cluster=n, **kw), ref)
    torch.cuda.synchronize()


@pytest.mark.parametrize("key", ["k1", "k1b"])
def test_a_k1_cluster_past_the_limit_is_refused(bk, key):
    """A cluster of 32 blocks: the wrapper refuses it (ValueError), and the
    card refuses the launch itself (RuntimeError); nothing launches, no
    one-block kernel stands in, and the next launch runs."""
    cuda, _ = _k1_fns(bk, key)
    raw = bk._k1 if key == "k1" else bk._k1b
    args = _k1_operands(bk, key, 43, False)
    before = dict(bk.LAUNCHES)
    with pytest.raises(ValueError, match="from 1 to 16"):
        cuda(*args, forward=False, cluster=32)
    with pytest.raises(RuntimeError, match="CUDA error"):
        raw(f"mpst_{key}_cluster_launch", (32,), *args, forward=False,
            emit_y=True, power_iters=1, orth="qr", bbopt="TSGO",
            **({"loss": "KLD"} if key == "k1" else {}))
    assert dict(bk.LAUNCHES) == before
    cuda(*args, forward=False)
    torch.cuda.synchronize()
    assert bk.LAUNCHES[key] == before[key] + 1


def test_fits_launch_no_one_block_k1(bk, monkeypatch):
    """The qr fit, the dp fit and a split-tail fit launch K1 and K1b over a
    cluster only."""
    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch.parallel import make_mesh
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    Xtr, ytr = data["X_train"][:40, :24], data["y_train"][:40]
    opts = mt.MPSOptions(nsweeps=2, chi_max=12, d=3, verbosity=-1,
                         log_level=-1)
    bk.reset_counts()
    mt.fit_mps(Xtr, ytr, opts=opts.replace(orth_alg="qr",
                                           subspace_refresh_every=2),
               device="cuda")
    mt.fit_mps(Xtr, ytr, opts=opts, mesh=make_mesh(1))
    monkeypatch.setattr(bk, "SPLIT_TAIL_CHI", 0)
    mt.fit_mps(Xtr, ytr, opts=opts.replace(nsweeps=1), device="cuda")
    torch.cuda.synchronize()
    assert bk.LAUNCHES["k1"] == 2 * 23 + 2 * 23  # qr refresh, split tail
    assert bk.LAUNCHES["k1b"] == 2 * 2 * 23
    assert bk.LAUNCHES["k1_block"] == bk.LAUNCHES["k1b_block"] == 0
    assert sum(bk.PLAIN_CALLS.values()) == 0


# ---- the complex dp pieces K1c-grad, K1c-update, K2c-split, K2c-env --------

def _dp_inputs_c(seed, forward):
    """_dp_inputs' operands at complex64 (gls, unread by the KLD gradient,
    is the log-scale vector)."""
    x = _inputs_c(seed, 1, **SHAPE)
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                       x["env0"])
    le, re = (t / t.norm(dim=1, keepdim=True) for t in (le, re))
    env, phi = (le, x["phil"][0]) if forward else (re, x["phir"][0])
    return (x["A"][0], x["center"], le, re, x["phil"][0], x["phir"][0],
            x["y1h"], x["w"], x["ls0"], x["V0"][0], env, phi, x["ls0"])


@pytest.mark.parametrize("forward", [False, True])
def test_k1c_grad_kernel_matches_plain(bk, bkc, forward):
    a = _dp_inputs_c(70, forward)[:9]
    n0 = bk.LAUNCHES["k1c_grad"]
    got = bkc.k1c_grad_cuda(*a, forward=forward)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["k1c_grad"] == n0 + 1
    assert got.dtype == torch.complex64
    _close([got], [bkc.k1c_grad_plain(*a, forward=forward)])


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("emit_y,q,orth", [
    (True, 1, "ns"), (True, 3, "ns"), (True, 1, "qr"), (True, 3, "qr"),
    (False, 1, "qr")])
def test_k1c_update_kernel_matches_plain(bk, bkc, forward, emit_y, q, orth):
    a = _dp_inputs_c(71, forward)
    G = bkc.k1c_grad_plain(*a[:9], forward=forward)
    kw = dict(forward=forward, emit_y=emit_y, power_iters=q, orth=orth)
    n0 = bk.LAUNCHES["k1c_update"]
    got = bkc.k1c_update_cuda(a[0], a[1], G, a[9], 0.05, **kw)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["k1c_update"] == n0 + 1
    _close(got, bkc.k1c_update_plain(a[0], a[1], G, a[9], 0.05, **kw))


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("mr", [None, 17])
def test_k2c_split_and_k2c_env_kernels_match_plain(bk, bkc, forward, mr):
    from mpstime_tpu_torch.ops.decomp import _qr_orth
    a = _dp_inputs_c(72, forward)
    BT, Y = bkc.k1c_plain(*a[:8], a[9], 0.05, forward=forward, power_iters=3)
    Q = _qr_orth(Y).contiguous()
    got = bkc.k2c_split_cuda(BT, Q, 1e-10, forward=forward, max_rank=mr)
    ref = bkc.k2c_split_plain(BT, Q, 1e-10, forward=forward, max_rank=mr)
    _close(got, ref)
    assert torch.equal(got[2] != 0, ref[2] != 0)        # equal kept ranks
    env, phi, ls = a[10:]
    _close(bkc.k2c_env_cuda(ref[2], env, ls, phi, forward=forward),
           bkc.k2c_env_plain(ref[2], env, ls, phi, forward=forward))


@pytest.mark.parametrize("forward", [False, True])
def test_complex_dp_bond_on_one_and_two_shards_of_the_card(bk, bkc, forward):
    """One shard: the complex pieces do K12c's (ns) and K1c -> QR -> K2c's
    (qr) arithmetic at q 3; two shards sum the gradient in another order;
    the batch-tiled step (4 tiles of 100 rows) against the unstreamed one."""
    from mpstime_tpu_torch.parallel import Mesh
    x = _inputs_c(73, 1, **SHAPE)
    args = _single(x, forward)

    def dp(n, **kw):
        def shards(t):
            return list(t.chunk(n))
        out = bkc.bond_step_c_dp(Mesh(["cuda:0"] * n), [args[0]], [args[1]],
                                 *(shards(t) for t in args[2:9]), [args[9]],
                                 0.05, 1e-10, forward=forward, power_iters=3,
                                 **kw)
        return (out[0][0], out[1][0], torch.cat(out[2]), torch.cat(out[3]),
                out[4][0])

    _close(dp(1, orth="ns"), bkc.k12c_cuda(*args, forward=forward,
                                           power_iters=3), rtol=0, atol=1e-6)
    _close(dp(1, orth="qr"), bkc.qr_bond_step_c(*args, forward=forward,
                                                plain=False, power_iters=3),
           rtol=0, atol=1e-6)
    _close(dp(2, orth="ns"), dp(1, orth="ns"), rtol=0, atol=1e-4)
    n0 = bk.LAUNCHES["k1c_grad"]
    got = bkc.bond_step_c(*args, forward=forward, orth="ns", power_iters=3,
                          stream_tile=32)
    assert bk.LAUNCHES["k1c_grad"] == n0 + 4
    _close(got, bkc.bond_step_c(*args, forward=forward, orth="ns",
                                power_iters=3), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2])
def test_complex_mesh_fit_on_one_card_runs_the_complex_dp_kernels(bk, n):
    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch.parallel import Mesh
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    Xtr, ytr = data["X_train"][:40, :24], data["y_train"][:40]
    bk.reset_counts()
    mesh = Mesh(["cuda:0"] * n)
    trained, info, _ = mt.fit_mps(
        Xtr, ytr, opts=mt.MPSOptions(encoding="fourier", nsweeps=2,
                                     chi_max=12, d=3, verbosity=-1,
                                     log_level=-1), mesh=mesh)
    bonds = 2 * 2 * 23
    assert bk.LAUNCHES == {**dict.fromkeys(bk.LAUNCHES, 0),
                           "k1c_grad": n * bonds, "k1c_update": bonds,
                           "k2c_split": bonds, "k2c_env": n * bonds}
    assert bk.LAUNCHES["k1a_block"] == bk.LAUNCHES["k1c_grad_block"] == 0
    assert sum(bk.PLAIN_CALLS.values()) == 0 and mesh.reductions == bonds
    assert trained.mps.center.dtype == torch.complex64
    assert bool(torch.isfinite(trained.mps.center).all())
    assert len(mt.classify(trained, data["X_test"][:, :24])) == 100


# ---- the split-tail route: K1-tail and K1c-tail ----------------------------

@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("orth,q", [("ns", 1), ("ns", 3), ("qr", 1),
                                    ("qr", 3)])
def test_k1_tail_kernels_match_plain(bk, bkc, cplx, forward, orth, q):
    """K1-tail (K1c-tail) over the plain K1's stepped bond tensor."""
    if cplx:
        x = _inputs_c(80, 1, **SHAPE)
        le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                           x["env0"])
        BT, _ = bkc.k1c_plain(x["A"][0], x["center"], le, re, x["phil"][0],
                              x["phir"][0], x["y1h"], x["w"], x["V0"][0],
                              0.05, forward=forward, emit_y=False)
        cuda, plain, key = bkc.k1c_tail_cuda, bkc.k1c_tail_plain, "k1c_tail"
    else:
        x = _inputs(80, 1, **SHAPE)
        le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                           x["env0"])
        BT, _ = bk.k1_plain(x["A"][0], x["center"], le, re, x["phil"][0],
                            x["phir"][0], x["y1h"], x["w"], x["ls0"],
                            x["V0"][0], 0.05, forward=forward, emit_y=False)
        cuda, plain, key = bk.k1_tail_cuda, bk.k1_tail_plain, "k1_tail"
    kw = dict(forward=forward, power_iters=q, orth=orth)
    n0 = bk.LAUNCHES[key]
    got = cuda(BT, x["V0"][0], **kw)
    torch.cuda.synchronize()
    assert bk.LAUNCHES[key] == n0 + 1
    _close([got], [plain(BT, x["V0"][0], **kw)])


@pytest.mark.parametrize("forward", [False, True])
def test_split_tail_routes_are_the_fused_ones_on_the_card(bk, bkc, forward):
    """The split tail runs K1's power step over the same BT with the same
    block: bond_step against K12 (ns) and K1 -> QR -> K2 (qr), bond_step_c
    (q 3) against K12c and K1c -> QR -> K2c, and the batch-tiled steps
    without it."""
    args = _single(_inputs(81, 1, **SHAPE), forward)
    bk.reset_counts()
    got = bk.bond_step(*args, forward=forward, orth="ns", power_iters=3,
                       split_tail=True)
    torch.cuda.synchronize()
    assert bk.LAUNCHES == {**dict.fromkeys(bk.LAUNCHES, 0), "k1": 1,
                           "k1_tail": 3, "k2": 1}
    _close(got, bk.k12_cuda(*args, forward=forward, power_iters=3), rtol=0,
           atol=1e-6)
    _close(bk.bond_step(*args, forward=forward, orth="qr", split_tail=True),
           bk.qr_bond_step(*args, forward=forward, plain=False), rtol=0,
           atol=1e-6)
    _close(bk.bond_step(*args, forward=forward, orth="ns", stream_tile=32,
                        split_tail=True),
           bk.bond_step(*args, forward=forward, orth="ns", stream_tile=32,
                        split_tail=False), rtol=0, atol=1e-6)
    args = _single(_inputs_c(82, 1, **SHAPE), forward)
    kw = dict(forward=forward, power_iters=3)
    bk.reset_counts()
    got = bkc.bond_step_c(*args, orth="ns", split_tail=True, **kw)
    torch.cuda.synchronize()
    assert bk.LAUNCHES == {**dict.fromkeys(bk.LAUNCHES, 0), "k1c": 1,
                           "k1c_tail": 3, "k2c": 1}
    _close(got, bkc.k12c_cuda(*args, **kw), rtol=0, atol=1e-6)
    _close(bkc.bond_step_c(*args, orth="qr", split_tail=True, **kw),
           bkc.qr_bond_step_c(*args, plain=False, **kw), rtol=0, atol=1e-6)
    _close(bkc.bond_step_c(*args, orth="qr", stream_tile=32, split_tail=True,
                           **kw),
           bkc.bond_step_c(*args, orth="qr", stream_tile=32,
                           split_tail=False, **kw), rtol=0, atol=1e-6)


def test_k1_tail_wrappers_check_operands_before_launching(bk, bkc):
    x = _inputs(83, 1, **SHAPE)
    P, chi = x["V0"].shape[1:]
    BT = torch.zeros(2, P, 5, chi, device="cuda")
    V0 = x["V0"][0]
    bk.reset_counts()
    for fn, bt, v0, match in (
            (bk.k1_tail_cuda, BT, V0[:, :3], "shape"),
            (bk.k1_tail_cuda, BT.cpu(), V0, "cpu"),
            (bk.k1_tail_cuda, BT.double(), V0, "float32"),
            (bk.k1_tail_cuda, BT, V0.T.contiguous().T, "contiguous"),
            (bkc.k1c_tail_cuda, BT, V0, "complex64")):
        with pytest.raises(ValueError, match=match):
            fn(bt, v0, forward=False)
    with pytest.raises(ValueError, match="orth"):
        bkc.k1c_tail_cuda(BT.to(torch.complex64), V0.to(torch.complex64),
                          forward=False, orth="tri")
    assert sum(bk.LAUNCHES.values()) == 0


@pytest.mark.parametrize("encoding,want", [
    ("legendre_no_norm", {"k1": 46, "k1_tail": 46, "k2": 46}),
    ("fourier", {"k1c": 46, "k1c_tail": 138, "k2c": 46})])
def test_fit_on_the_split_tail_runs_the_tail_kernels(bk, monkeypatch,
                                                     encoding, want):
    """With SPLIT_TAIL_CHI = 0 every refresh bond of a fit on the card runs
    K1 -> K1-tail -> K2 (K1c -> 3 K1c-tail -> K2c)."""
    import mpstime_tpu_torch as mt
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    monkeypatch.setattr(bk, "SPLIT_TAIL_CHI", 0)
    bk.reset_counts()
    trained, _, _ = mt.fit_mps(
        data["X_train"][:40, :24], data["y_train"][:40],
        opts=mt.MPSOptions(encoding=encoding, nsweeps=1, chi_max=12, d=3,
                           verbosity=-1, log_level=-1))
    assert bk.LAUNCHES == {**dict.fromkeys(bk.LAUNCHES, 0), **want}
    assert sum(bk.PLAIN_CALLS.values()) == 0
    assert bool(torch.isfinite(trained.mps.center).all())


# ---- K12, K12m and K12mc over a thread-block cluster ----------------------

K12M_GRID = [(True, 1, "TSGO", None), (True, 3, "TSGO", None),
             (False, 1, "TSGO", None), (True, 1, "GD", None),
             (True, 3, "TSGO", 17)]


def _first(out):
    """A block's outputs at Bb = 1 as one bond's."""
    return (out[0],) + tuple(t[0] for t in out[1:])


def _raw_block(x):
    """_block's operands in the launch helpers' order (opp_ls None)."""
    b = _block(x)
    return b[:5] + (None,) + b[5:]


@pytest.mark.parametrize("Bb", [1, 2, 4, 8])
@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh,q,bbopt,mr", K12M_GRID)
def test_k12m_cluster_equals_one_block(bk, Bb, forward, refresh, q, bbopt,
                                       mr):
    # K12 (Bb = 1) and K12m run their bonds over a cluster;
    # k12m_block_cuda is the one-block kernel over the same device
    # functions: the same bits, the carried center, environment and
    # log-scales included
    x = _inputs(41 + Bb, Bb, **SHAPE)
    kw = dict(forward=forward, refresh=refresh, power_iters=q, max_rank=mr,
              bbopt=bbopt)
    key = "k12" if Bb == 1 else "k12m"
    n0, b0 = bk.LAUNCHES[key], bk.LAUNCHES["k12m_block"]
    one = bk.k12m_block_cuda(*_block(x), **kw)
    if Bb == 1:
        got, one = bk.k12_cuda(*_single(x, forward), **kw), _first(one)
    else:
        got = bk.k12m_cuda(*_block(x), **kw)
    torch.cuda.synchronize()
    assert (bk.LAUNCHES[key], bk.LAUNCHES["k12m_block"]) == (n0 + 1, b0 + 1)
    _equal(got, one)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("bbopt", ["TSGO", "GD"])
def test_k12_mse_cluster_equals_one_block(bk, forward, bbopt):
    x = _inputs(46, 1, **SHAPE)
    kw = dict(forward=forward, loss="MSE", bbopt=bbopt, opp_ls=x["opp"])
    got = bk.k12_cuda(*_single(x, forward), **kw)
    _equal(got, _first(bk.k12m_block_cuda(*_block(x), **kw)))


def _tie_break():
    """tests/test_torch_bond_kernels.py's degenerate-spectrum bond (frozen,
    eta 0, the cutoff inside a tie group) on the card: (A, center, env, ls,
    phi, y1h, w, V0, cutoff)."""
    chi, d, C, N = 6, 2, 1, 4
    wv = np.array([4.0, 2.0, 2.0, 2.0, 1.0, 0.5], np.float32)
    A = np.zeros((chi, d, chi), np.float32)
    A.reshape(chi * d, chi)[:chi] = np.eye(chi)
    center = np.zeros((C, chi, d, chi), np.float32)
    center[0, :, 0, :] = np.diag(np.sqrt(wv))
    V0 = np.zeros((d * chi, chi), np.float32)
    V0[:chi] = np.eye(chi)
    env = np.zeros((N, chi), np.float32)
    env[:, 0] = 1.0
    phi = np.full((N, d), 0.5, np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    return tuple(t(a) for a in (
        A, center, env, np.zeros(N, np.float32), phi,
        np.ones((N, C), np.float32), np.full(N, 1.0 / N, np.float32),
        V0)) + (float(np.float32(4.5 / wv.sum())),)


def test_k12_cluster_equals_one_block_on_the_tie_break(bk):
    """The degenerate-spectrum bond (_tie_break): the same bits, and the
    stable order keeps directions 0..2."""
    A, center, env, ls, phi, y1h, w, V0, cutoff = _tie_break()
    kw = dict(forward=False, refresh=False)
    got = bk.k12_cuda(A, center, env, env, ls, phi, phi, y1h, w, V0, 0.0,
                      cutoff, **kw)
    one = bk.k12m_block_cuda(A[None], center, env[None], env, ls, phi[None],
                             phi[None], y1h, w, V0[None], 0.0, cutoff, **kw)
    _equal(got, _first(one))
    assert _kept(got[1], False).tolist() == [True] * 3 + [False] * 3


@pytest.mark.parametrize("Bb", [1, 2, 3, 4])
@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh,q,mr", [(True, 1, None), (True, 3, None),
                                          (False, 1, None), (True, 3, 17)])
def test_k12mc_cluster_equals_one_block(bk, bkc, Bb, forward, refresh, q,
                                        mr):
    x = _inputs_c(51 + Bb, Bb, **SHAPE)
    kw = dict(forward=forward, refresh=refresh, power_iters=q, max_rank=mr)
    n0, b0 = bk.LAUNCHES["k12mc"], bk.LAUNCHES["k12mc_block"]
    got = bkc.k12mc_cuda(*_block(x), **kw)
    one = bkc.k12mc_block_cuda(*_block(x), **kw)
    torch.cuda.synchronize()
    assert (bk.LAUNCHES["k12mc"],
            bk.LAUNCHES["k12mc_block"]) == (n0 + 1, b0 + 1)
    _equal(got, one)


@pytest.mark.parametrize("key", ["k12", "k12m", "k12mc"])
@pytest.mark.parametrize("forward", [False, True])
def test_k12m_kernels_equal_across_cluster_sizes(bk, bkc, key, forward):
    if key == "k12mc":
        x, block = _inputs_c(56, 4, **SHAPE), bkc.k12mc_block_cuda

        def cluster(n, **kw):
            return bkc._k12mc_cluster(n, *_raw_block(x), **kw)
    else:
        x, block = _inputs(57, 1 if key == "k12" else 4, **SHAPE), \
            bk.k12m_block_cuda

        def cluster(n, **kw):
            return bk._k12m_cluster(n, *_raw_block(x), loss="KLD",
                                    bbopt="TSGO", **kw)
    kw = dict(forward=forward, refresh=True, power_iters=3, max_rank=None)
    ref = block(*_block(x), **kw)
    for n in range(1, 17):
        if bkc.cluster_occupancy("k12mc" if key == "k12mc" else "k12m", n,
                                 SHAPE["chi"]) >= 1:
            _equal(cluster(n, **kw), ref)
    torch.cuda.synchronize()


@pytest.mark.parametrize("key", ["k12", "k12m", "k12mc"])
def test_a_k12m_cluster_past_the_limit_is_refused(bk, bkc, key):
    """A cluster of 32 blocks: the cluster launch the checks at other sizes
    call refuses it (ValueError), and past that check the card refuses the
    launch itself (RuntimeError); nothing launches, no one-block kernel
    stands in, and the next launch of the wrapper runs."""
    x = (_inputs_c if key == "k12mc" else _inputs)(58, 1, **SHAPE)
    kw = dict(forward=False, refresh=True, power_iters=1, max_rank=None)
    if key == "k12mc":
        checked, entry = bkc._k12mc_cluster, "mpst_k12mc_cluster_launch"

        def raw(n):
            return bkc._k12mc(entry, (n,), *_raw_block(x), **kw)
    else:
        checked, entry = bk._k12m_cluster, "mpst_k12m_cluster_launch"
        kw.update(loss="KLD", bbopt="TSGO")

        def raw(n):
            return bk._k12m(entry, (n,), *_raw_block(x), **kw)
    before = dict(bk.LAUNCHES)
    with pytest.raises(ValueError, match="from 1 to 16"):
        checked(32, *_raw_block(x), **kw)
    with pytest.raises(RuntimeError, match="CUDA error"):
        raw(32)
    assert dict(bk.LAUNCHES) == before
    if key == "k12":
        bk.k12_cuda(*_single(x, False), forward=False)
    else:
        (bkc.k12mc_cuda if key == "k12mc" else bk.k12m_cuda)(
            *_block(x), forward=False)
    torch.cuda.synchronize()
    assert bk.LAUNCHES[key] == before[key] + 1


def test_fits_launch_no_one_block_k12m(bk):
    """The default, qr, MSE and fourier qr fits launch K12, K12m and K12mc
    over a cluster only."""
    import mpstime_tpu_torch as mt
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    Xtr, ytr = data["X_train"][:40, :24], data["y_train"][:40]
    opts = mt.MPSOptions(nsweeps=2, chi_max=12, d=3, verbosity=-1,
                         log_level=-1)
    counts = {}
    for name, o in (("default", opts),
                    ("qr", opts.replace(orth_alg="qr",
                                        subspace_refresh_every=2)),
                    ("mse", opts.replace(loss_grad="MSE")),
                    ("fourier qr", opts.replace(encoding="fourier",
                                                orth_alg="qr",
                                                subspace_refresh_every=2))):
        bk.reset_counts()
        mt.fit_mps(Xtr, ytr, opts=o, device="cuda")
        torch.cuda.synchronize()
        counts[name] = {k: v for k, v in bk.LAUNCHES.items() if v}
        assert sum(bk.PLAIN_CALLS.values()) == 0
    assert set(counts["default"]) == {"k12m"}
    assert set(counts["qr"]) == {"k12m", "k1", "k2"}
    assert set(counts["mse"]) == {"k12"}
    assert set(counts["fourier qr"]) == {"k12mc", "k1c", "k2c"}


# ---- K2, K2c, K2-split and K2c-split over a thread-block cluster ------------

#: The cluster kernels of the split: K2 and K2c (with the environment
#: advance), K2-split and K2c-split (the dp route's, with Qm)
K2_KEYS = ["k2", "k2_split", "k2c", "k2c_split"]


def _k2_fns(bk, bkc, key):
    """(cluster wrapper, one-block wrapper) of K2, K2-split, K2c or
    K2c-split."""
    mod = bkc if key.startswith("k2c") else bk
    return getattr(mod, f"{key}_cuda"), getattr(mod, f"{key}_block_cuda")


def _k2_operands(bk, bkc, key, seed, forward):
    """K2's (K2c's) operands at the main-path shape: the plain K1's (K1c's,
    q 3) bond tensor, the QR (realified QR) of its Y, the advancing side's
    environment, log-scales and features, the cutoff; K2-split's
    (K2c-split's): the bond tensor, the basis, the cutoff."""
    from mpstime_tpu_torch.ops.decomp import _qr_orth
    cplx = key.startswith("k2c")
    x = (_inputs_c if cplx else _inputs)(seed, 1, **SHAPE)
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                       x["env0"])
    ops = (x["A"][0], x["center"], le, re, x["phil"][0], x["phir"][0],
           x["y1h"], x["w"])
    if cplx:
        BT, Y = bkc.k1c_plain(*ops, x["V0"][0], 0.05, forward=forward,
                              power_iters=3)
    else:
        BT, Y = bk.k1_plain(*ops, x["ls0"], x["V0"][0], 0.05,
                            forward=forward)
    Q = _qr_orth(Y).contiguous()
    if key.endswith("_split"):
        return (BT, Q, 1e-10)
    env, phi = (le, x["phil"][0]) if forward else (re, x["phir"][0])
    return (BT, Q, env, x["ls0"], phi, 1e-10)


def _k2_tie_operands(bk, bkc, key):
    """The tie-break bond (_tie_break) as K2's or K2-split's operands,
    complex64 for K2c and K2c-split: its bond tensor (eta 0), the basis V0,
    the cutoff."""
    A, center, env, ls, phi, y1h, w, V0, cutoff = _tie_break()
    if key.startswith("k2c"):
        A, center, env, phi, V0 = (t.to(torch.complex64)
                                   for t in (A, center, env, phi, V0))
        BT, _ = bkc.k1c_plain(A, center, env, env, phi, phi, y1h, w, V0, 0.0,
                              forward=False, emit_y=False)
    else:
        BT, _ = bk.k1_plain(A, center, env, env, phi, phi, y1h, w, ls, V0,
                            0.0, forward=False, emit_y=False)
    if key.endswith("_split"):
        return (BT, V0, cutoff)
    return (BT, V0, env, ls, phi, cutoff)


@pytest.mark.parametrize("forward,mr", [(False, None), (False, 4),
                                        (True, None), (True, 4),
                                        ("tie-break", None)])
@pytest.mark.parametrize("key", K2_KEYS)
def test_k2_cluster_equals_one_block(bk, bkc, key, forward, mr):
    # K2, K2c, K2-split and K2c-split run the split over a cluster; the
    # one-block kernel is k2_kernel / k2_split_kernel over the same device
    # functions: the same bits, and on the tie-break bond the stable order
    # keeps directions 0..2
    cuda, block = _k2_fns(bk, bkc, key)
    tie = forward == "tie-break"
    if tie:
        forward, args = False, _k2_tie_operands(bk, bkc, key)
    else:
        args = _k2_operands(bk, bkc, key, 44, forward)
    kw = dict(forward=forward, max_rank=mr)
    n0, b0 = bk.LAUNCHES[key], bk.LAUNCHES[f"{key}_block"]
    got = cuda(*args, **kw)
    one = block(*args, **kw)
    torch.cuda.synchronize()
    assert (bk.LAUNCHES[key], bk.LAUNCHES[f"{key}_block"]) == (n0 + 1,
                                                               b0 + 1)
    _equal(got, one)
    if tie:
        assert _kept(got[1], False).tolist() == [True] * 3 + [False] * 3


@pytest.mark.parametrize("key", K2_KEYS)
@pytest.mark.parametrize("forward", [False, True])
def test_k2_kernels_equal_across_cluster_sizes(bk, bkc, key, forward):
    cuda, block = _k2_fns(bk, bkc, key)
    args = _k2_operands(bk, bkc, key, 45, forward)
    ref = block(*args, forward=forward, max_rank=17)
    for n in range(1, 17):
        if bk.cluster_occupancy(key, n, SHAPE["chi"]) >= 1:
            _equal(cuda(*args, forward=forward, max_rank=17, cluster=n), ref)
    torch.cuda.synchronize()


@pytest.mark.parametrize("key", K2_KEYS)
def test_a_k2_cluster_past_the_limit_is_refused(bk, bkc, key):
    """A cluster of 32 blocks: the wrapper refuses it (ValueError), and the
    card refuses the launch itself (RuntimeError); nothing launches, no
    one-block kernel stands in, and the next launch runs."""
    cuda, _ = _k2_fns(bk, bkc, key)
    raw = {"k2": bk._k2, "k2_split": bk._k2_split, "k2c": bkc._k2c,
           "k2c_split": bkc._k2c_split}[key]
    args = _k2_operands(bk, bkc, key, 46, False)
    before = dict(bk.LAUNCHES)
    with pytest.raises(ValueError, match="from 1 to 16"):
        cuda(*args, forward=False, cluster=32)
    with pytest.raises(RuntimeError, match="CUDA error"):
        raw(f"mpst_{key}_cluster_launch", (32,), *args, forward=False,
            max_rank=None)
    assert dict(bk.LAUNCHES) == before
    cuda(*args, forward=False)
    torch.cuda.synchronize()
    assert bk.LAUNCHES[key] == before[key] + 1


def test_fits_launch_no_one_block_k2(bk, monkeypatch):
    """The qr, fourier qr, dp, complex dp and split-tail fits launch K2,
    K2c, K2-split and K2c-split over a cluster only."""
    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch.parallel import make_mesh
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    Xtr, ytr = data["X_train"][:40, :24], data["y_train"][:40]
    opts = mt.MPSOptions(nsweeps=2, chi_max=12, d=3, verbosity=-1,
                         log_level=-1)
    qr = dict(orth_alg="qr", subspace_refresh_every=2)
    bk.reset_counts()
    mt.fit_mps(Xtr, ytr, opts=opts.replace(**qr), device="cuda")
    mt.fit_mps(Xtr, ytr, opts=opts.replace(encoding="fourier", **qr),
               device="cuda")
    mt.fit_mps(Xtr, ytr, opts=opts, mesh=make_mesh(1))
    mt.fit_mps(Xtr, ytr, opts=opts.replace(encoding="fourier"),
               mesh=make_mesh(1))
    monkeypatch.setattr(bk, "SPLIT_TAIL_CHI", 0)
    mt.fit_mps(Xtr, ytr, opts=opts.replace(nsweeps=1), device="cuda")
    torch.cuda.synchronize()
    assert bk.LAUNCHES["k2"] == 2 * 23 + 2 * 23  # qr refresh, split tail
    assert bk.LAUNCHES["k2c"] == 2 * 23
    assert bk.LAUNCHES["k2_split"] == bk.LAUNCHES["k2c_split"] == 2 * 2 * 23
    assert all(bk.LAUNCHES[f"{k}_block"] == 0 for k in K2_KEYS)
    assert sum(bk.PLAIN_CALLS.values()) == 0


# ---- K2-env and K2c-env over row tiles; K1-tail and K1c-tail over a grid ---

#: The rows a K2-env block the card timed (chip_smoke.py's
#: [k2env-k1tail-redesign])
ENV_ROWS = [1, 2, 4, 8, 16, 32]


def _env_operands(bk, bkc, cplx, seed, N, forward):
    """K2-env's (K2c-env's) operands at chi 25: the masked isometry Qm of
    the plain K2-split (K2c-split) of a main-path bond, and the advancing
    side's environment, log-scales and features of N rows."""
    key = "k2c_split" if cplx else "k2_split"
    BT, Q, cutoff = _k2_operands(bk, bkc, key, seed, forward)
    split = bkc.k2c_split_plain if cplx else bk.k2_split_plain
    Qm = split(BT, Q, cutoff, forward=forward, max_rank=None)[2]
    x = (_inputs_c if cplx else _inputs)(seed + 1, 1, **dict(SHAPE, N=N))
    phi = x["phil"][0] if forward else x["phir"][0]
    return Qm.contiguous(), x["env0"], x["ls0"], phi


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("N", [1, 7, 32, 50, 100])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_k2_env_rows_equal_one_block(bk, bkc, cplx, N, forward):
    # K2-env (K2c-env) runs ceil(N / rows) independent blocks of K2-env's
    # body: at every rows a block, a last partial tile included, the one
    # block's bits
    mod, key = (bkc, "k2c_env") if cplx else (bk, "k2_env")
    cuda, block = getattr(mod, f"{key}_cuda"), getattr(mod, f"{key}_block_cuda")
    args = _env_operands(bk, bkc, cplx, 60 + N, N, forward)
    n0, b0 = bk.LAUNCHES[key], bk.LAUNCHES[f"{key}_block"]
    ref = block(*args, forward=forward)
    _equal(cuda(*args, forward=forward), ref)
    for rows in ENV_ROWS:
        _equal(cuda(*args, forward=forward, rows=rows), ref)
    torch.cuda.synchronize()
    assert (bk.LAUNCHES[key], bk.LAUNCHES[f"{key}_block"]) == (
        n0 + 1 + len(ENV_ROWS), b0 + 1)


def _tail_operands(bk, bkc, cplx, seed, chi, forward):
    """A stepped bond tensor (the plain K1's or K1c's without its power
    step, as the split-tail route hands it over) and the sketch V0."""
    x = (_inputs_c if cplx else _inputs)(seed, 1, **dict(SHAPE, chi=chi))
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                       x["env0"])
    ops = (x["A"][0], x["center"], le, re, x["phil"][0], x["phir"][0],
           x["y1h"], x["w"])
    if cplx:
        BT, _ = bkc.k1c_plain(*ops, x["V0"][0], 0.05, forward=forward,
                              emit_y=False)
    else:
        BT, _ = bk.k1_plain(*ops, x["ls0"], x["V0"][0], 0.05,
                            forward=forward, emit_y=False)
    return BT, x["V0"][0]


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("orth,q", [("ns", 1), ("ns", 3), ("qr", 1),
                                    ("qr", 3)])
@pytest.mark.parametrize("chi", [25, 192])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_k1_tail_grid_equals_one_block(bk, bkc, cplx, chi, orth, q,
                                       forward):
    # K1-tail (K1c-tail) runs K1-tail's body over every block of a
    # cooperative grid: at grids of 1, 2, 16, 66 and the most the card
    # holds, the one block's bits
    mod, key = (bkc, "k1c_tail") if cplx else (bk, "k1_tail")
    cuda, block = getattr(mod, f"{key}_cuda"), getattr(mod, f"{key}_block_cuda")
    BT, V0 = _tail_operands(bk, bkc, cplx, 70 + q, chi, forward)
    kw = dict(forward=forward, power_iters=q, orth=orth)
    most = bk.grid_occupancy(key)
    n0, b0 = bk.LAUNCHES[key], bk.LAUNCHES[f"{key}_block"]
    ref = block(BT, V0, **kw)
    _equal([cuda(BT, V0, **kw)], [ref])
    sizes = (1, 2, 16, 66, most)
    for n in sizes:
        _equal([cuda(BT, V0, blocks=n, **kw)], [ref])
    torch.cuda.synchronize()
    assert (bk.LAUNCHES[key], bk.LAUNCHES[f"{key}_block"]) == (
        n0 + 1 + len(sizes), b0 + 1)


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_a_tail_grid_past_the_card_is_refused(bk, bkc, cplx):
    """A grid one block past what the card holds at once: the card refuses
    the cooperative launch (RuntimeError), nothing launches, no one-block
    kernel stands in, and the next launch runs; a grid of 0 blocks is the
    wrapper's ValueError."""
    mod, key = (bkc, "k1c_tail") if cplx else (bk, "k1_tail")
    cuda = getattr(mod, f"{key}_cuda")
    BT, V0 = _tail_operands(bk, bkc, cplx, 80, SHAPE["chi"], False)
    most = bk.grid_occupancy(key)
    assert most >= (bkc.K1C_TAIL_BLOCKS if cplx else bk.K1_TAIL_BLOCKS)
    before = dict(bk.LAUNCHES)
    with pytest.raises(ValueError, match="positive integer"):
        cuda(BT, V0, forward=False, blocks=0)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda(BT, V0, forward=False, blocks=most + 1)
    assert dict(bk.LAUNCHES) == before
    Y = cuda(BT, V0, forward=False)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(Y).all())
    assert bk.LAUNCHES[key] == before[key] + 1


def test_fits_launch_no_one_block_env_or_tail(bk, monkeypatch):
    """The dp, complex dp and split-tail fits and the streamed bond steps
    launch K2-env, K2c-env, K1-tail and K1c-tail as the row-tile and grid
    kernels only."""
    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch.ops import bond_kernels_c as bkc
    from mpstime_tpu_torch.parallel import make_mesh
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    Xtr, ytr = data["X_train"][:40, :24], data["y_train"][:40]
    opts = mt.MPSOptions(nsweeps=2, chi_max=12, d=3, verbosity=-1,
                         log_level=-1)
    bk.reset_counts()
    mt.fit_mps(Xtr, ytr, opts=opts, mesh=make_mesh(1))
    mt.fit_mps(Xtr, ytr, opts=opts.replace(encoding="fourier"),
               mesh=make_mesh(1))
    x, xc = _inputs(90, 1, **SHAPE), _inputs_c(91, 1, **SHAPE)
    bk.bond_step(*_single(x, False), forward=False, stream_tile=32)
    bkc.bond_step_c(*_single(xc, False), forward=False, stream_tile=32)
    monkeypatch.setattr(bk, "SPLIT_TAIL_CHI", 0)
    mt.fit_mps(Xtr, ytr, opts=opts.replace(nsweeps=1), device="cuda")
    mt.fit_mps(Xtr, ytr, opts=opts.replace(nsweeps=1, encoding="fourier"),
               device="cuda")
    torch.cuda.synchronize()
    # a sweep is 46 bonds; the streamed steps 4 tiles of 100 rows
    assert bk.LAUNCHES["k2_env"] == bk.LAUNCHES["k2c_env"] == 2 * 46 + 4
    assert bk.LAUNCHES["k1_tail"] == 46
    assert bk.LAUNCHES["k1c_tail"] == 3 * 46
    assert all(bk.LAUNCHES[f"{k}_block"] == 0
               for k in ("k2_env", "k2c_env", "k1_tail", "k1c_tail"))
    assert sum(bk.PLAIN_CALLS.values()) == 0


# ---- imputation and analysis on the card -----------------------------------

@pytest.fixture(scope="module")
def f64_models():
    """A float64 model fitted on the CPU (ECG200 cut to T = 48, chi 8, d 4,
    2 sweeps), carried to the card with its training set."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mpstime_tpu_torch as mt
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    Xtr, ytr = data["X_train"][:, :48], data["y_train"]
    Xte, yte = data["X_test"][:, :48], data["y_test"]
    cpu, _, _ = mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(
        nsweeps=2, chi_max=8, d=4, verbosity=-1, log_level=-1,
        dtype="float64"), device="cpu")
    card = mt.TrainedMPS.from_numpy(
        cpu.mps.cores.numpy(), cpu.mps.center.numpy(), cpu.mps.center_pos,
        cpu.opts, cpu.norms, cpu.labels, enc_args=cpu.train_data.enc_args,
        device="cuda", X_train=cpu.train_data.X_orig,
        y_train=cpu.labels[cpu.train_data.y_idx])
    return cpu, card, Xte, yte


@pytest.mark.parametrize("method", ["median", "mean", "mode"])
def test_impute_on_the_card_matches_the_cpu_within_a_grid_step(f64_models,
                                                               method):
    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch.imputation import impute_windows
    cpu, card, Xte, yte = f64_models
    dx = 1e-3
    ic = mt.init_imputation_problem(cpu, Xte, yte, verbosity=-1, dx=dx)
    ig = mt.init_imputation_problem(card, Xte, yte, verbosity=-1, dx=dx)
    assert ig.cores_full[0].is_cuda and ig.grid_states[0].is_cuda
    rng = np.random.default_rng(0)
    windows = [mt.mar(Xte[0], p, rng=rng)[1] for p in (0.1, 0.2, 0.3)]
    a, _ = impute_windows(ic, 1, range(8), windows, method,
                          invert_transform=False)
    b, _ = impute_windows(ig, 1, range(8), windows, method,
                          invert_transform=False)
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() <= dx


def test_its_on_the_card_reproduces_under_a_seed(f64_models):
    import mpstime_tpu_torch as mt
    _, card, Xte, yte = f64_models
    ig = mt.init_imputation_problem(card, Xte, yte, verbosity=-1, dx=1e-3)
    sites = mt.mar(Xte[2], 0.2, rng=9)[1]
    kw = dict(NN_baseline=False, get_metrics=False, num_trajectories=3)
    a = mt.mps_impute(ig, 0, 2, sites, "ITS", rseed=5, **kw)[0]
    b = mt.mps_impute(ig, 0, 2, sites, "ITS", rseed=5, **kw)[0]
    c = mt.mps_impute(ig, 0, 2, sites, "ITS", rseed=6, **kw)[0]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert np.abs(a[0] - c[0]).max() > 0
    assert np.isfinite(np.stack(a)).all()


@pytest.mark.parametrize("n", [3, 15])
def test_see_variation_on_the_card_matches_the_cpu(f64_models, n):
    # 15 series at T 48 hand 34560 RDMs to the batched eigensolver, past
    # cuSOLVER's limit of one call (analysis.analyse.EIGH_BATCH)
    import mpstime_tpu_torch as mt
    cpu, card, Xte, _ = f64_models
    np.testing.assert_allclose(mt.see_variation(card, Xte[:n]),
                               mt.see_variation(cpu, Xte[:n]), rtol=0,
                               atol=1e-8)
    for g, w in zip(mt.bipartite_spectrum(card), mt.bipartite_spectrum(cpu)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-8)


# ---- padded fits, serialization, the classifier and the farm on the card ---

def _ecg(T=None):
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    cut = slice(None) if T is None else slice(0, T)
    return (data["X_train"][:, cut], data["y_train"], data["X_test"][:, cut],
            data["y_test"])


def test_padded_fit_runs_k1_and_k2_under_the_rank_cap(bk):
    # pad_to forces orth "qr": every refresh bond K1 -> QR -> K2 with
    # max_rank = chi_max < chi (tests/test_padded.py:115-140)
    import mpstime_tpu_torch as mt
    Xtr, ytr, _, _ = _ecg()
    bk.reset_counts()
    trained, _, _ = mt.fit_mps(Xtr[:40], ytr[:40], device="cuda",
                               opts=mt.MPSOptions(
                                   nsweeps=3, chi_max=10, d=4, pad_to=(16, 6),
                                   verbosity=-1, log_level=-1))
    torch.cuda.synchronize()
    T = trained.mps.T
    assert bk.LAUNCHES["k1"] == bk.LAUNCHES["k2"] == 3 * 2 * (T - 1)
    assert sum(bk.LAUNCHES.values()) == 2 * 3 * 2 * (T - 1)
    assert sum(bk.PLAIN_CALLS.values()) == 0
    c = trained.mps.cores
    assert tuple(c.shape) == (T, 16, 6, 16)
    assert trained.mps.bond_dims().max() <= 10
    share = (c[:, :, 4:, :].abs() ** 2).sum() / (c.abs() ** 2).sum()
    assert float(share) < 1e-7
    preds = mt.classify(trained, Xtr[:40])
    assert float(np.mean(preds == ytr[:40])) > 0.8


def test_padded_bonds_gain_no_more_weight_through_the_kernels(bk):
    """At the full ECG200 size of chip_smoke.py's padded phase (chi 15 under
    25, d 4 under 5), every refresh bond's inputs also go through the plain
    K1 -> QR -> K2: the kernels give the new core the padded-direction
    weight the plain versions give (within 4x plus 1e-8; equal to three
    digits from sweep 2 on, tests/torch_padded_probe.py), and in sweep 1,
    whose inputs carry no padded weight, K1's Y has exactly zero padded
    rows."""
    import torch_padded_probe as probe
    Xtr, ytr, _, _ = _ecg()
    rows = probe.probe_bonds(Xtr, ytr, "kernels", nsweeps=2)
    nbond = 2 * (Xtr.shape[1] - 1)
    assert len(rows) == 2 * nbond
    for r in rows:
        kernel, plain = r[("kernel", "kernel")][1], r[("plain", "plain")][1]
        assert kernel <= 4 * plain + 1e-8
    assert all(r[("kernel", "kernel")][0] for r in rows[:nbond])


def test_save_and_load_on_the_card(bk, tmp_path):
    import mpstime_tpu_torch as mt
    Xtr, ytr, Xte, _ = _ecg()
    trained, _, _ = mt.fit_mps(Xtr, ytr, device="cuda", opts=mt.MPSOptions(
        nsweeps=2, verbosity=-1, log_level=-1))
    path = str(tmp_path / "model.npz")
    mt.save_mps(path, trained)
    on_card = mt.load_mps(path, device="cuda")
    on_cpu = mt.load_mps(path, device="cpu")
    assert on_card.mps.cores.is_cuda and on_card.train_data.X_enc.is_cuda
    assert not on_cpu.mps.cores.is_cuda
    assert mt.trained_mps_equal(trained, on_card, atol=0.0)
    assert mt.trained_mps_equal(on_cpu, on_card, atol=0.0)
    np.testing.assert_array_equal(mt.classify(on_card, Xte),
                                  mt.classify(trained, Xte))


def test_classifier_on_the_card(bk):
    import mpstime_tpu_torch as mt
    Xtr, ytr, Xte, yte = _ecg()
    bk.reset_counts()
    clf = mt.MPSClassifier(nsweeps=2, device="cuda").fit(Xtr, ytr)
    assert clf.trained_.mps.cores.is_cuda
    assert bk.LAUNCHES["k12m"] == 2 * 24 and sum(bk.PLAIN_CALLS.values()) == 0
    np.testing.assert_array_equal(clf.predict(Xte),
                                  mt.classify(clf.trained_, Xte))
    assert 0.5 <= clf.score(Xte, yte) <= 1.0
    assert clf.get_params()["device"] == "cuda"


def test_fit_mps_batch_runs_each_job_through_the_kernels(bk):
    # one fit_mps per job: the default options' K12m, the same bits as the
    # job fit alone; jobs whose chi_max differ share the largest as their
    # width (K1 -> QR -> K2 under each job's own cap)
    import mpstime_tpu_torch as mt
    Xtr, ytr, _, _ = _ecg()
    jobs = [(Xtr[:60], ytr[:60]), (Xtr[40:], ytr[40:])]
    opts = mt.MPSOptions(nsweeps=2, verbosity=-1, log_level=-1)
    bk.reset_counts()
    batch = mt.fit_mps_batch(jobs, opts=opts, device="cuda")
    torch.cuda.synchronize()
    assert bk.LAUNCHES["k12m"] > 0 and sum(bk.PLAIN_CALLS.values()) == 0
    for (X, y), m in zip(jobs, batch):
        alone = mt.fit_mps(X, y, opts=opts, device="cuda")[0]
        assert torch.equal(m.mps.cores, alone.mps.cores)
        assert torch.equal(m.mps.center, alone.mps.center)
    bk.reset_counts()
    capped = mt.fit_mps_batch(jobs, device="cuda", opts_list=[
        opts.replace(chi_max=10), opts.replace(chi_max=6)])
    torch.cuda.synchronize()
    assert bk.LAUNCHES["k1"] == bk.LAUNCHES["k2"] > 0
    for m, chi in zip(capped, (10, 6)):
        assert m.mps.cores.shape[1] == 10 and m.mps.bond_dims().max() <= chi


def test_device_farm_runs_two_fits_at_once_on_one_card(bk, monkeypatch):
    """Two host threads, each on a stream of its own, fit on one card at
    once; with SPLIT_TAIL_CHI = 0 every refresh bond runs K1 -> the
    cooperative K1-tail grid -> K2, so the grid launches while the other
    thread's kernels hold SMs.  Each fit equals the same fit run alone."""
    import mpstime_tpu_torch as mt
    monkeypatch.setattr(bk, "SPLIT_TAIL_CHI", 0)
    Xtr, ytr, _, _ = _ecg()
    opts = mt.MPSOptions(nsweeps=2, verbosity=-1, log_level=-1)

    def job(seed, dev):
        trained, _, _ = mt.fit_mps(Xtr, ytr, device=dev,
                                   opts=opts.replace(init_rng=seed))
        return trained.mps.cores.cpu(), trained.mps.center.cpu()

    alone = [job(s, torch.device("cuda", 0)) for s in (1, 2, 3, 4)]
    bk.reset_counts()
    farm = mt.DeviceFarm(["cuda:0", "cuda:0"])
    together = farm.map(job, [1, 2, 3, 4])
    torch.cuda.synchronize()
    assert bk.LAUNCHES["k1_tail"] > 0
    for (a_cores, a_center), (b_cores, b_center) in zip(alone, together):
        assert torch.equal(a_cores, b_cores) and torch.equal(a_center,
                                                             b_center)


SHAPE3 = dict(C=3, chi=25, d=5, N=90)      # trendysine's bond shape


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh,q,loss,bbopt,mr", [
    (True, 1, "KLD", "TSGO", None), (True, 3, "KLD", "TSGO", None),
    (False, 1, "KLD", "TSGO", None), (True, 1, "MSE", "GD", None),
    (True, 1, "KLD", "TSGO", 17)])
def test_k12_kernel_matches_plain_at_three_classes(bk, forward, refresh, q,
                                                   loss, bbopt, mr):
    x = _inputs(31, 1, **SHAPE3)
    kw = dict(forward=forward, refresh=refresh, power_iters=q, max_rank=mr,
              loss=loss, bbopt=bbopt, opp_ls=x["opp"])
    got = bk.k12_cuda(*_single(x, forward), **kw)
    torch.cuda.synchronize()
    _close(got, bk.k12_plain(*_single(x, forward), **kw))


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh", [True, False])
def test_k12m_kernel_matches_plain_at_three_classes(bk, forward, refresh):
    x = _inputs(32, 8, **SHAPE3)
    kw = dict(forward=forward, refresh=refresh, power_iters=1)
    got = bk.bond_block_steps(*_block(x), **kw)
    torch.cuda.synchronize()
    _close(got, bk.k12m_plain(*_block(x), **kw))


def _trendysine():
    from mpstime_tpu_torch.utils.data_loading import load_ucr_file
    base = Path(__file__).parent / "data"
    return (load_ucr_file(base / "trendysine_TRAIN.tsv")
            + load_ucr_file(base / "trendysine_TEST.tsv"))


def test_three_class_fit_on_cuda_runs_k12m(bk):
    """trendysine (C 3, T 60) at the default options on the card: 8 K12m
    blocks a half-sweep of 59 bonds, no plain call."""
    import mpstime_tpu_torch as mt
    X, y, Xt, yt = _trendysine()
    assert np.bincount(y).tolist() == [30, 30, 30]
    bk.reset_counts()
    trained, _, _ = mt.fit_mps(X, y, opts=mt.MPSOptions(verbosity=-1,
                                                        log_level=-1),
                               device="cuda")
    torch.cuda.synchronize()
    assert {k: v for k, v in bk.LAUNCHES.items() if v} == {"k12m": 160}
    assert sum(bk.PLAIN_CALLS.values()) == 0
    assert trained.mps.center.shape[-1] == 3
    assert bool(torch.isfinite(trained.mps.center).all())
    assert np.mean(mt.classify(trained, X) == y) > 1 / 3


def test_profile_trace_on_cuda_holds_k12m_under_both_scopes(bk, tmp_path):
    import json
    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch.utils.profiling import TRACE_FILE, profile_trace
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    with profile_trace(str(tmp_path)):
        mt.fit_mps(data["X_train"][:40], data["y_train"][:40],
                   opts=mt.MPSOptions(nsweeps=1, chi_max=12, d=3,
                                      verbosity=-1, log_level=-1),
                   device="cuda")
    events = json.loads((tmp_path / TRACE_FILE).read_text())["traceEvents"]
    names = {(e.get("cat"), e.get("name")) for e in events}
    assert ("user_annotation", "mps/backward_bond") in names
    assert ("user_annotation", "mps/forward_bond") in names
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "k12m_cluster_kernel" in e.get("name", "")]
    assert len(kernels) == 2 * 12

"""The four pieces of the dp and batch-tiled bond steps, K1a, K1b, K2-split
and K2-env, as plain PyTorch versions held against the JAX package's Pallas
kernels (``_k1_grad_call``, ``_k1_update_call``, ``_k2_split_call``,
``_k2_env_call``, in interpret mode as tests/test_pallas_bond.py runs them),
and the batch-tiled bond step ``bond_step(stream_tile=)`` against the JAX
package's (tests/test_pallas_bond.py:544-560) and the port's unstreamed bond
step.  The CUDA kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpstime_tpu.ops import pallas_bond
from mpstime_tpu.ops.decomp import warm_sketch_init as jax_sketch
from mpstime_tpu_torch.ops import bond_kernels as bk

torch.set_num_threads(1)

# the per-bond bound of tests/test_pallas_bond.py:73-82 (f32 reassociation)
RTOL, ATOL = 1e-4, 3e-5
# the streamed route's bound (tests/test_pallas_bond.py:559): the tiles'
# gradients sum in another order than one batch's
STREAM_RTOL, STREAM_ATOL = 2e-4, 1e-5
CHI, D, C, N = 6, 3, 2, 13


@pytest.fixture(scope="module")
def interpret():
    pallas_bond.set_interpret(True)
    jax.clear_caches()
    yield
    pallas_bond.set_interpret(False)
    jax.clear_caches()


@pytest.fixture(scope="module")
def bond():
    """One bond's float32 operands (numpy), N = 13 rows."""
    rng = np.random.default_rng(5)
    f32 = np.float32

    def unit_rows(n, m):
        a = rng.standard_normal((n, m))
        return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(f32)

    return dict(
        A=(0.5 * rng.standard_normal((CHI, D, CHI))).astype(f32),
        center=(0.5 * rng.standard_normal((C, CHI, D, CHI))).astype(f32),
        le=unit_rows(N, CHI), re=unit_rows(N, CHI),
        ls=(0.3 * rng.standard_normal(N)).astype(f32),
        opp=(0.3 * rng.standard_normal(N)).astype(f32),
        phil=rng.uniform(-0.9, 0.9, (N, D)).astype(f32),
        phir=rng.uniform(-0.9, 0.9, (N, D)).astype(f32),
        y1h=np.eye(C, dtype=f32)[rng.integers(0, C, N)],
        w=np.full(N, 1.0 / N, f32),
        V0=np.asarray(jax_sketch(CHI * D, CHI, f32)),
        G=(1e-2 * rng.standard_normal((C, CHI * D, D, CHI))).astype(f32),
        Q=np.linalg.qr(rng.standard_normal((CHI * D, CHI)))[0].astype(f32),
        BT=rng.standard_normal((C, CHI * D, D, CHI)).astype(f32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _left_right(x, forward):
    """The JAX calls' (left, right) operands: (center, core) forward,
    (core, center) backward."""
    A, center = jnp.asarray(x["A"]), jnp.asarray(x["center"])
    return (center, A) if forward else (A, center)


def _close(got, ref, rtol=RTOL, atol=ATOL):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r.reshape(g.shape), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("loss", ["KLD", "MSE"])
def test_k1a_plain_matches_pallas_k1a(interpret, bond, forward, loss):
    x = bond
    gls = x["ls"] + x["opp"]
    ref = pallas_bond._k1_grad_call(
        *_left_right(x, forward), *(jnp.asarray(x[k]) for k in
                                    ("le", "re", "phil", "phir", "y1h")),
        jnp.asarray(x["w"])[:, None], jnp.asarray(gls)[:, None], C=C,
        chi=CHI, d=D, forward=forward, loss=loss)
    got = bk.k1a_plain(*(_t(x[k]) for k in ("A", "center", "le", "re", "phil",
                                            "phir", "y1h", "w")),
                       _t(gls), forward=forward, loss=loss)
    assert got.shape == (C, CHI * D, D, CHI)
    _close([got], [ref])


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("emit_y,q,orth,bbopt", [
    (True, 1, "qr", "TSGO"), (True, 3, "ns", "TSGO"), (False, 1, "qr", "GD"),
    (True, 2, "qr", "GD")])
def test_k1b_plain_matches_pallas_k1b(interpret, bond, forward, emit_y, q,
                                      orth, bbopt):
    x = bond
    ref = pallas_bond._k1_update_call(
        jnp.full((1, 1), 0.05, jnp.float32), *_left_right(x, forward),
        jnp.asarray(x["G"]), jnp.asarray(x["V0"]), C=C, chi=CHI, d=D,
        forward=forward, emit_y=emit_y, q=q, orth=orth, bbopt=bbopt)
    got = bk.k1b_plain(_t(x["A"]), _t(x["center"]), _t(x["G"]), _t(x["V0"]),
                       0.05, forward=forward, emit_y=emit_y, power_iters=q,
                       orth=orth, bbopt=bbopt)
    _close(got, ref)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("mr", [None, 4])
def test_k2_split_plain_matches_pallas_k2_split(interpret, bond, forward, mr):
    x = bond
    cut = jnp.asarray([[0.05, CHI if mr is None else mr]], jnp.float32)
    ref = pallas_bond._k2_split_call(cut, jnp.asarray(x["BT"]),
                                     jnp.asarray(x["Q"]), C=C, chi=CHI, d=D,
                                     forward=forward)
    got = bk.k2_split_plain(_t(x["BT"]), _t(x["Q"]), 0.05, forward=forward,
                            max_rank=mr)
    _close(got, ref)
    # the isometry is Q with the dropped directions zeroed
    kept = (got[2] != 0).any(dim=0)
    assert int(kept.sum()) == (CHI if mr is None else mr)
    torch.testing.assert_close(got[2], _t(x["Q"]) * kept, rtol=0, atol=0)


@pytest.mark.parametrize("forward", [False, True])
def test_k2_env_plain_matches_pallas_k2_env(interpret, bond, forward):
    x = bond
    Qm = x["Q"] * (np.arange(CHI) < 4)            # two directions dropped
    env, phi = (x["le"], x["phil"]) if forward else (x["re"], x["phir"])
    ref = pallas_bond._k2_env_call(jnp.asarray(Qm), jnp.asarray(env),
                                   jnp.asarray(x["ls"])[:, None],
                                   jnp.asarray(phi), chi=CHI, d=D,
                                   forward=forward)
    got = bk.k2_env_plain(_t(Qm.astype(np.float32)), _t(env), _t(x["ls"]),
                          _t(phi), forward=forward)
    _close(got, ref)


def test_k1_and_k2_are_their_pieces_chained(bond):
    """K1 = K1a -> K1b and K2 = K2-split -> K2-env, bit for bit."""
    a = {k: _t(v) for k, v in bond.items()}
    for forward in (False, True):
        gls = a["ls"] + a["opp"]
        BT, Y = bk.k1_plain(a["A"], a["center"], a["le"], a["re"], a["phil"],
                            a["phir"], a["y1h"], a["w"], gls, a["V0"], 0.05,
                            forward=forward, loss="MSE")
        G = bk.k1a_plain(a["A"], a["center"], a["le"], a["re"], a["phil"],
                         a["phir"], a["y1h"], a["w"], gls, forward=forward,
                         loss="MSE")
        BT2, Y2 = bk.k1b_plain(a["A"], a["center"], G, a["V0"], 0.05,
                               forward=forward)
        torch.testing.assert_close(BT2, BT, rtol=0, atol=0)
        torch.testing.assert_close(Y2, Y, rtol=0, atol=0)
        env, phi = (a["le"], a["phil"]) if forward else (a["re"], a["phir"])
        out = bk.k2_plain(a["BT"], a["Q"], env, a["ls"], phi, 0.05,
                          forward=forward)
        center, core, Qm = bk.k2_split_plain(a["BT"], a["Q"], 0.05,
                                             forward=forward)
        out2 = (center, core) + bk.k2_env_plain(Qm, env, a["ls"], phi,
                                                forward=forward)
        for g, r in zip(out2, out):
            torch.testing.assert_close(g, r, rtol=0, atol=0)


STREAM_GRID = [  # (refresh, orth, q, loss, bbopt)
    (True, "ns", 3, "KLD", "TSGO"), (True, "qr", 1, "MSE", "TSGO"),
    (False, "qr", 1, "KLD", "GD")]


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh,orth,q,loss,bbopt", STREAM_GRID)
def test_streamed_bond_step_matches_pallas_and_unstreamed(
        interpret, bond, forward, refresh, orth, q, loss, bbopt):
    """13 rows in tiles of 5 (3 tiles, the last 60 % padding): against the
    JAX package's streamed bond step at the per-bond bound, and against the
    port's own unstreamed bond step at the streamed route's bound."""
    x = bond
    names = ("A", "center", "le", "re", "ls", "phil", "phir", "y1h", "w",
             "V0")
    kw = dict(forward=forward, refresh=refresh, power_iters=q, orth=orth,
              loss=loss, bbopt=bbopt)
    ref = pallas_bond.bond_step(*(jnp.asarray(x[k]) for k in names),
                                jnp.float32(0.05), jnp.float32(1e-10),
                                stream_tile=5, opp_ls=jnp.asarray(x["opp"]),
                                **kw)
    args = tuple(_t(x[k]) for k in names) + (0.05, 1e-10)
    bk.reset_counts()
    got = bk.bond_step(*args, stream_tile=5, opp_ls=_t(x["opp"]), **kw)
    assert {k: v for k, v in bk.PLAIN_CALLS.items() if v} == {
        "k1a": 3, "k1b": 1, "k2_split": 1, "k2_env": 3}
    assert [tuple(g.shape) for g in got] == [(C, CHI, D, CHI), (CHI, D, CHI),
                                             (N, CHI), (N,), (CHI * D, CHI)]
    _close(got, ref)
    plain = bk.bond_step(*args, opp_ls=_t(x["opp"]), **kw)
    _close(got, plain, rtol=STREAM_RTOL, atol=STREAM_ATOL)


def test_one_tile_is_the_dp_route_of_one_shard(bond):
    """A tile as large as the batch is one shard: K1a -> K1b -> K2-split ->
    K2-env, which is K1 -> K2 (orth="qr") bit for bit."""
    a = tuple(_t(bond[k]) for k in ("A", "center", "le", "re", "ls", "phil",
                                    "phir", "y1h", "w", "V0"))
    got = bk.bond_step(*a, 0.05, 1e-10, forward=True, stream_tile=N)
    ref = bk.bond_step(*a, 0.05, 1e-10, forward=True)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    with pytest.raises(ValueError, match="stream_tile"):
        bk.bond_step(*a, 0.05, 1e-10, forward=True, stream_tile=0)
    with pytest.raises(ValueError, match="bond_step_dp"):
        bk.bond_step(*a, 0.05, 1e-10, forward=True, axis_name="dp")

"""The port's MPS container, contractions, environments, bond update and
warm splits, held against the JAX package on identical numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpstime_tpu.models import mps as jmps
from mpstime_tpu.ops import bond_update as jbu
from mpstime_tpu.ops import decomp as jdec
from mpstime_tpu.ops import env as jenv
from mpstime_tpu_torch.models import mps as tmps
from mpstime_tpu_torch.ops import bond_update as tbu
from mpstime_tpu_torch.ops import decomp as tdec
from mpstime_tpu_torch.ops import env as tenv

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("T,d,C,chi_init,chi_max,dtype", [
    (8, 3, 2, 4, 6, np.float32), (12, 5, 3, 4, 25, np.float64),
    (5, 2, 1, 3, 8, np.float32), (96, 5, 2, 4, 25, np.float32)])
def test_random_mps_bit_identical(T, d, C, chi_init, chi_max, dtype):
    j = jmps.random_mps(1234, T, d, C, chi_init, chi_max, dtype=dtype)
    t = tmps.random_mps(1234, T, d, C, chi_init, chi_max, dtype=dtype,
                        device="cpu")
    np.testing.assert_array_equal(t.cores.numpy(), np.asarray(j.cores))
    np.testing.assert_array_equal(t.center.numpy(), np.asarray(j.center))
    assert t.center_pos == j.center_pos == T - 1
    assert (t.T, t.chi, t.d, t.num_classes) == (T, chi_max, d, C)


def _states(seed, N, T, d):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.9, 0.9, (N, T, d))


@pytest.mark.parametrize("T,d,C,chi", [(10, 3, 2, 6), (16, 4, 3, 8)])
def test_build_left_envs_matches_jax_f64(T, d, C, chi):
    m = jmps.random_mps(5, T, d, C, 4, chi, dtype=np.float64)
    phis = np.swapaxes(_states(1, 9, T, d), 0, 1).copy()       # [T, N, d]
    LEj, lsj = jenv.build_left_envs(m.cores, jnp.asarray(phis))
    LEt, lst = tenv.build_left_envs(_t(np.asarray(m.cores)), _t(phis))
    # f64, same contraction order: rtol 1e-10
    np.testing.assert_allclose(LEt.numpy(), np.asarray(LEj), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(lst.numpy(), np.asarray(lsj), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("center_pos", [0, 4, 9])
def test_contract_batch_scaled_matches_jax_f64(center_pos):
    T, d, C, chi, N = 10, 3, 2, 6, 11
    rng = np.random.default_rng(3)
    cores = rng.standard_normal((T, chi, d, chi))
    center = rng.standard_normal((chi, d, chi, C))
    phis = _states(4, N, T, d)
    yj, lj = jmps._contract_batch(jnp.asarray(cores), jnp.asarray(center),
                                  center_pos, jnp.asarray(phis))
    m = tmps.MPS.from_numpy(cores, center, center_pos, device="cpu")
    yt, lt = tmps.contract_batch_scaled(m, _t(phis))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10,
                               atol=1e-12)
    yj_true = jmps.contract_batch(jmps.MPS(jnp.asarray(cores),
                                           jnp.asarray(center), center_pos),
                                  jnp.asarray(phis))
    np.testing.assert_allclose(tmps.contract_batch(m, _t(phis)).numpy(),
                               np.asarray(yj_true), rtol=1e-10, atol=1e-14)


def test_expand_label_index_and_normalize_match_jax():
    j = jmps.random_mps(9, 7, 3, 3, 4, 5, dtype=np.float64)
    t = tmps.MPS.from_numpy(np.asarray(j.cores), np.asarray(j.center),
                            j.center_pos, device="cpu")
    for sj, st in zip(jmps.expand_label_index(j), tmps.expand_label_index(t)):
        np.testing.assert_allclose(st.center.numpy(), np.asarray(sj.center),
                                   rtol=1e-12)
    np.testing.assert_allclose(t.normalize().center.numpy(),
                               np.asarray(j.normalize().center), rtol=1e-12)
    assert abs(float(t.norm()) - float(j.norm())) < 1e-12


def test_mps_from_numpy_checks_layouts():
    with pytest.raises(ValueError):
        tmps.MPS.from_numpy(np.zeros((4, 3, 2, 3)), np.zeros((3, 2, 4, 2)), 3,
                            device="cpu")
    with pytest.raises(ValueError):
        tmps.MPS.from_numpy(np.zeros((4, 3, 2)), np.zeros((3, 2, 3, 2)), 3,
                            device="cpu")


@pytest.mark.parametrize("side", ["left", "right"])
def test_env_steps_match_jax_f64(side):
    rng = np.random.default_rng(11)
    v, core, phi = (rng.standard_normal((7, 5)),
                    rng.standard_normal((5, 3, 5)), rng.standard_normal((7, 3)))
    ls = rng.standard_normal(7)
    fj = getattr(jenv, f"env_step_{side}_scaled")
    ft = getattr(tenv, f"env_step_{side}_scaled")
    vj, lj = fj(jnp.asarray(v), jnp.asarray(ls), jnp.asarray(core),
                jnp.asarray(phi))
    vt, lt = ft(_t(v), _t(ls), _t(core), _t(phi))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-10)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10)
    np.testing.assert_array_equal(
        tenv.boundary_env(3, 4, torch.float64).numpy(),
        np.asarray(jenv.boundary_env(3, 4, jnp.float64)))


def _bond(seed, chi=5, d=3, C=2, N=9):
    rng = np.random.default_rng(seed)
    return dict(
        BT=rng.standard_normal((chi, d, d, chi, C)),
        le=rng.standard_normal((N, chi)), re=rng.standard_normal((N, chi)),
        phl=rng.uniform(-0.8, 0.8, (N, d)), phr=rng.uniform(-0.8, 0.8, (N, d)),
        y1h=np.eye(C)[rng.integers(0, C, N)], w=np.full(N, 1.0 / N),
        ls=0.2 * rng.standard_normal(N))


@pytest.mark.parametrize("loss", ["KLD", "MSE"])
def test_loss_grad_matches_jax_f64(loss):
    b = _bond(21)
    fj = jbu.kld_loss_grad if loss == "KLD" else jbu.mse_loss_grad
    ft = tbu.kld_loss_grad if loss == "KLD" else tbu.mse_loss_grad
    keys = ("BT", "le", "re", "phl", "phr", "y1h", "w", "ls")
    lj, gj = fj(*(jnp.asarray(b[k]) for k in keys))
    lt, gt = ft(*(_t(b[k]) for k in keys))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-10)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("loss,bbopt", [("KLD", "TSGO"), ("KLD", "GD"),
                                        ("MSE", "TSGO"), ("MSE", "GD")])
def test_apply_update_matches_jax_f64(loss, bbopt):
    b = _bond(22)
    keys = ("BT", "le", "re", "phl", "phr", "y1h", "w", "ls")
    kw = dict(eta=0.05, loss=loss, bbopt=bbopt, update_iters=1,
              rescale=(False, True))
    _, BTj = jbu.apply_update(*(jnp.asarray(b[k]) for k in keys), **kw)
    _, BTt = tbu.apply_update(*(_t(b[k]) for k in keys), **kw)
    np.testing.assert_allclose(BTt.numpy(), np.asarray(BTj), rtol=1e-10,
                               atol=1e-12)


def test_apply_update_rejects_unported_optimisers():
    # CGD (Polak-Ribiere, normalised step) is ported: held against JAX in
    # f64 over three iterations, the first of which has no previous
    # direction; names outside {KLD, MSE, MIXED} x {TSGO, GD, CGD} raise
    b = _bond(23)
    keys = ("BT", "le", "re", "phl", "phr", "y1h", "w", "ls")
    kw = dict(eta=0.1, bbopt="CGD", update_iters=3)
    lj, BTj = jbu.apply_update(*(jnp.asarray(b[k]) for k in keys), **kw)
    lt, BTt = tbu.apply_update(*(_t(b[k]) for k in keys), **kw)
    np.testing.assert_allclose(BTt.numpy(), np.asarray(BTj), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-10)
    args = tuple(_t(b[k]) for k in keys)
    for bad in (dict(bbopt="adam"), dict(loss="hinge")):
        with pytest.raises(ValueError):
            tbu.apply_update(*args, eta=0.1, **bad)


@pytest.mark.parametrize("n,keep,dtype", [(15, 5, np.float32), (24, 8, np.float64),
                                          (4, 6, np.float32)])
def test_warm_sketch_init_bit_identical(n, keep, dtype):
    j = np.asarray(jdec.warm_sketch_init(n, keep, dtype))
    t = tdec.warm_sketch_init(n, keep, dtype).numpy()
    np.testing.assert_array_equal(t, j)


def test_trunc_mask_and_ns_orth_match_jax():
    rng = np.random.default_rng(31)
    w = np.sort(rng.uniform(0, 1, 12))[::-1].copy()
    w[7:] = 0.0
    for cutoff, mr in ((1e-10, None), (0.05, None), (1e-10, 5)):
        np.testing.assert_array_equal(
            tdec._trunc_mask(_t(w), 10, cutoff, mr).numpy(),
            np.asarray(jdec._trunc_mask(jnp.asarray(w), 10, cutoff, mr)))
    Y = rng.standard_normal((20, 6))
    Qt = tdec.ns_orth(_t(Y)).numpy()
    np.testing.assert_allclose(Qt, np.asarray(jdec.ns_orth(jnp.asarray(Y))),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(Qt.T @ Qt, np.eye(6), atol=1e-10)
    Qr = tdec._qr_orth(_t(Y)).numpy()
    np.testing.assert_allclose(Qr.T @ Qr, np.eye(6), atol=1e-12)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("refresh,q,mr", [(True, 1, None), (True, 3, None),
                                          (False, 1, None), (True, 1, 4)])
def test_warm_split_matches_jax_f64(side, refresh, q, mr):
    rng = np.random.default_rng(41)
    M = rng.standard_normal((18, 12)) if side == "left" \
        else rng.standard_normal((12, 18))
    V0 = np.asarray(jdec.warm_sketch_init(12, 6, np.float64))
    fj = getattr(jdec, f"warm_split_{side}")
    ft = getattr(tdec, f"warm_split_{side}")
    kw = dict(q=q, refresh=refresh, max_rank=mr, orth="ns")
    outj = fj(jnp.asarray(M), jnp.asarray(V0), 6, 1e-10, **kw)
    outt = ft(_t(M), _t(V0), 6, 1e-10, **kw)
    for a, b in zip(outt, outj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                   atol=1e-10)


@pytest.mark.parametrize("side", ["left", "right"])
def test_warm_split_defaults_match_jax_f64(side):
    # both packages at their own defaults (orth, q, refresh, max_rank
    # omitted): the port's orth default is JAX's "qr"; with "ns" in the port
    # the outputs differed by up to 6.32 (US) and 0.862 (Vh, V_next)
    rng = np.random.default_rng(43)
    M = rng.standard_normal((40, 30))
    V0 = np.asarray(jdec.warm_sketch_init(30 if side == "left" else 40, 8,
                                          np.float64))
    fj = getattr(jdec, f"warm_split_{side}")
    ft = getattr(tdec, f"warm_split_{side}")
    outj = fj(jnp.asarray(M), jnp.asarray(V0), 8, 1e-10)
    outt = ft(_t(M), _t(V0), 8, 1e-10)
    for a, b in zip(outt, outj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)

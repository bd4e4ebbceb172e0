"""The port's unfused route, the counterpart of the JAX package's XLA bond
step: the splits of ops/decomp.py (gram_eigh, svd, randomized, lean), the
whole of apply_update (CGD, the mixed loss, update_iters, the rescales),
build_right_envs, whole fits through each route, the per-bond cost trace,
and the training summaries, held against the JAX package in float64.

Tolerances: one function on identical f64 inputs agrees to rtol 1e-10 (the
same arithmetic in another summation order).  An eigendecomposition or SVD
fixes each direction only up to its sign, and the two packages' LAPACK
builds (MKL here) pick signs differently at small sizes, so split factors
are compared after aligning each direction's sign.  Whole fits carry that
sign choice into their cores (a gauge), so they are compared on what the
gauge leaves alone: the contracted outputs on test series, the KLD trace
and the predictions."""

import io
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpstime_tpu as mj
import mpstime_tpu_torch as mt
from mpstime_tpu.models import mps as jmps
from mpstime_tpu.ops import bond_update as jbu
from mpstime_tpu.ops import decomp as jdec
from mpstime_tpu.ops import env as jenv
from mpstime_tpu_torch.models import mps as tmps
from mpstime_tpu_torch.ops import bond_kernels as bk
from mpstime_tpu_torch.ops import bond_update as tbu
from mpstime_tpu_torch.ops import decomp as tdec
from mpstime_tpu_torch.ops import env as tenv

torch.set_num_threads(1)

EXACT = dict(rtol=1e-10, atol=1e-12)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape,dtype", [((24, 12), np.float64),
                                         ((18, 6), np.float32),
                                         ((9, 4), np.complex128)])
def test_fixed_sketch_bit_identical(shape, dtype):
    np.testing.assert_array_equal(tdec._fixed_sketch(shape, dtype).numpy(),
                                  np.asarray(jdec._fixed_sketch(shape, dtype)))


def test_sketch_k_matches_jax():
    for keep in (1, 4, 8, 25, 64, 100):
        for other in (3, 12, 30, 125, 1000):
            assert tdec._sketch_k(keep, other) == jdec._sketch_k(keep, other)


@pytest.mark.parametrize("orth,q", [("qr", 2), ("ns", 1)])
def test_power_orth_matches_jax_f64(orth, q):
    rng = np.random.default_rng(3)
    M = rng.standard_normal((20, 14))
    Y0 = rng.standard_normal((14, 5))
    got = tdec._power_orth(lambda Y: _t(M).T @ (_t(M) @ Y), _t(Y0), q, orth)
    ref = jdec._power_orth(lambda Y: jnp.asarray(M).T @ (jnp.asarray(M) @ Y),
                           jnp.asarray(Y0), q, orth)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **EXACT)


def _aligned(got, ref, side):
    """The split factors (A [R, keep], B [keep, C]) of ``got`` with each
    direction's sign turned to agree with ``ref``'s (eigh and SVD fix a
    direction up to its sign; masked directions are zero in both)."""
    basis_t, basis_r = (got[1].T, ref[1].T) if side == "left" \
        else (got[0], ref[0])
    s = np.sign(np.sum(basis_t * basis_r, axis=0))
    s[s == 0] = 1.0
    return got[0] * s, got[1] * s[:, None]


def _split_case(side, shape, keep):
    rng = np.random.default_rng(17)
    R, C = shape
    M = rng.standard_normal((R, C) if side == "left" else (C, R))
    M[:, -1] *= 1e-6                  # a direction near the cutoff
    return M, keep


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("alg", ["gram_eigh", "svd"])
@pytest.mark.parametrize("shape,keep,mr", [((18, 12), 5, None),
                                           ((18, 6), 8, 3)])
def test_split_bond_matches_jax_f64(side, alg, shape, keep, mr):
    M, keep = _split_case(side, shape, keep)
    fj = getattr(jdec, f"split_bond_{side}")
    ft = getattr(tdec, f"split_bond_{side}")
    ref = [np.asarray(r) for r in fj(jnp.asarray(M), keep, 1e-10, alg,
                                     max_rank=mr)]
    got = [g.numpy() for g in ft(_t(M), keep, 1e-10, alg, max_rank=mr)]
    assert [g.shape for g in got] == [r.shape for r in ref]
    for g, r in zip(_aligned(got, ref, side), ref):
        np.testing.assert_allclose(g, r, **EXACT)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("orth,mr", [("qr", None), ("ns", 3)])
def test_randomized_split_matches_jax_f64(side, orth, mr):
    """keep 4 of 30 columns: sketch width 12 < 30, so the sketched power
    iteration and the Rayleigh-Ritz eigh run (not the gram_eigh fallback)."""
    rng = np.random.default_rng(19)
    M = rng.standard_normal((24, 30) if side == "left" else (30, 24))
    fj = getattr(jdec, f"randomized_split_{side}")
    ft = getattr(tdec, f"randomized_split_{side}")
    ref = [np.asarray(r) for r in fj(jnp.asarray(M), 4, 1e-10, max_rank=mr,
                                     orth=orth)]
    got = [g.numpy() for g in ft(_t(M), 4, 1e-10, max_rank=mr, orth=orth)]
    for g, r in zip(_aligned(got, ref, side), ref):
        np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("side", ["left", "right"])
def test_randomized_split_falls_back_to_gram_eigh_like_jax(side):
    # keep 25 of 30: the sketch would be as wide as the matrix
    rng = np.random.default_rng(23)
    M = rng.standard_normal((40, 30) if side == "left" else (30, 40))
    ref = [np.asarray(r) for r in getattr(jdec, f"randomized_split_{side}")(
        jnp.asarray(M), 25, 1e-10)]
    got = [g.numpy() for g in getattr(tdec, f"randomized_split_{side}")(
        _t(M), 25, 1e-10)]
    for g, r in zip(_aligned(got, ref, side), ref):
        np.testing.assert_allclose(g, r, **EXACT)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("orth,keep,mr", [("qr", 5, None), ("ns", 5, 3),
                                          ("qr", 14, None)])
def test_lean_split_matches_jax_f64(side, orth, keep, mr):
    """QR or NS only, no eigh: on a full-rank M both packages' orthonormal
    bases agree column for column, so the factors are compared as they
    are (keep 14 > 12: the padded case)."""
    rng = np.random.default_rng(29)
    M = rng.standard_normal((18, 12) if side == "left" else (12, 18))
    fj = getattr(jdec, f"lean_split_{side}")
    ft = getattr(tdec, f"lean_split_{side}")
    ref = fj(jnp.asarray(M), keep, 1e-10, max_rank=mr, orth=orth)
    got = ft(_t(M), keep, 1e-10, max_rank=mr, orth=orth)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9,
                                   atol=1e-11)


def _bond(seed, chi=5, d=3, C=2, N=9):
    rng = np.random.default_rng(seed)
    return dict(
        BT=rng.standard_normal((chi, d, d, chi, C)),
        le=rng.standard_normal((N, chi)), re=rng.standard_normal((N, chi)),
        phl=rng.uniform(-0.8, 0.8, (N, d)), phr=rng.uniform(-0.8, 0.8, (N, d)),
        y1h=np.eye(C)[rng.integers(0, C, N)], w=np.full(N, 1.0 / N),
        ls=0.2 * rng.standard_normal(N))


BOND_KEYS = ("BT", "le", "re", "phl", "phr", "y1h", "w", "ls")


@pytest.mark.parametrize("loss,bbopt,iters,rescale", [
    ("KLD", "CGD", 3, (False, True)), ("MSE", "CGD", 2, (False, True)),
    ("MIXED", "TSGO", 1, (False, True)), ("MIXED", "CGD", 3, (True, True)),
    ("KLD", "TSGO", 3, (False, True)), ("KLD", "GD", 1, (False, False)),
    ("KLD", "TSGO", 1, (True, False)), ("MSE", "GD", 3, (True, True))])
def test_apply_update_matches_jax_f64(loss, bbopt, iters, rescale):
    b = _bond(22)
    kw = dict(eta=0.05, loss=loss, bbopt=bbopt, update_iters=iters,
              rescale=rescale)
    lj, BTj = jbu.apply_update(*(jnp.asarray(b[k]) for k in BOND_KEYS), **kw)
    lt, BTt = tbu.apply_update(*(_t(b[k]) for k in BOND_KEYS), **kw)
    np.testing.assert_allclose(BTt.numpy(), np.asarray(BTj), **EXACT)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-10)


def test_bond_yhat_and_mixed_loss_grad_match_jax_f64():
    b = _bond(24)
    np.testing.assert_allclose(
        tbu.bond_yhat(*(_t(b[k]) for k in BOND_KEYS[:5])).numpy(),
        np.asarray(jbu.bond_yhat(*(jnp.asarray(b[k]) for k in BOND_KEYS[:5]))),
        **EXACT)
    lj, gj = jbu.mixed_loss_grad(*(jnp.asarray(b[k]) for k in BOND_KEYS),
                                 alpha=3.0)
    lt, gt = tbu.mixed_loss_grad(*(_t(b[k]) for k in BOND_KEYS), alpha=3.0)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-10)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **EXACT)


@pytest.mark.parametrize("T,d,C,chi", [(10, 3, 2, 6), (16, 4, 3, 8)])
def test_build_right_envs_matches_jax_f64(T, d, C, chi):
    m = jmps.random_mps(5, T, d, C, 4, chi, dtype=np.float64)
    phis = np.random.default_rng(1).uniform(-0.9, 0.9, (T, 9, d))
    REj, lsj = jenv.build_right_envs(m.cores, jnp.asarray(phis))
    REt, lst = tenv.build_right_envs(_t(m.cores), _t(phis))
    np.testing.assert_allclose(REt.numpy(), np.asarray(REj), **EXACT)
    np.testing.assert_allclose(lst.numpy(), np.asarray(lsj), **EXACT)


# ---- whole fits -----------------------------------------------------------

FIT_OPTS = dict(chi_max=8, d=3, nsweeps=2, verbosity=-1, log_level=1,
                dtype="float64")


@pytest.fixture(scope="module")
def fit_data(ecg200):
    Xtr, ytr, Xte, yte = ecg200
    return Xtr[:30, :32], ytr[:30], Xte[:40, :32], yte[:40]


def _fits(fit_data, **kw):
    Xtr, ytr, Xte, yte = fit_data
    opts = {**FIT_OPTS, **kw}
    jf = mj.fit_mps(Xtr, ytr, Xte, yte, mj.MPSOptions(**opts))
    bk.reset_counts()
    tf = mt.fit_mps(Xtr, ytr, Xte, yte, mt.MPSOptions(**opts), device="cpu")
    assert sum(bk.PLAIN_CALLS.values()) == 0     # the unfused route
    return jf, tf


@pytest.fixture(scope="module")
def summary_fits(fit_data):
    """The default (gram_eigh) fits, shared by the fit and summary tests."""
    return _fits(fit_data)


def _contracted(pkg_fit, Xte, jax_side):
    if jax_side:
        from mpstime_tpu.summary import _encode_test
        y, ls = jmps.contract_batch_scaled(pkg_fit.mps,
                                           _encode_test(pkg_fit, Xte).X_enc)
        return np.asarray(y), np.asarray(ls)
    from mpstime_tpu_torch.summary import _encode_test
    y, ls = tmps.contract_batch_scaled(pkg_fit.mps,
                                       _encode_test(pkg_fit, Xte).X_enc)
    return y.numpy(), ls.numpy()


@pytest.mark.parametrize("kw", [
    dict(), dict(svd_alg="svd"), dict(bbopt="CGD", update_iters=3),
    dict(loss_grad="MSE", bbopt="GD"), dict(loss_grad="Mixed"),
    dict(update_iters=2, rescale=(True, True)), dict(rescale=(True, False)),
    dict(rescale=(False, False), track_cost=True)],
    ids=["gram_eigh", "svd", "cgd", "mse_gd", "mixed", "iters2_rescale_tt",
         "rescale_tf", "rescale_ff_track_cost"])
def test_unfused_fit_matches_jax_f64(request, fit_data, kw):
    """Two f64 sweeps through each eigh-based configuration (the CPU
    default split is gram_eigh).  Compared on the gauge invariants: the
    contracted test outputs and their log-scales at rtol 1e-3 / atol 1e-4
    (the whole-fit bound of tests/test_torch_slice.py; measured at most
    1.5e-5 relative, for the mixed loss), the train and test KLD after each
    sweep at rtol 1e-4, the per-bond cost trace at rtol 1e-6, identical
    predictions."""
    Xte = fit_data[2]
    (jf, ji, _), (tf, ti, _) = (_fits(fit_data, **kw) if kw else
                                request.getfixturevalue("summary_fits"))
    for a, b in zip(_contracted(tf, Xte, False), _contracted(jf, Xte, True)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    for key in ("train_KL_div", "test_KL_div", "train_acc", "test_acc"):
        np.testing.assert_allclose(ti[key], ji[key], rtol=1e-4)
    if kw.get("track_cost"):
        assert len(ti["bond_costs"]) == 2
        for a, b in zip(ti["bond_costs"], ji["bond_costs"]):
            assert a.shape == (2 * 31,)
            np.testing.assert_allclose(a, b, rtol=1e-6)
    else:
        assert "bond_costs" not in ti
    np.testing.assert_array_equal(mt.classify(tf, Xte), mj.classify(jf, Xte))


#: Full-rank bonds (chi_max = d = chi_init = 3): the QR-based routes agree
#: trajectory for trajectory there (rank-deficient bonds: ROADMAP.md queue 3).
FULL_RANK = dict(chi_max=3, d=3, chi_init=3)


@pytest.mark.parametrize("kw", [
    dict(svd_alg="randomized_lean", orth_alg="qr"),
    dict(svd_alg="randomized_lean", orth_alg="ns"),
    dict(svd_alg="randomized_warm", orth_alg="ns", **FULL_RANK)],
    ids=["lean_qr", "lean_ns", "warm_ns"])
def test_qr_and_ns_sketch_fits_match_jax_f64(fit_data, kw):
    """The sketch routes without an eigh, two f64 sweeps, raw cores at
    rtol 1e-3 / atol 1e-4 and identical predictions (measured at most
    2.4e-7 apart in max |cores|)."""
    Xte = fit_data[2]
    (jf, _, _), (tf, _, _) = _fits(fit_data, **{**FULL_RANK, **kw})
    np.testing.assert_allclose(tf.mps.cores.numpy(), np.asarray(jf.mps.cores),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tf.mps.center.numpy(),
                               np.asarray(jf.mps.center), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_array_equal(mt.classify(tf, Xte), mj.classify(jf, Xte))


def test_randomized_fit_tracks_jax_f64(fit_data):
    """The randomized route sketches every bond with one fixed Gaussian
    matrix, which does not turn with the sign the previous bond's Ritz
    eigh chose; the two packages' eigh signs differ (MKL vs the JAX
    package's LAPACK), so their trajectories part after the first such
    bond (ROADMAP.md queue 3), though each split agrees up to sign
    (test_randomized_split_matches_jax_f64).  The fits are held on what
    they learn, as f32 fits are in tests/test_torch_slice.py: train and
    test KLD after each sweep within 10 % (measured within 1 %)."""
    (_, ji, _), (_, ti, _) = _fits(fit_data, svd_alg="randomized")
    for key in ("train_KL_div", "test_KL_div"):
        np.testing.assert_allclose(ti[key], ji[key], rtol=0.10)


# ---- summaries ------------------------------------------------------------

def test_get_training_summary_matches_jax(summary_fits):
    """Predictions agree, so the counts agree exactly; the overlap matrix
    <psi_i|psi_j> is gauge invariant, rtol 1e-6."""
    (jf, _, jts), (tf, _, tts) = summary_fits
    sj = mj.get_training_summary(jf, jts)
    out = io.StringIO()
    import contextlib
    with contextlib.redirect_stdout(out):
        st = mt.get_training_summary(tf, tts, print_stats=True)
    assert "Confusion matrix" in out.getvalue()
    assert set(st) == set(sj)
    np.testing.assert_array_equal(st["confmat"], sj["confmat"])
    np.testing.assert_allclose(st["overlapmat"], sj["overlapmat"], rtol=1e-6)
    for k in ("train_acc", "test_acc", "test_balanced_acc", "precision",
              "recall", "specificity", "f1_score"):
        assert st[k] == pytest.approx(sj[k], abs=1e-12), k


def test_classify_overlap_kl_div_and_predictions_match_jax(summary_fits,
                                                           fit_data):
    from mpstime_tpu.summary import classify_overlap as j_overlap
    from mpstime_tpu.training.stats import predict_class_indices as j_pred
    from mpstime_tpu_torch.training.stats import predict_class_indices
    (jf, _, jts), (tf, _, tts) = summary_fits
    pj, lj = j_overlap(jmps.expand_label_index(jf.mps), jts.X_enc)
    pt, lt = mt.classify_overlap(tmps.expand_label_index(tf.mps), tts.X_enc)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_allclose(lt, lj, rtol=1e-6)
    np.testing.assert_array_equal(predict_class_indices(tf.mps, tts.X_enc),
                                  j_pred(jf.mps, jts.X_enc))
    assert mt.KL_div(tf, tts) == pytest.approx(mj.KL_div(jf, jts), rel=1e-6)


def test_overlap_matrix_matches_jax_with_center_inside_f64():
    rng = np.random.default_rng(31)
    cores = rng.standard_normal((7, 4, 3, 4))
    centers = rng.standard_normal((3, 4, 3, 4))
    from mpstime_tpu.summary import _overlap_matrix as j_ov
    from mpstime_tpu_torch.summary import _overlap_matrix as t_ov
    for pos in (0, 3, 6):
        np.testing.assert_allclose(
            t_ov(_t(cores), _t(centers), center_pos=pos).numpy(),
            np.asarray(j_ov(jnp.asarray(cores), jnp.asarray(centers),
                            center_pos=pos)), **EXACT)


def test_sweep_summary_prints_like_jax(summary_fits):
    (_, ji, _), (_, ti, _) = summary_fits
    for info in (ji, ti, {}):
        a, b = io.StringIO(), io.StringIO()
        mj.sweep_summary(info, out=a)
        mt.sweep_summary(info, out=b)
        assert b.getvalue() == a.getvalue()
    assert "After Sweep 2" in b.getvalue() or info == {}


def test_entry_points_default_to_the_card():
    from mpstime_tpu_torch.encodings import encode_dataset
    for fn in (mt.fit_mps, mt.TrainedMPS.from_numpy, tmps.MPS.from_numpy,
               tmps.random_mps, encode_dataset):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn

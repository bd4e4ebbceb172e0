"""The port's imputation (mpstime_tpu_torch.imputation) held against the JAX
package's on the same trained model: a float64 JAX fit of ECG200 cut to
T = 48 (chi 8, d 4, 2 sweeps), and a complex128 fourier fit of the same
size, carried across with ``TrainedMPS.from_numpy(..., X_train=,
y_train=)``, imputed by both packages on a guess grid of dx = 1e-3 on the
CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpstime_tpu as mj
import mpstime_tpu_torch as mt
from mpstime_tpu.imputation import engine as jengine
from mpstime_tpu.imputation import problem as jproblem
from mpstime_tpu_torch.imputation import engine as tengine
from mpstime_tpu_torch.imputation import problem as tproblem

torch.set_num_threads(1)

DX = 1e-3
T = 48
OPTS = dict(nsweeps=2, chi_max=8, d=4, verbosity=-1, log_level=0,
            dtype="float64")


def _convert(jt):
    return mt.TrainedMPS.from_numpy(
        np.asarray(jt.mps.cores), np.asarray(jt.mps.center),
        jt.mps.center_pos, jt.opts.to_json(), jt.norms.to_dict(), jt.labels,
        enc_args=jt.train_data.enc_args, device="cpu",
        X_train=jt.train_data.X_orig,
        y_train=jt.labels[jt.train_data.y_idx])


@pytest.fixture(scope="module")
def data(ecg200):
    Xtr, ytr, Xte, yte = ecg200
    return Xtr[:, :T], ytr, Xte[:, :T], yte


@pytest.fixture(scope="module")
def models(data):
    Xtr, ytr, _, _ = data
    jt, _, _ = mj.fit_mps(Xtr, ytr, opts=mj.MPSOptions(**OPTS))
    return jt, _convert(jt)


@pytest.fixture(scope="module")
def imps(models, data):
    _, _, Xte, yte = data
    jt, tt = models
    return (mj.init_imputation_problem(jt, Xte, yte, verbosity=-1, dx=DX),
            mt.init_imputation_problem(tt, Xte, yte, verbosity=-1, dx=DX))


def _sites(data, inst, p, seed):
    return mt.mar(data[2][inst], p, rng=seed)[1]


def test_converted_model_carries_the_training_set(models):
    jt, tt = models
    np.testing.assert_array_equal(tt.train_data.y_idx, jt.train_data.y_idx)
    np.testing.assert_array_equal(tt.train_data.X_orig, jt.train_data.X_orig)
    np.testing.assert_allclose(tt.train_data.X_enc.numpy(),
                               np.asarray(jt.train_data.X_enc), rtol=0,
                               atol=1e-13)
    assert tt.train_data.X_enc.dtype == torch.float64


@pytest.mark.parametrize("order", ["forwards", "backwards"])
@pytest.mark.parametrize("method,kw", [
    ("median", {}), ("mean", {}), ("mode", {}),
    ("mode", dict(max_jump=0.05))])
@pytest.mark.parametrize("cls,inst,p,seed", [(0, 3, 0.2, 42), (1, 5, 0.3, 7)])
def test_estimators_match_jax(imps, data, method, kw, order, cls, inst, p,
                              seed):
    ji, ti = imps
    sites = _sites(data, inst, p, seed)
    xj, ej, _ = jproblem.get_predictions(ji, cls, inst, sites, method,
                                         impute_order=order,
                                         invert_transform=False, **kw)
    xt, et, _ = tproblem.get_predictions(ti, cls, inst, sites, method,
                                         impute_order=order,
                                         invert_transform=False, **kw)
    # every imputed site on JAX's grid point (mean: its expectation)
    assert np.abs(xt[0] - xj[0]).max() < DX / 2
    if method == "mean":
        np.testing.assert_allclose(xt[0], xj[0], rtol=1e-9, atol=1e-12)
    if ej[0] is None:
        assert et[0] is None
    else:
        np.testing.assert_allclose(et[0], ej[0], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("method", ["median", "mean"])
def test_mps_impute_in_data_units_matches_jax(imps, data, method):
    ji, ti = imps
    sites = _sites(data, 7, 0.25, 3)
    tj, ej, gj, sj, _ = mj.mps_impute(ji, 1, 7, sites, method,
                                      NN_baseline=True, n_baselines=2,
                                      full_metrics=True)
    tt, et, gt, st, _ = mt.mps_impute(ti, 1, 7, sites, method,
                                      NN_baseline=True, n_baselines=2,
                                      full_metrics=True)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_allclose(tt[0], tj[0], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(et[0], ej[0], rtol=1e-9, atol=1e-12)
    assert st[0].keys() == sj[0].keys()
    for k in sj[0]:
        np.testing.assert_allclose(st[0][k], sj[0][k], rtol=1e-9)


def test_get_cdfs_match_jax(imps, data):
    ji, ti = imps
    sites = _sites(data, 3, 0.2, 21)
    cj, xj, ej, gj = mj.get_cdfs(ji, 0, 3, sites)
    ct, xt, et, gt = mt.get_cdfs(ti, 0, 3, sites)
    assert ct.shape == (len(sites), len(ti.grid_x))
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(xt[0], xj[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(et[0], ej[0], rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(gt, gj)
    # each cdf is monotone 0 -> 1
    assert np.all(np.diff(ct, axis=1) >= -1e-12)
    np.testing.assert_allclose(ct[:, -1], 1.0, atol=1e-9)


@pytest.mark.parametrize("method", ["median", "mean", "mode"])
def test_impute_batch_matches_single_instance_and_jax(imps, data, method):
    ji, ti = imps
    sites = _sites(data, 0, 0.2, 3)
    ts, targets = tproblem.impute_batch(ti, 0, [0, 1, 2], sites, method)
    tj, targets_j = jproblem.impute_batch(ji, 0, [0, 1, 2], sites, method)
    assert ts.shape == targets.shape == (3, T)
    np.testing.assert_array_equal(targets, targets_j)
    np.testing.assert_allclose(ts, tj, rtol=1e-9, atol=1e-12)
    for b in range(3):
        single, _, target, _, _ = mt.mps_impute(
            ti, 0, b, sites, method, get_metrics=False, NN_baseline=False)
        np.testing.assert_allclose(ts[b], single[0], rtol=1e-12, atol=1e-13)
        np.testing.assert_array_equal(targets[b], target)


@pytest.mark.parametrize("method", ["median", "mean", "mode"])
def test_impute_windows_matches_impute_batch_and_jax(imps, data, method):
    ji, ti = imps
    rng = np.random.default_rng(5)
    windows = [mt.mar(data[2][0], p, rng=rng)[1] for p in (0.1, 0.2, 0.3)]
    inst = [0, 1, 2, 3, 4]
    ts_w, targets_w = tproblem.impute_windows(ti, 1, inst, windows, method,
                                              pad_b_to=4)
    tj_w, targets_jw = jproblem.impute_windows(ji, 1, inst, windows, method,
                                               pad_b_to=4)
    assert ts_w.shape == (3, 5, T)
    np.testing.assert_allclose(ts_w, tj_w, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(targets_w, targets_jw)
    for iw, sites in enumerate(windows):
        ts_b, targets_b = tproblem.impute_batch(ti, 1, inst, sites, method)
        np.testing.assert_allclose(ts_w[iw], ts_b, rtol=1e-12, atol=1e-13)
        np.testing.assert_array_equal(targets_w, targets_b)
    scaled, _ = tproblem.impute_windows(ti, 1, inst, windows, method,
                                        invert_transform=False)
    scaled_j, _ = jproblem.impute_windows(ji, 1, inst, windows, method,
                                          invert_transform=False)
    assert np.abs(scaled - scaled_j).max() < DX / 2


@pytest.mark.parametrize("invert", [True, False])
def test_knn_and_flat_baseline_equal_jax(imps, data, invert):
    ji, ti = imps
    sites = _sites(data, 0, 0.2, 17)
    for a, b in zip(mt.kNN_impute(ti, 1, 0, sites, k=3),
                    mj.kNN_impute(ji, 1, 0, sites, k=3)):
        np.testing.assert_array_equal(a, b)
    for method in ("kNearestNeighbour", "flatBaseline"):
        xt, _, gt = tproblem.get_predictions(ti, 1, 0, sites, method, k=2,
                                             invert_transform=invert)
        xj, _, gj = jproblem.get_predictions(ji, 1, 0, sites, method, k=2,
                                             invert_transform=invert)
        for a, b in zip(xt, xj):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(gt, gj)


@pytest.mark.parametrize("err_scale", [0.01, 0.3, 3.0])
def test_error_bar_salvage_matches_jax(models, capsys, err_scale):
    # scaled values near the top of the domain: error bars of 0.3 and 3.0
    # push err + ts past the sigmoid's domain, which the salvage loop NaNs
    jt, tt = models
    ts = np.linspace(-0.2, 0.97, T)
    err = err_scale * np.abs(np.sin(np.arange(T)))
    salvaged = 0
    for oob in ([], [(0, -0.05, 1.1)]):
        a = tproblem._invert_with_salvage(ts, err, oob, tt.norms, tt.opts,
                                          verbosity=0)
        b = jproblem._invert_with_salvage(ts, err, oob, jt.norms, jt.opts,
                                          verbosity=0)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=1e-13, atol=0)
        salvaged += bool(np.isnan(a).any())
    # 0.01 stays inside the domain unless the out-of-bounds rescale pushes
    # it out; the larger bars leave it either way
    assert salvaged == (1 if err_scale < 0.1 else 2)
    # each salvage warns once in each package
    assert capsys.readouterr().out.count("Warning") == 2 * salvaged


def test_time_dependent_backwards_mean_matches_jax(data):
    """The mean's re-encoding under backwards uses the ORIGINAL site's
    basis (T-1-t) of a time-dependent encoding (sahand_legendre_time_
    dependent), as the JAX package's reverse_t."""
    Xtr, ytr, Xte, yte = data
    jt, _, _ = mj.fit_mps(Xtr[:60], ytr[:60], opts=mj.MPSOptions(
        **{**OPTS, "encoding": "SLTD", "nsweeps": 1}))
    tt = _convert(jt)
    ji = mj.init_imputation_problem(jt, Xte, yte, verbosity=-1, dx=DX)
    ti = mt.init_imputation_problem(tt, Xte, yte, verbosity=-1, dx=DX)
    assert ti.timedep and ti.grid_states[0].shape == (T, len(ti.grid_x), 4)
    sites = _sites(data, 6, 0.2, 13)
    for order in ("forwards", "backwards"):
        xj, ej, _ = jproblem.get_predictions(ji, 0, 6, sites, "mean",
                                             impute_order=order)
        xt, et, _ = tproblem.get_predictions(ti, 0, 6, sites, "mean",
                                             impute_order=order)
        np.testing.assert_allclose(xt[0], xj[0], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(et[0], ej[0], rtol=1e-9, atol=1e-12)


def _jax_cdf_given(ji, ci, scaled, known_mask, t):
    """JAX's conditional cdf at missing site t, every other missing site
    before t conditioned on the value in ``scaled`` as a known site."""
    kern, cores = ji.kernel(ci, "median", want_cdf=True, get_err=False)
    km = known_mask.copy()
    phis = mj.encodings.encode_series(scaled, ji.opts, ji.enc_args,
                                      dtype=np.float64)
    res = kern(cores, jnp.conj(phis), jnp.asarray(km), jnp.asarray(scaled),
               float("nan"), jax.random.PRNGKey(0))
    return np.asarray(res.cdfs)[t]


def test_its_selection_follows_the_uniforms_and_jax_cdfs(imps, data):
    ji, ti = imps
    sites = np.sort(_sites(data, 2, 0.15, 9))
    target = ti.X_test[np.where(ti.y_test == 0)[0][2]]
    filled = target.copy()
    filled[sites] = np.mean(ti.X_train)
    scaled, _ = mt.transform_test_data(filled, ti.norms, ti.opts)
    known = np.ones(T, bool)
    known[sites] = False
    u = torch.from_numpy(np.random.default_rng(3).random((1, T)))
    res = ti.run(0, "its", "forwards", ti.encode_rows(scaled[None], 0).conj(),
                 known, ti.tensor(scaled[None]), ti.tensor([np.nan]),
                 uniforms=u, want_cdf=True, get_err=False)
    xs, cdfs = res.x_samps[0].numpy(), res.cdfs[0].numpy()
    cond = scaled.copy()
    for j, t in enumerate(sites):
        # the inverse-transform rule on the port's own cdf
        k = np.argmin(np.abs(cdfs[t] - u[0, t].item()))
        assert xs[t] == ti.grid_x[k]
        # the port's cdf is JAX's, conditioned on the port's earlier draws
        km = known.copy()
        km[sites[:j]] = True
        np.testing.assert_allclose(
            cdfs[t], _jax_cdf_given(ji, 0, cond, km, t), rtol=0, atol=1e-10)
        cond[t] = xs[t]


def test_its_rejection_rule_matches_a_numpy_reference():
    rng = np.random.default_rng(0)
    G, B, d, trials = 301, 4, 3, 5
    grid = np.linspace(-1, 1, G)
    S = np.stack([np.ones(G), grid, grid ** 2 - 0.3], axis=1)
    Y = rng.standard_normal((B, d, d))
    rdm = Y @ Y.transpose(0, 2, 1)
    u = rng.random((B, trials))
    x, k, wmad, cdf = tengine._estimate(
        "its", torch.from_numpy(rdm), torch.from_numpy(S),
        torch.from_numpy(grid), 2 / (G - 1), torch.full((B,), np.nan),
        torch.from_numpy(u), get_err=False, max_jump=None,
        rejection_threshold=0.5)
    for b in range(B):
        probs = np.maximum(np.einsum("gi,ij,gj->g", S, rdm[b], S), 0)
        c = np.asarray(jengine._cumtrapz(jnp.asarray(probs), 2 / (G - 1)))
        Z = c[-1]
        np.testing.assert_allclose(cdf[b].numpy(), c / Z, rtol=1e-13,
                                   atol=1e-15)
        kmed = np.argmin(np.abs(c / Z - 0.5))
        w = float(jengine._weighted_median_abs_dev(
            jnp.asarray(grid), jnp.asarray(probs / Z), grid[kmed]))
        np.testing.assert_allclose(wmad[b].item(), w, rtol=1e-13)
        kk = [np.argmin(np.abs(c / Z - uj)) for uj in u[b]]
        ok = [abs(grid[j] - grid[kmed]) < 0.5 * w for j in kk]
        want = kk[ok.index(True)] if any(ok) else kk[-1]
        assert k[b].item() == want and x[b].item() == grid[want]


def test_its_seeds(imps, data):
    _, ti = imps
    sites = _sites(data, 2, 0.2, 9)
    kw = dict(NN_baseline=False, get_metrics=False)
    ts = mt.mps_impute(ti, 0, 2, sites, "ITS", num_trajectories=3, rseed=5,
                       **kw)[0]
    again = mt.mps_impute(ti, 0, 2, sites, "ITS", num_trajectories=3,
                          rseed=5, **kw)[0]
    one = mt.mps_impute(ti, 0, 2, sites, "ITS", rseed=5, **kw)[0]
    other = mt.mps_impute(ti, 0, 2, sites, "ITS", rseed=6, **kw)[0]
    assert len(ts) == 3
    for a, b in zip(ts, again):
        np.testing.assert_array_equal(a, b)
    # a run of three starts with the trajectory a run of one draws
    np.testing.assert_array_equal(ts[0], one[0])
    assert np.abs(ts[0] - ts[1]).max() > 0
    assert np.abs(ts[0] - other[0]).max() > 0
    rej = mt.mps_impute(ti, 0, 2, sites, "ITS", rseed=5,
                        rejection_threshold=2.5, **kw)[0]
    assert np.isfinite(rej[0]).all()
    w, _ = tproblem.impute_windows(ti, 0, [0, 1], [sites, sites[:4]], "ITS",
                                   rejection_threshold=2.5)
    w2, _ = tproblem.impute_windows(ti, 0, [0, 1], [sites, sites[:4]], "ITS",
                                    rejection_threshold=2.5)
    assert np.isfinite(w).all()
    np.testing.assert_array_equal(w, w2)


def test_sample_trajectories_match_training_distribution():
    # trained on phase-randomised sines (tests/test_imputation.py:234-254):
    # samples are in range and share the dominant frequency
    rng = np.random.default_rng(0)
    Tn, n = 40, 60
    t = np.linspace(0, 4 * np.pi, Tn)
    X = np.sin(t[None] + rng.uniform(0, 2 * np.pi, (n, 1))) \
        + 0.05 * rng.standard_normal((n, Tn))
    jt, _, _ = mj.fit_mps(X, np.zeros(n, int), opts=mj.MPSOptions(
        nsweeps=4, chi_max=12, d=4, verbosity=-1, dtype="float64",
        log_level=0))
    traj = mt.sample_trajectories(_convert(jt), n=3, rseed=7)
    assert traj.shape == (3, Tn)
    assert np.isfinite(traj).all()
    assert traj.min() >= X.min() - 0.3 and traj.max() <= X.max() + 0.3
    f_tr = np.abs(np.fft.rfft(X, axis=1))[:, 1:].mean(0).argmax()
    f_s = np.abs(np.fft.rfft(traj, axis=1))[:, 1:].mean(0).argmax()
    assert f_tr == f_s
    np.testing.assert_array_equal(
        traj, mt.sample_trajectories(_convert(jt), n=3, rseed=7))


def test_guess_range_matches_jax(models, data):
    jt, tt = models
    _, _, Xte, yte = data
    kw = dict(verbosity=-1, guess_range=(-0.5, 0.5), dx=DX)
    ji = mj.init_imputation_problem(jt, Xte, yte, **kw)
    ti = mt.init_imputation_problem(tt, Xte, yte, **kw)
    np.testing.assert_array_equal(ti.grid_x, ji.grid_x)
    sites = _sites(data, 1, 0.2, 1)
    a = mt.mps_impute(ti, 0, 1, sites, "median", NN_baseline=False)[0][0]
    b = mj.mps_impute(ji, 0, 1, sites, "median", NN_baseline=False)[0][0]
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def test_error_surfaces(imps, models, data):
    _, ti = imps
    jt, tt = models
    _, _, Xte, yte = data
    sites = _sites(data, 0, 0.2, 1)
    with pytest.raises(ValueError, match="unknown class"):
        ti.class_index(42)
    with pytest.raises(ValueError, match="unknown class"):
        mt.mps_impute(ti, 42, 0, sites, "median")
    with pytest.raises(ValueError, match="Invalid method"):
        mt.mps_impute(ti, 0, 0, sites, "bogus")
    with pytest.raises(ValueError, match="impute_order"):
        mt.mps_impute(ti, 0, 0, sites, "median", impute_order="sideways")
    # a corrupted training encoding fails the re-encoding check
    bad = dataclasses.replace(tt, train_data=dataclasses.replace(
        tt.train_data, X_enc=tt.train_data.X_enc + 0.1))
    with pytest.raises(RuntimeError, match="reproduce"):
        mt.init_imputation_problem(bad, Xte, yte, verbosity=-1)
    # weights converted without their training set cannot impute
    bare = mt.TrainedMPS.from_numpy(
        np.asarray(jt.mps.cores), np.asarray(jt.mps.center),
        jt.mps.center_pos, jt.opts.to_json(), jt.norms.to_dict(), jt.labels,
        device="cpu")
    with pytest.raises(ValueError, match="X_train="):
        mt.init_imputation_problem(bare, Xte, yte, verbosity=-1)
    with pytest.raises(TypeError, match="TrainedMPS"):
        mt.sample_trajectories(jt)


def test_float32_model_imputes_close_to_float64(models, imps, data):
    """The same weights in single precision on the CPU: the scan runs in
    float32 (grid, cdfs and environments) and lands within a few grid steps
    of the float64 scan."""
    _, ti = imps
    _, tt = models
    _, _, Xte, yte = data
    t32 = mt.TrainedMPS.from_numpy(
        tt.mps.cores.numpy().astype(np.float32),
        tt.mps.center.numpy().astype(np.float32), tt.mps.center_pos,
        tt.opts.replace(dtype="float32"), tt.norms, tt.labels,
        enc_args=tt.train_data.enc_args, device="cpu",
        X_train=tt.train_data.X_orig, y_train=tt.labels[tt.train_data.y_idx])
    i32 = mt.init_imputation_problem(t32, Xte, yte, verbosity=-1, dx=DX)
    assert i32.grid.dtype == torch.float32
    sites = _sites(data, 0, 0.2, 3)
    for method in ("median", "mean", "mode"):
        a, _ = tproblem.impute_batch(i32, 0, range(6), sites, method,
                                     invert_transform=False)
        b, _ = tproblem.impute_batch(ti, 0, range(6), sites, method,
                                     invert_transform=False)
        # within one grid step (a near-tie of the cdf or the density may
        # move by one) plus float32's rounding of the grid values
        assert np.abs(a - b).max() <= DX + 1e-6, method


# ---- the complex (fourier, complex128) model --------------------------------

C_OPTS = dict(OPTS, encoding="fourier", dtype="complex128")
C_ATOL = 1e-12


@pytest.fixture(scope="module")
def cimps(data):
    """A complex128 fourier model (T 48, chi 8, d 4, 2 sweeps) fitted by the
    JAX package and carried across; both problems at dx 1e-3."""
    Xtr, ytr, Xte, yte = data
    jt, _, _ = mj.fit_mps(Xtr, ytr, opts=mj.MPSOptions(**C_OPTS))
    tt = _convert(jt)
    assert tt.mps.dtype == torch.complex128
    return (mj.init_imputation_problem(jt, Xte, yte, verbosity=-1, dx=DX),
            mt.init_imputation_problem(tt, Xte, yte, verbosity=-1, dx=DX))


@pytest.mark.parametrize("method", ["median", "mean", "mode"])
def test_complex_estimators_match_jax(cimps, data, method):
    ji, ti = cimps
    sites = _sites(data, 4, 0.25, 11)
    for cls in (0, 1):
        xj, ej, _ = jproblem.get_predictions(ji, cls, 4, sites, method,
                                             invert_transform=False)
        xt, et, _ = tproblem.get_predictions(ti, cls, 4, sites, method,
                                             invert_transform=False)
        np.testing.assert_allclose(xt[0], xj[0], rtol=0, atol=C_ATOL)
        if ej[0] is not None:
            np.testing.assert_allclose(et[0], ej[0], rtol=0, atol=C_ATOL)


def test_complex_impute_batch_and_cdfs_match_jax(cimps, data):
    ji, ti = cimps
    sites = _sites(data, 0, 0.2, 5)
    for method in ("median", "mean"):
        ts, targets = tproblem.impute_batch(ti, 1, [0, 1, 2], sites, method)
        tj, targets_j = jproblem.impute_batch(ji, 1, [0, 1, 2], sites, method)
        np.testing.assert_array_equal(targets, targets_j)
        np.testing.assert_allclose(ts, tj, rtol=0, atol=C_ATOL)
    ct, xt, _, gt = mt.get_cdfs(ti, 0, 2, sites)
    cj, xj, _, gj = mj.get_cdfs(ji, 0, 2, sites)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=C_ATOL)
    np.testing.assert_allclose(xt[0], xj[0], rtol=0, atol=C_ATOL)
    np.testing.assert_array_equal(gt, gj)

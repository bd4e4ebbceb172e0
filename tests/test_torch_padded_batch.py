"""The port's padded trials (``MPSOptions.pad_to``) and batched fits
(``fit_mps_batch``) held against the JAX package on the CPU.

Padding: ``random_mps(pad_d=)`` bit for bit, the zero-padded encodings, a
float64 padded fit against ``mpstime_tpu.fit_mps`` (the rank cap, dead
padded directions), the float32 fit through the plain versions of K1 -> QR
-> K2 (the card's route), and imputation of a padded model.  Batched fits:
each member of a batch against its own batch of one, the batch against
``fit_mps`` of each job alone, and ``fit_mps_batch`` against the JAX
package's.  ECG200 cut to T <= 32, chi <= 10, 1-2 sweeps."""

import numpy as np
import pytest
import torch

import mpstime_tpu as mj
import mpstime_tpu_torch as mt
from mpstime_tpu.training.stats import loss_acc_conf as jax_stats
from mpstime_tpu_torch.ops import bond_kernels as bk
from mpstime_tpu_torch.training.stats import loss_acc_conf as port_stats

torch.set_num_threads(1)

F64 = dict(verbosity=-1, log_level=-1, dtype="float64")


@pytest.fixture(scope="module")
def data(ecg200):
    Xtr, ytr, Xte, yte = ecg200
    return Xtr[:30, :32], ytr[:30], Xte[:, :32], yte


def _kld(model, stats):
    return stats(model.mps, model.train_data.X_enc, model.train_data.y_idx)[1]


def _dead_share(cores, d):
    c = np.abs(cores.cpu().numpy() if isinstance(cores, torch.Tensor)
               else np.asarray(cores)) ** 2
    return c[:, :, d:, :].sum() / c.sum()


# ---- padding ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
@pytest.mark.parametrize("pad_d", [None, 3, 6])
def test_random_mps_pad_d_bit_for_bit(dtype, pad_d):
    kw = dict(dtype=dtype, pad_d=pad_d)
    j = mj.random_mps(7, 12, 3, 2, 4, 9, **kw)
    t = mt.random_mps(7, 12, 3, 2, 4, 9, device="cpu", **kw)
    np.testing.assert_array_equal(t.cores.numpy(), np.asarray(j.cores))
    np.testing.assert_array_equal(t.center.numpy(), np.asarray(j.center))
    assert t.d == (3 if pad_d is None else pad_d)


@pytest.mark.parametrize("enc", ["legendre", "fourier", "sahand_legendre"])
def test_padded_encodings_match_jax(data, enc):
    Xtr, ytr, Xte, _ = data
    kw = dict(d=3, chi_max=8, pad_to=(8, 5), encoding=enc,
              dtype="complex128" if enc == "fourier" else "float64")
    jo, to = mj.MPSOptions(**kw), mt.MPSOptions(**kw)
    jX, _, _, _ = mj.transform_data(Xtr, Xte, jo)
    tX, _, _, _ = mt.transform_data(Xtr, Xte, to)
    jd = mj.encode_dataset(Xtr, jX, ytr, jo)
    td = mt.encode_dataset(Xtr, tX, ytr, to, device="cpu")
    assert tuple(td.X_enc.shape) == (30, 32, 5)
    np.testing.assert_allclose(td.X_enc.numpy(), np.asarray(jd.X_enc),
                               rtol=0, atol=1e-14)
    assert float(td.X_enc[..., 3:].abs().max()) == 0.0
    from mpstime_tpu.encodings.pipeline import encode_series as jax_series
    from mpstime_tpu_torch.encodings.pipeline import encode_series
    np.testing.assert_allclose(
        encode_series(tX[0], to, td.enc_args, device="cpu").numpy(),
        np.asarray(jax_series(jX[0], jo, jd.enc_args)), rtol=0, atol=1e-14)
    empty = mt.encode_dataset(Xtr[:0], tX[:0], ytr[:0], to, device="cpu")
    assert tuple(empty.X_enc.shape) == tuple(np.asarray(
        mj.encode_dataset(Xtr[:0], jX[:0], ytr[:0], jo).X_enc).shape)


@pytest.fixture(scope="module")
def padded_fits(data):
    """One sweep, chi_max 6 under the cap 10, d 3 padded to 4, float64, the
    CPU's default split (gram_eigh), in both packages."""
    Xtr, ytr, _, _ = data
    kw = dict(nsweeps=1, chi_max=6, d=3, pad_to=(10, 4), **F64)
    return (mj.fit_mps(Xtr, ytr, opts=mj.MPSOptions(**kw))[0],
            mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(**kw), device="cpu")[0])


def test_padded_fit_matches_jax_f64(padded_fits, data):
    """The cores differ by the eigenvectors' signs (MKL and LAPACK), so the
    gauge-free outputs are held: the train KLD within 1e-9 relative (7e-15
    measured) and the same predictions; the cap and the dead padded
    directions hold in both."""
    jm, tm = padded_fits
    _, _, Xte, _ = data
    assert tuple(tm.mps.cores.shape) == np.asarray(jm.mps.cores).shape \
        == (32, 10, 4, 10)
    assert _kld(tm, port_stats) == pytest.approx(_kld(jm, jax_stats),
                                                 rel=1e-9)
    np.testing.assert_array_equal(mt.classify(tm, Xte), mj.classify(jm, Xte))
    np.testing.assert_array_equal(tm.mps.bond_dims(), jm.mps.bond_dims())
    assert tm.mps.bond_dims().max() <= 6
    assert _dead_share(tm.mps.cores, 3) < 1e-15
    assert _dead_share(jm.mps.cores, 3) < 1e-15


def test_padded_ns_fit_matches_jax_cores(data):
    # padding d only (and the samples to a multiple of 8): the warm split
    # under ns agrees with JAX's to rounding, cores included (2.5e-11
    # measured); a padded chi under ns is chaotic in both (the eps revival
    # of dead directions), which is why pad_to resolves orth "qr"
    Xtr, ytr, _, _ = data
    kw = dict(nsweeps=1, chi_max=6, d=3, pad_to=(6, 4), svd_alg=
              "randomized_warm", orth_alg="ns", **F64)
    jm = mj.fit_mps(Xtr, ytr, opts=mj.MPSOptions(**kw))[0]
    tm = mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(**kw), device="cpu")[0]
    np.testing.assert_allclose(tm.mps.cores.numpy(), np.asarray(jm.mps.cores),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(tm.mps.center.numpy(),
                               np.asarray(jm.mps.center), rtol=0, atol=1e-9)
    assert mt.MPSOptions(chi_max=8, pad_to=(8, 5)).resolved_orth_alg(
        "cuda") == "qr"


def test_padded_f32_fit_runs_k1_and_k2_with_the_cap(ecg200):
    """The card's padded route on the CPU: float32, the warm split, orth
    "qr" (forced by pad_to, never NS) -> every refresh bond the plain
    versions of K1 -> QR -> K2 with max_rank = chi_max < chi
    (tests/test_padded.py:115-140)."""
    Xtr, ytr, _, _ = ecg200
    opts = mt.MPSOptions(nsweeps=3, chi_max=10, d=4, pad_to=(16, 6),
                         svd_alg="randomized_warm", verbosity=-1,
                         log_level=-1)
    assert opts.resolved_orth_alg("cpu") == opts.resolved_orth_alg("cuda") \
        == "qr"
    bk.reset_counts()
    trained, _, _ = mt.fit_mps(Xtr[:40], ytr[:40], opts=opts, device="cpu")
    T = trained.mps.T
    assert bk.PLAIN_CALLS["k1"] == bk.PLAIN_CALLS["k2"] == 3 * 2 * (T - 1)
    assert sum(bk.PLAIN_CALLS.values()) == 2 * 3 * 2 * (T - 1)
    assert tuple(trained.mps.cores.shape) == (T, 16, 6, 16)
    assert trained.mps.bond_dims().max() <= 10
    assert _dead_share(trained.mps.cores, 4) < 1e-7
    assert float(np.mean(mt.classify(trained, Xtr[:40]) == ytr[:40])) > 0.8


@pytest.mark.parametrize("method", ["median", "mean"])
def test_padded_model_imputes_as_jax(padded_fits, data, method):
    # a JAX padded model carried across imputes at the padded width, the
    # mean re-encoding its estimate at d and padding it
    jm, _ = padded_fits
    _, _, Xte, yte = data
    tm = mt.TrainedMPS.from_numpy(
        np.asarray(jm.mps.cores), np.asarray(jm.mps.center),
        jm.mps.center_pos, jm.opts.to_json(), jm.norms.to_dict(), jm.labels,
        device="cpu", X_train=jm.train_data.X_orig,
        y_train=jm.labels[jm.train_data.y_idx])
    ji = mj.init_imputation_problem(jm, Xte, yte, verbosity=-1, dx=1e-3)
    ti = mt.init_imputation_problem(tm, Xte, yte, verbosity=-1, dx=1e-3)
    assert ti.grid_states[0].shape[-1] == 4
    sites = mt.mar(Xte[3], 0.25, rng=2)[1]
    a = mt.mps_impute(ti, 0, 3, sites, method, NN_baseline=False)[0][0]
    b = mj.mps_impute(ji, 0, 3, sites, method, NN_baseline=False)[0][0]
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


# ---- fit_mps_batch -----------------------------------------------------------

JOB_OPTS = [dict(eta=0.01, chi_max=8, init_rng=1),
            dict(eta=0.05, chi_max=6, init_rng=2),
            dict(eta=0.02, chi_max=7, init_rng=3)]


def _jobs(ecg200, T=32):
    X, y = ecg200[0][:, :T], ecg200[1]
    return [(X[:40], y[:40]), (X[30:66], y[30:66]), (X[60:100], y[60:100])]


@pytest.fixture(scope="module")
def batch_fits(ecg200):
    base = dict(nsweeps=1, chi_max=8, d=3, **F64)
    jobs = _jobs(ecg200)
    return (jobs, mj.fit_mps_batch(jobs, opts_list=[
                mj.MPSOptions(**{**base, **v}) for v in JOB_OPTS]),
            mt.fit_mps_batch(jobs, opts_list=[
                mt.MPSOptions(**{**base, **v}) for v in JOB_OPTS],
                device="cpu"))


def test_fit_mps_batch_matches_jax(batch_fits, ecg200):
    """Three jobs that differ in eta, chi_max and init_rng, one sweep in
    float64 at the CPU's default split: each model's train KLD within 1e-5
    relative of JAX's (6.1e-7 measured; the eigenvectors' signs differ
    between MKL and LAPACK, so the cores are not compared), its rank cap,
    and the test-set predictions (at most 2 of 100 apart)."""
    jobs, J, P = batch_fits
    Xte = ecg200[2][:, :32]
    for (X, y), j, p, v in zip(jobs, J, P, JOB_OPTS):
        assert tuple(p.mps.cores.shape) == (32, 8, 3, 8)
        assert p.opts.chi_max == v["chi_max"] and p.opts.eta == v["eta"]
        assert _kld(p, port_stats) == pytest.approx(_kld(j, jax_stats),
                                                    rel=1e-5)
        assert p.mps.bond_dims().max() <= v["chi_max"]
        assert np.sum(mt.classify(p, Xte) != mj.classify(j, Xte)) <= 2
        np.testing.assert_array_equal(p.train_data.y_idx, j.train_data.y_idx)
        assert float(p.mps.norm()) == pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize("kw", [
    dict(), dict(svd_alg="randomized_warm", orth_alg="ns"),
    dict(svd_alg="randomized_warm", orth_alg="qr", subspace_refresh_every=2),
    dict(svd_alg="svd", loss_grad="MSE"), dict(bbopt="CGD", update_iters=2),
    dict(svd_alg="randomized_lean", train_classes_separately=True),
    dict(encoding="fourier", dtype="complex128",
         svd_alg="randomized_warm_ritz", ritz_exact_sweeps=1),
    dict(dtype="float32", svd_alg="randomized_warm", pad_to=(9, 4))],
    ids=["gram_eigh", "warm-ns", "warm-qr-frozen", "svd-mse", "cgd",
         "lean-separately", "ritz-complex", "padded-f32"])
def test_each_batch_member_equals_its_own_batch(ecg200, kw):
    # no model leaks into another: per-model eta, cutoff and rank cap
    base = {**F64, "nsweeps": 2, "chi_max": 8, "d": 3, **kw}
    jobs = _jobs(ecg200, T=16)
    opts = [mt.MPSOptions(**{**base, **v}) for v in JOB_OPTS]
    together = mt.fit_mps_batch(jobs, opts_list=opts, device="cpu")
    # alone, a job takes the batch's chi (the largest chi_max) as pad_to
    caps = (max(o.chi_max for o in opts), opts[0].d)
    for job, o, m in zip(jobs, opts, together):
        alone = mt.fit_mps_batch(
            [job], opts_list=[o.replace(pad_to=o.pad_to or caps)],
            device="cpu")[0]
        assert torch.equal(m.mps.cores, alone.mps.cores)
        assert torch.equal(m.mps.center, alone.mps.center)
        assert torch.isfinite(m.mps.center).all()
        assert m.mps.bond_dims().max() <= o.chi_max


def test_fit_mps_batch_runs_the_fit_route_and_checks_its_jobs(ecg200):
    """Jobs that share their chi_max train as fit_mps trains each alone, on
    its route: the same bits and, on the CPU, the same calls of the bond
    kernels' plain versions (on the card, the same kernels)."""
    jobs = _jobs(ecg200, T=12)
    opts = mt.MPSOptions(nsweeps=1, chi_max=6, d=3, verbosity=-1,
                         log_level=-1, svd_alg="randomized_warm")
    bk.reset_counts()
    out = mt.fit_mps_batch(jobs, opts=opts, device="cpu")
    batch_calls = dict(bk.PLAIN_CALLS)
    bk.reset_counts()
    alone = [mt.fit_mps(X, y, opts=opts, device="cpu")[0] for X, y in jobs]
    assert batch_calls == dict(bk.PLAIN_CALLS)
    assert sum(batch_calls.values()) > 0
    for m, a in zip(out, alone):
        assert m.opts is opts
        assert torch.equal(m.mps.cores, a.mps.cores)
        assert torch.equal(m.mps.center, a.mps.center)
    assert mt.fit_mps_batch([], opts=opts, device="cpu") == []
    with pytest.raises(ValueError, match="differ only"):
        mt.fit_mps_batch(jobs[:2], opts_list=[opts, opts.replace(d=4)],
                         device="cpu")
    with pytest.raises(ValueError, match="label set"):
        mt.fit_mps_batch([jobs[0], (jobs[1][0], np.zeros(36, int))],
                         opts=opts, device="cpu")
    with pytest.raises(ValueError, match="opts_list"):
        mt.fit_mps_batch(jobs, opts_list=[opts], device="cpu")

"""The port's main path end to end: fit_mps -> classify on ECG200, held
against the JAX package's fit_mps with its Pallas kernels in interpret mode,
and the weight converter (a JAX-trained model classified by the port)."""

import numpy as np
import pytest
import torch

import jax

import mpstime_tpu as mj
import mpstime_tpu_torch as mt
from mpstime_tpu.models.mps import contract_batch_scaled as jax_contract
from mpstime_tpu.ops import pallas_bond
from mpstime_tpu_torch.models.mps import contract_batch_scaled
from mpstime_tpu_torch.ops import bond_kernels as bk
from mpstime_tpu_torch.summary import _encode_test

torch.set_num_threads(1)

SLICE_OPTS = dict(chi_max=8, d=3, nsweeps=2, verbosity=-1, log_level=-1,
                  dtype="float32", svd_alg="randomized_warm", orth_alg="ns")


@pytest.fixture(scope="module")
def slice_data(ecg200):
    Xtr, ytr, Xte, yte = ecg200
    return Xtr[:30, :32], ytr[:30], Xte[:40, :32], yte[:40]


def _jax_fit(Xtr, ytr, **kw):
    """The JAX package's fit, through its Pallas route in interpret mode
    (the K12m blocks of tests/test_pallas_bond.py) wherever that route is
    eligible (float32)."""
    pallas_bond.set_interpret(True)
    jax.clear_caches()
    try:
        trained, _, _ = mj.fit_mps(Xtr, ytr,
                                   opts=mj.MPSOptions(**{**SLICE_OPTS, **kw}))
    finally:
        pallas_bond.set_interpret(False)
        jax.clear_caches()
    return trained


@pytest.fixture(scope="module")
def jax_fit(slice_data):
    return _jax_fit(*slice_data[:2])


@pytest.fixture(scope="module")
def torch_fit(slice_data):
    Xtr, ytr, _, _ = slice_data
    bk.reset_counts()
    trained, info, _ = mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(**SLICE_OPTS),
                                  device="cpu")
    return trained, info, dict(bk.PLAIN_CALLS), dict(bk.LAUNCHES)


def test_fit_matches_jax_fit_f64(slice_data):
    """The whole pipeline (preprocess, encode, init, 2 sweeps of 2 x 31
    bonds, normalise, classify) against the JAX package's, in float64.

    Float64 because the sweep amplifies rounding chaotically: the warm
    split's unconverged subspace directions move with the last bits of the
    power step, and each bond hands that on to the next.  Measured at this
    configuration: JAX's own XLA route and its Pallas route (interpret) end
    2 float32 sweeps 0.58 apart in max |cores| difference, and even float64
    trajectories part after 4 sweeps.  At 2 sweeps in float64 the two
    packages agree far inside rtol 1e-3, atol 1e-4."""
    Xtr, ytr, Xte, _ = slice_data
    jf = _jax_fit(Xtr, ytr, dtype="float64")
    tf, _, _ = mt.fit_mps(Xtr, ytr,
                          opts=mt.MPSOptions(**{**SLICE_OPTS,
                                                "dtype": "float64"}),
                          device="cpu")
    assert tf.mps.cores.dtype == torch.float64
    np.testing.assert_allclose(tf.mps.cores.numpy(), np.asarray(jf.mps.cores),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tf.mps.center.numpy(),
                               np.asarray(jf.mps.center), rtol=1e-3,
                               atol=1e-4)
    assert tf.mps.center_pos == jf.mps.center_pos
    np.testing.assert_array_equal(mt.classify(tf, Xte), mj.classify(jf, Xte))


def test_f32_fit_matches_jax_pallas_fit_over_one_short_sweep(slice_data):
    """Float32 end to end against the JAX package's Pallas route, before
    the trajectories part: one sweep over T=8 (2 x 7 bonds, a K12m block
    of 6 plus a remainder bond each way).  Measured here: max |cores|
    difference 8.4e-5, half of what rtol 1e-3, atol 1e-4 allows; the
    center differs by 2.3e-6.  At T=32 one sweep already parts 0.37."""
    Xtr, ytr, Xte, _ = slice_data
    Xtr, Xte = Xtr[:, :8], Xte[:, :8]
    jf = _jax_fit(Xtr, ytr, nsweeps=1)
    tf, _, _ = mt.fit_mps(Xtr, ytr,
                          opts=mt.MPSOptions(**{**SLICE_OPTS, "nsweeps": 1}),
                          device="cpu")
    assert tf.mps.cores.dtype == torch.float32
    np.testing.assert_allclose(tf.mps.cores.numpy(), np.asarray(jf.mps.cores),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tf.mps.center.numpy(),
                               np.asarray(jf.mps.center), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_array_equal(mt.classify(tf, Xte), mj.classify(jf, Xte))


def test_f32_fit_tracks_jax_pallas_fit(slice_data, jax_fit, torch_fit):
    """At float32 the trajectories part (see the f64 test), so the f32 fits
    are held on what they learn: train and test KLD within 10 % of the JAX
    Pallas fit's.  The JAX package's own routes spread 6 % here (train KLD
    18.87 on its per-sweep route, 20.06 on its fused route); the port
    measured 19.01."""
    from mpstime_tpu.training.stats import loss_acc_conf as jax_stats
    from mpstime_tpu_torch.training.stats import loss_acc_conf
    Xtr, ytr, Xte, yte = slice_data
    trained = torch_fit[0]
    assert trained.mps.cores.shape == jax_fit.mps.cores.shape
    for X, y in ((Xtr, ytr), (Xte, yte)):
        Xs, _ = mj.transform_test_data(X, jax_fit.norms, jax_fit.opts)
        dj = mj.encode_dataset(X, Xs, y, jax_fit.opts, labels=jax_fit.labels,
                               dtype=np.float32)
        kj = jax_stats(jax_fit.mps, dj.X_enc, dj.y_idx)[1]
        kt = loss_acc_conf(trained.mps, torch.from_numpy(np.array(dj.X_enc)),
                           dj.y_idx)[1]
        assert abs(kt - kj) <= 0.10 * abs(kj), (kt, kj)


def test_fit_took_the_block_route_on_cpu(torch_fit):
    _, info, plain, launches = torch_fit
    # T=32: 31 bonds per half-sweep = 3 blocks of 8 + a block of 7
    assert plain == {**dict.fromkeys(plain, 0), "k12m": 2 * 2 * 4}
    assert sum(launches.values()) == 0
    assert len(info["sweep_seconds"]) == 2


def test_converted_jax_model_classifies_like_jax(slice_data, jax_fit):
    _, _, Xte, _ = slice_data
    conv = mt.TrainedMPS.from_numpy(
        np.asarray(jax_fit.mps.cores), np.asarray(jax_fit.mps.center),
        jax_fit.mps.center_pos, jax_fit.opts.to_json(),
        jax_fit.norms.to_dict(), jax_fit.labels,
        enc_args=jax_fit.train_data.enc_args, device="cpu")
    np.testing.assert_array_equal(mt.classify(conv, Xte),
                                  mj.classify(jax_fit, Xte))
    from mpstime_tpu.summary import _encode_test as jax_encode_test
    yj, lj = jax_contract(jax_fit.mps, jax_encode_test(jax_fit, Xte).X_enc)
    yt, lt = contract_batch_scaled(conv.mps, _encode_test(conv, Xte).X_enc)
    # f32 with a different summation order: rtol 1e-5
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-5)


def test_stats_match_jax(jax_fit):
    from mpstime_tpu.training.stats import loss_acc_conf as jax_stats
    from mpstime_tpu_torch.training.stats import loss_acc_conf
    conv = mt.TrainedMPS.from_numpy(
        np.asarray(jax_fit.mps.cores), np.asarray(jax_fit.mps.center),
        jax_fit.mps.center_pos, jax_fit.opts.to_json(),
        jax_fit.norms.to_dict(), jax_fit.labels, device="cpu")
    X_enc, y_idx = jax_fit.train_data.X_enc, jax_fit.train_data.y_idx
    sj = jax_stats(jax_fit.mps, X_enc, y_idx)
    st = loss_acc_conf(conv.mps, torch.from_numpy(np.array(X_enc)), y_idx)
    # f32 with a different summation order: rtol 1e-5
    np.testing.assert_allclose(st[:3], sj[:3], rtol=1e-5)
    np.testing.assert_array_equal(st[3], sj[3])


def test_logged_fit_records_stats(slice_data):
    Xtr, ytr, Xte, yte = slice_data
    opts = mt.MPSOptions(**{**SLICE_OPTS, "log_level": 1, "nsweeps": 1})
    trained, info, test_ds = mt.fit_mps(Xtr, ytr, Xte, yte, opts,
                                        device="cpu")
    # before training, after the sweep, and after normalisation
    assert len(info["train_acc"]) == len(info["test_acc"]) == 3
    assert len(info["sweep_seconds"]) == 1 and len(test_ds) == len(yte)
    assert info["test_conf"][-1].sum() == len(yte)
    assert abs(float(trained.mps.norm()) - 1.0) < 1e-5


def test_mse_fit_runs_k12_per_bond(slice_data):
    Xtr, ytr, _, _ = slice_data
    bk.reset_counts()
    opts = mt.MPSOptions(**{**SLICE_OPTS, "nsweeps": 1, "loss_grad": "MSE",
                            "chi_max": 4})
    trained, _, _ = mt.fit_mps(Xtr[:, :8], ytr, opts=opts, device="cpu")
    assert bk.PLAIN_CALLS == {**dict.fromkeys(bk.PLAIN_CALLS, 0), "k12": 2 * 7}
    assert bool(torch.isfinite(trained.mps.center).all())


def test_default_options_on_cpu_resolve_to_unported_gram_eigh(slice_data):
    # the CPU default resolves to gram_eigh, which now runs: the unfused
    # route, no bond kernel and no plain version of one (the route itself is
    # held against JAX in tests/test_torch_unfused.py)
    Xtr, ytr, Xte, _ = slice_data
    bk.reset_counts()
    trained, info, _ = mt.fit_mps(
        Xtr[:, :12], ytr, opts=mt.MPSOptions(verbosity=-1, log_level=-1,
                                             nsweeps=1, chi_max=8, d=3),
        device="cpu")
    assert trained.opts.resolved_svd_alg("cpu") == "gram_eigh"
    assert sum(bk.PLAIN_CALLS.values()) == sum(bk.LAUNCHES.values()) == 0
    assert bool(torch.isfinite(trained.mps.center).all())
    assert len(mt.classify(trained, Xte[:, :12])) == len(Xte)


@pytest.mark.parametrize("kw", [dict(pad_samples_to=64), dict()])
def test_padded_fit_configurations_run(slice_data, kw):
    # pad_to, refused before the port of hyperopt/, now trains at the caps
    # with chi_max as the rank cap (tests/test_torch_padded_batch.py holds
    # it against the JAX package); with a mesh it raises as in JAX
    Xtr, ytr, _, _ = slice_data
    opts = mt.MPSOptions(**{**SLICE_OPTS, "pad_to": (10, 4)})
    trained, _, _ = mt.fit_mps(Xtr[:, :6], ytr, device="cpu", opts=opts,
                               **kw)
    assert tuple(trained.mps.cores.shape) == (6, 10, 4, 10)
    assert trained.mps.bond_dims().max() <= SLICE_OPTS["chi_max"]
    from mpstime_tpu_torch.parallel import Mesh
    with pytest.raises(ValueError, match="mesh"):
        mt.fit_mps(Xtr[:, :6], ytr, device="cpu", opts=opts,
                   mesh=Mesh(["cpu"] * 2), **kw)


# (options, sweeps, tolerance): each fit option against the JAX package's
# fit in float64.  Measured max |diff| over cores and center, on the CPU:
# train_classes_separately 7.7e-7, sigmoid_transform=False 6.5e-8,
# unsupervised 1.5e-6 after one sweep at chi 8; exit_early 2.8e-4 after the
# one sweep it runs of 4 at chi 25 (d 5, eta 0.1: train accuracy 1.0 after
# sweep 1), where the warm split's unconverged directions amplify rounding
# more (test_fit_matches_jax_f64 above has the mechanism).
OPTION_CASES = {
    "train_classes_separately": (dict(train_classes_separately=True), 1e-5),
    "sigmoid_transform_false": (dict(sigmoid_transform=False), 1e-5),
    "unsupervised": (dict(), 1e-5),
    "exit_early": (dict(exit_early=True, nsweeps=4, chi_max=25, d=5,
                        eta=0.1), 2e-3),
}


@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_fit_options_match_jax_f64(slice_data, case):
    """train_classes_separately, sigmoid_transform=False, y_train=None and
    exit_early through the whole pipeline against the JAX package's fit, in
    float64 (one sweep; exit_early stops after its first of 4 sweeps in
    both): the same sweeps run with the same train accuracies, cores and
    center within the case's tolerance, the same predictions."""
    Xtr, ytr, Xte, _ = slice_data
    kw, atol = OPTION_CASES[case]
    opts = {**SLICE_OPTS, "dtype": "float64", "nsweeps": 1, "log_level": 1,
            **kw}
    y = None if case == "unsupervised" else ytr
    jf, j_info, _ = mj.fit_mps(Xtr, y, opts=mj.MPSOptions(**opts))
    tf, t_info, _ = mt.fit_mps(Xtr, y, opts=mt.MPSOptions(**opts),
                               device="cpu")
    # before training, after each sweep run, and after normalisation
    assert len(t_info["train_acc"]) == len(j_info["train_acc"])
    if case == "exit_early":
        assert len(t_info["train_acc"]) == 1 + 1 + 1
    # the same count of the 30 series right (float32 fractions: 6e-8 apart)
    np.testing.assert_array_equal(np.round(np.array(t_info["train_acc"]) * 30),
                                  np.round(np.array(j_info["train_acc"]) * 30))
    np.testing.assert_allclose(tf.mps.cores.numpy(), np.asarray(jf.mps.cores),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(tf.mps.center.numpy(),
                               np.asarray(jf.mps.center), rtol=0, atol=atol)
    np.testing.assert_array_equal(mt.classify(tf, Xte), mj.classify(jf, Xte))


def test_track_cost_fit_records_the_bond_costs(slice_data):
    # track_cost takes the unfused route, as in the JAX package
    # (sweep.py:341), and records each sweep's per-bond loss trace
    Xtr, ytr, _, _ = slice_data
    bk.reset_counts()
    _, info, _ = mt.fit_mps(Xtr[:, :6], ytr, device="cpu",
                            opts=mt.MPSOptions(**{**SLICE_OPTS,
                                                  "track_cost": True}))
    assert [c.shape for c in info["bond_costs"]] == [(2 * 5,)] * 2
    assert all(np.isfinite(c).all() for c in info["bond_costs"])
    assert sum(bk.PLAIN_CALLS.values()) == 0


def test_qr_fit_runs_k1_and_k2_on_refresh_bonds(slice_data):
    # orth="qr": refresh bonds run K1 -> QR -> K2 one by one (here the plain
    # versions); the frozen sweep runs K12m blocks (sweep.py:467-475), here
    # a block of 4 and a remainder of 1 per half-sweep
    Xtr, ytr, _, _ = slice_data
    bk.reset_counts()
    mt.fit_mps(Xtr[:, :6], ytr, device="cpu",
               opts=mt.MPSOptions(**{**SLICE_OPTS, "orth_alg": "qr",
                                     "subspace_refresh_every": 2}))
    assert bk.PLAIN_CALLS == {**dict.fromkeys(bk.PLAIN_CALLS, 0), "k12m": 4,
                             "k1": 10, "k2": 10}


def test_cuda_fit_without_a_card_raises(slice_data, monkeypatch):
    Xtr, ytr, _, _ = slice_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(**SLICE_OPTS), device="cuda")

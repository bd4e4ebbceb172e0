"""The port's models/ modules held against the JAX package's on the CPU:
serialization (``save_mps`` / ``load_mps`` / ``trained_mps_equal``, one
``.npz`` format that either package loads), the import of models MPSTime.jl
trained (``load_mpstime_jl``, ``load_mpstime_jl_eval_results``) and the
scikit-learn-style ``MPSClassifier``.  Small float64 fits (two_class_sines,
chi <= 10, 2 sweeps) shared in module fixtures."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import mpstime_tpu as mj
import mpstime_tpu_torch as mt
from mpstime_tpu.models.itensor_import import \
    load_mpstime_jl_eval_results as jax_eval_results
from mpstime_tpu_torch.models.itensor_import import \
    load_mpstime_jl_eval_results

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
JLD2 = os.path.join(DATA, "reference_trained_ecg200.jld2")
PORT_NPZ = os.path.join(DATA, "reference_trained_ecg200_port.npz")
# the MPSTime.jl model's pins (tests/test_itensor_import.py:28-29)
GOLDEN_TEST_ACC = 0.84
GOLDEN_IMPUTE_MAE = 0.1883971410956766
IMPORT_ATOL = 1e-12
OPTS = dict(nsweeps=2, chi_max=10, d=4, verbosity=-1, log_level=0,
            dtype="float64")


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def jax_model(two_class_sines):
    Xtr, ytr, _, _ = two_class_sines
    return mj.fit_mps(Xtr, ytr, opts=mj.MPSOptions(**OPTS))[0]


@pytest.fixture(scope="module")
def port_model(two_class_sines):
    Xtr, ytr, _, _ = two_class_sines
    return mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(**OPTS), device="cpu")[0]


@pytest.fixture(scope="module")
def reference(ecg200):
    return mj.load_mpstime_jl(JLD2), mt.load_mpstime_jl(JLD2, device="cpu")


def _assert_same_record(port, jax):
    """Every array of the two models bit for bit, and the same options
    and transform statistics."""
    for a, b in ((port.mps.cores, jax.mps.cores),
                 (port.mps.center, jax.mps.center),
                 (port.train_data.X_enc, jax.train_data.X_enc),
                 (port.train_data.X_orig, jax.train_data.X_orig),
                 (port.train_data.X_scaled, jax.train_data.X_scaled),
                 (port.train_data.y_idx, jax.train_data.y_idx),
                 (port.train_data.labels, jax.train_data.labels),
                 (port.train_data.class_distribution,
                  jax.train_data.class_distribution)):
        a, b = _host(a), _host(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert port.mps.center_pos == jax.mps.center_pos
    assert port.opts.to_dict() == jax.opts.to_dict()
    assert port.norms.to_dict() == jax.norms.to_dict()


# ---- save_mps / load_mps ------------------------------------------------------

def test_port_round_trip_is_exact(port_model, two_class_sines, tmp_path):
    _, _, Xte, yte = two_class_sines
    path = str(tmp_path / "model.npz")
    mt.save_mps(path, port_model)
    loaded = mt.load_mps(path, device="cpu")
    assert mt.trained_mps_equal(port_model, loaded, atol=0.0)
    assert loaded.mps.dtype == torch.float64 and not loaded.mps.cores.is_cuda
    np.testing.assert_array_equal(mt.classify(loaded, Xte),
                                  mt.classify(port_model, Xte))
    imp = mt.init_imputation_problem(loaded, Xte, yte, verbosity=-1, dx=1e-3)
    ts = mt.mps_impute(imp, 0, 0, mt.mar(Xte[0], 0.2, rng=0)[1], "median",
                       NN_baseline=False)[0]
    assert np.isfinite(ts[0]).all()


def test_jax_save_loads_in_the_port_bit_for_bit(jax_model, two_class_sines,
                                                tmp_path):
    _, _, Xte, _ = two_class_sines
    path = str(tmp_path / "jax.npz")
    mj.save_mps(path, jax_model)
    loaded = mt.load_mps(path, device="cpu")
    _assert_same_record(loaded, jax_model)
    np.testing.assert_array_equal(mt.classify(loaded, Xte),
                                  mj.classify(jax_model, Xte))


def test_port_save_loads_in_jax_bit_for_bit(port_model, two_class_sines,
                                            tmp_path):
    _, _, Xte, _ = two_class_sines
    path = str(tmp_path / "port.npz")
    mt.save_mps(path, port_model)
    loaded = mj.load_mps(path)
    _assert_same_record(port_model, loaded)
    np.testing.assert_array_equal(mj.classify(loaded, Xte),
                                  mt.classify(port_model, Xte))
    # and back: the JAX package re-saves it, the port reloads the same
    path2 = str(tmp_path / "again.npz")
    mj.save_mps(path2, loaded)
    assert mt.trained_mps_equal(mt.load_mps(path2, device="cpu"), port_model)


@pytest.mark.parametrize("kw", [
    dict(encoding="fourier", dtype="complex128", chi_max=8),
    dict(encoding="hist_split_legendre", aux_basis_dim=2,
         encode_classes_separately=True),
    dict(encoding="sahand_legendre"),
    dict(pad_to=(12, 5)),
], ids=["fourier", "data-driven-per-class", "sahand-legendre", "padded"])
def test_save_formats_agree_across_packages(two_class_sines, tmp_path, kw):
    # complex cores, per-class encoding arguments and a padded model travel
    # both ways; each package's file equals the other's key for key
    Xtr, ytr, Xte, _ = two_class_sines
    opts = {**OPTS, "nsweeps": 1, **kw}
    jm = mj.fit_mps(Xtr, ytr, opts=mj.MPSOptions(**opts))[0]
    pj = str(tmp_path / "j.npz")
    mj.save_mps(pj, jm)
    tm = mt.load_mps(pj, device="cpu")
    _assert_same_record(tm, jm)
    np.testing.assert_array_equal(mt.classify(tm, Xte), mj.classify(jm, Xte))
    pt = str(tmp_path / "t.npz")
    mt.save_mps(pt, tm)
    with np.load(pj) as a, np.load(pt) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert mj.trained_mps_equal(mj.load_mps(pt), jm)


def test_options_and_norms_dicts_match_jax():
    for kw in (dict(), dict(pad_to=(32, 8), chi_max=20, d=5),
               dict(encoding="Fourier", rescale=[True, False], eta=0.3),
               dict(data_bounds=(0.1, 0.9), custom_encoding_range=None)):
        assert mt.MPSOptions(**kw).to_dict() == mj.MPSOptions(**kw).to_dict()
        assert mt.MPSOptions.from_dict(mj.MPSOptions(**kw).to_dict()) == \
            mt.MPSOptions(**kw)
    X = np.random.default_rng(0).standard_normal((6, 9))
    o = mt.MPSOptions()
    assert mt.transform_train_data(X, o)[1].to_dict() == \
        mj.transform_train_data(X, mj.MPSOptions())[1].to_dict()


def test_equality_detects_changes(port_model, tmp_path):
    path = str(tmp_path / "model.npz")
    mt.save_mps(path, port_model)
    loaded = mt.load_mps(path, device="cpu")
    tweaked = dataclasses.replace(loaded, mps=mt.MPS(
        loaded.mps.cores + 1e-3, loaded.mps.center, loaded.mps.center_pos))
    assert not mt.trained_mps_equal(port_model, tweaked)
    assert mt.trained_mps_equal(port_model, tweaked, atol=2e-3)
    assert not mt.trained_mps_equal(
        port_model, dataclasses.replace(loaded,
                                        opts=loaded.opts.replace(d=9)))


def test_custom_encoding_must_be_resupplied(two_class_sines, tmp_path):
    Xtr, ytr, _, _ = two_class_sines
    spec = mt.function_basis(lambda x, d: torch.stack(
        [x ** k for k in range(d)], -1), is_complex=False, range=(-1.0, 1.0),
        name="powers")
    opts = mt.MPSOptions(**{**OPTS, "nsweeps": 1, "encoding": "custom"})
    tm = mt.fit_mps(Xtr, ytr, opts=opts, custom_encoding=spec,
                    device="cpu")[0]
    path = str(tmp_path / "custom.npz")
    mt.save_mps(path, tm)
    with pytest.raises(ValueError, match="custom encoding"):
        mt.load_mps(path, device="cpu")
    again = mt.load_mps(path, custom_encoding=spec, device="cpu")
    assert mt.trained_mps_equal(tm, again)


# ---- load_mpstime_jl -------------------------------------------------------

def test_reference_import_matches_jax(reference):
    jm, tm = reference
    np.testing.assert_allclose(tm.mps.cores.numpy(), np.asarray(jm.mps.cores),
                               rtol=0, atol=IMPORT_ATOL)
    np.testing.assert_allclose(tm.mps.center.numpy(),
                               np.asarray(jm.mps.center), rtol=0,
                               atol=IMPORT_ATOL)
    assert tm.mps.center_pos == jm.mps.center_pos
    assert tm.opts.to_dict() == jm.opts.to_dict()
    for k, v in jm.norms.to_dict().items():
        assert tm.norms.to_dict()[k] == pytest.approx(v, abs=IMPORT_ATOL)
    np.testing.assert_allclose(tm.train_data.X_enc.numpy(),
                               np.asarray(jm.train_data.X_enc), rtol=0,
                               atol=IMPORT_ATOL)
    assert (tm.mps.T, tm.mps.d, tm.mps.num_classes) == (96, 5, 2)
    assert tm.mps.bond_dims().max() <= 25
    assert float(tm.mps.norm()) == pytest.approx(1.0, abs=1e-12)


def test_reference_model_pins(reference, ecg200):
    """MPSTime.jl's training, the port's inference: train accuracy 1.0,
    test accuracy 0.84 and the median imputation's MAE."""
    _, tm = reference
    Xtr, ytr, Xte, yte = ecg200
    assert float(np.mean(mt.classify(tm, Xtr) == ytr)) == 1.0
    assert float(np.mean(mt.classify(tm, Xte) == yte)) == pytest.approx(
        GOLDEN_TEST_ACC, abs=1e-12)
    imp = mt.init_imputation_problem(tm, Xte, yte, verbosity=-1)
    out = mt.mps_impute(imp, 0, 0, np.arange(30, 50), method="median")
    assert np.isfinite(out[0][0]).all()
    assert out[3][0]["MAE"] == pytest.approx(GOLDEN_IMPUTE_MAE, rel=1e-8)


def test_vendored_port_npz_equals_a_fresh_import(reference):
    # tests/data/reference_trained_ecg200_port.npz: the port's save_mps of
    # load_mpstime_jl, for machines without h5py (chip_smoke.py)
    _, tm = reference
    assert mt.trained_mps_equal(mt.load_mps(PORT_NPZ, device="cpu"), tm,
                                atol=0.0)


@pytest.fixture(scope="module")
def fourier_jld2(two_class_sines, tmp_path_factory):
    from tests.jld2_synth import write_synthetic_jld2
    Xtr, ytr, _, _ = two_class_sines
    Xtr, ytr = Xtr[:24], ytr[:24]
    opts = mj.MPSOptions(nsweeps=3, chi_max=10, d=4, encoding="fourier",
                         verbosity=-1, log_level=-1)
    trained, _, _ = mj.fit_mps(Xtr, ytr, opts=opts)
    path = str(tmp_path_factory.mktemp("jld2") / "fourier_synth.jld2")
    write_synthetic_jld2(path, np.asarray(trained.mps.cores),
                         np.asarray(trained.mps.center),
                         trained.mps.bond_dims(), Xtr, ytr, opts)
    return trained, path, Xtr, ytr


def test_complex_import_matches_jax(fourier_jld2):
    trained, path, Xtr, ytr = fourier_jld2
    jm = mj.load_mpstime_jl(path)
    tm = mt.load_mpstime_jl(path, device="cpu")
    assert tm.mps.dtype == torch.complex128
    assert tm.opts.to_dict() == jm.opts.to_dict()
    np.testing.assert_allclose(tm.mps.cores.numpy(), np.asarray(jm.mps.cores),
                               rtol=0, atol=IMPORT_ATOL)
    np.testing.assert_allclose(tm.mps.center.numpy(),
                               np.asarray(jm.mps.center), rtol=0,
                               atol=IMPORT_ATOL)
    np.testing.assert_array_equal(mt.classify(tm, Xtr),
                                  mj.classify(trained, Xtr))
    imp = mt.init_imputation_problem(tm, Xtr, ytr, verbosity=-1, dx=1e-3,
                                     test_encoding=False)
    ts = mt.mps_impute(imp, 0, 0, np.arange(10, 20), "median",
                       NN_baseline=False)[0]
    assert np.isfinite(ts[0]).all()


def test_eval_results_match_jax():
    path = os.path.join(DATA, "eval_results.jld2")
    ours, theirs = load_mpstime_jl_eval_results(path), jax_eval_results(path)
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys() and len(a) == 13
        for k in b:
            if isinstance(b[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


def test_unmappable_storage_raises(tmp_path):
    import h5py
    from mpstime_tpu_torch.models.itensor_import import _storage_to_array
    p = str(tmp_path / "bad.h5")
    with h5py.File(p, "w") as f:
        f.create_dataset("int_data", data=np.arange(4, dtype=np.int64))
        f.create_dataset("weird", data=np.zeros(4, dtype=np.dtype(
            [("foo", "<f8"), ("bar", "<f8")])))
    with h5py.File(p, "r") as f:
        with pytest.raises(ValueError, match="element kind"):
            _storage_to_array(f["int_data"])
        with pytest.raises(ValueError, match="compound element type"):
            _storage_to_array(f["weird"])


def test_missing_h5py_names_the_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        mt.load_mpstime_jl(JLD2, device="cpu")


# ---- MPSClassifier -----------------------------------------------------------

CLF_KW = dict(nsweeps=1, chi_max=8, d=3, dtype="float64",
              svd_alg="randomized_warm", orth_alg="ns")


def test_classifier_matches_jax(two_class_sines):
    """The same estimator in both packages (the warm split under ns, whose
    float64 fits agree to rounding): the same weights within 1e-6 (1.6e-8
    measured), the same predictions and score."""
    Xtr, ytr, Xte, yte = two_class_sines
    tc = mt.MPSClassifier(device="cpu", **CLF_KW).fit(Xtr, ytr)
    jc = mj.MPSClassifier(**CLF_KW).fit(Xtr, ytr)
    np.testing.assert_allclose(tc.trained_.mps.cores.numpy(),
                               np.asarray(jc.trained_.mps.cores), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tc.predict(Xte), jc.predict(Xte))
    assert tc.score(Xte, yte) == jc.score(Xte, yte)
    np.testing.assert_array_equal(tc.classes_, jc.classes_)


def test_classifier_params_match_jax():
    kw = dict(nsweeps=3, chi_max=12, eta=0.05, train_classes_separately=True)
    tc, jc = mt.MPSClassifier(**kw), mj.MPSClassifier(**kw)
    tp = tc.get_params()
    assert tp.pop("device") == "cuda"
    assert tp == jc.get_params()
    assert tc._make_opts().to_dict() == jc._make_opts().to_dict()
    assert tc._make_opts().encode_classes_separately
    tc.set_params(d=4, device="cpu", bbopt="GD")
    jc.set_params(d=4, bbopt="GD")
    assert tc.device == "cpu" and tc._make_opts() == \
        mt.MPSOptions.from_dict(jc._make_opts().to_dict())
    assert repr(tc).startswith("MPSClassifier(")


@pytest.mark.parametrize("kw", [dict(nsweeps=-1), dict(chi_max=0), dict(d=0),
                                dict(eta=0.0), dict(encoding="nope")])
def test_classifier_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        mj.MPSClassifier(**kw)
    with pytest.raises(ValueError):
        mt.MPSClassifier(**kw)


def test_unfitted_classifier_raises():
    with pytest.raises(RuntimeError, match="not fitted"):
        mt.MPSClassifier().predict(np.zeros((2, 8)))

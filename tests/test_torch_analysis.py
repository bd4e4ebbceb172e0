"""The port's entanglement analysis (mpstime_tpu_torch.analysis) held
against the JAX package's on the same trained models: float64 / complex128
JAX fits of ECG200 cut to T = 48 (chi 8, d 4), carried across with
``TrainedMPS.from_numpy``; every entropy within 1e-10."""

import numpy as np
import pytest
import torch

import mpstime_tpu as mj
import mpstime_tpu_torch as mt
from mpstime_tpu.models.mps import expand_label_index as jax_expand
from mpstime_tpu_torch.models.mps import expand_label_index

torch.set_num_threads(1)

TOL = dict(rtol=0, atol=1e-10)
T = 48
KINDS = {
    "real": dict(nsweeps=2, chi_max=8, d=4, dtype="float64"),
    "complex": dict(nsweeps=1, chi_max=8, d=4, encoding="fourier",
                    dtype="complex128"),
}


@pytest.fixture(scope="module")
def data(ecg200):
    Xtr, ytr, Xte, yte = ecg200
    return Xtr[:60, :T], ytr[:60], Xte[:, :T], yte


@pytest.fixture(scope="module", params=list(KINDS))
def models(request, data):
    Xtr, ytr, _, _ = data
    jt, _, _ = mj.fit_mps(Xtr, ytr, opts=mj.MPSOptions(
        verbosity=-1, log_level=0, **KINDS[request.param]))
    tt = mt.TrainedMPS.from_numpy(
        np.asarray(jt.mps.cores), np.asarray(jt.mps.center),
        jt.mps.center_pos, jt.opts.to_json(), jt.norms.to_dict(), jt.labels,
        enc_args=jt.train_data.enc_args, device="cpu",
        X_train=jt.train_data.X_orig, y_train=jt.labels[jt.train_data.y_idx])
    return jt, tt


@pytest.mark.parametrize("logfn", ["log", "log2", "log10"])
def test_bipartite_spectrum_matches_jax(models, logfn):
    jt, tt = models
    got, want = mt.bipartite_spectrum(tt, logfn), \
        mj.bipartite_spectrum(jt, logfn)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == (T,)
        np.testing.assert_allclose(g, w, **TOL)
        assert np.abs(g).max() > 0.1      # entangled bonds, not all zero


def test_von_neumann_entropy_matches_jax(models):
    jt, tt = models
    for mt_c, mj_c in zip(expand_label_index(tt.mps), jax_expand(jt.mps)):
        np.testing.assert_allclose(mt.von_neumann_entropy(mt_c, "log2"),
                                   mj.von_neumann_entropy(mj_c, "log2"),
                                   **TOL)
    with pytest.raises(ValueError, match="logfn"):
        mt.bipartite_spectrum(tt, "ln")


def test_single_site_entropy_and_spectrum_match_jax(models):
    jt, tt = models
    for g, w in zip(mt.single_site_spectrum(tt), mj.single_site_spectrum(jt)):
        assert g.shape == (T,)
        np.testing.assert_allclose(g, w, **TOL)
    m_t, m_j = expand_label_index(tt.mps)[1], jax_expand(jt.mps)[1]
    np.testing.assert_allclose(mt.single_site_entropy(m_t),
                               mj.single_site_entropy(m_j), **TOL)


@pytest.mark.parametrize("site", [0, 17, T - 1])
def test_one_site_rdm_matches_jax(models, site):
    jt, tt = models
    m_t, m_j = expand_label_index(tt.mps)[0], jax_expand(jt.mps)[0]
    got, want = mt.one_site_rdm(m_t, site), mj.one_site_rdm(m_j, site)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(np.trace(got).real, 1.0, atol=1e-10)


def test_see_variation_matches_jax(models, data):
    jt, tt = models
    _, _, Xte, yte = data
    for label in (None, jt.labels[1]):
        got = mt.see_variation(tt, Xte[:3], class_label=label)
        want = mj.see_variation(jt, Xte[:3], class_label=label)
        assert got.shape == (3, T, T)
        np.testing.assert_allclose(got, want, **TOL)
    # measured sites (j < k) hold no entropy
    assert np.all(got[0][np.tril_indices(T, -1)] == 0)
    one = mt.see_variation(tt, Xte[3])
    np.testing.assert_allclose(one[0], mj.see_variation(jt, Xte[3])[0],
                               **TOL)


@pytest.mark.parametrize("case", ["psd", "tiny_negative", "large_negative"])
def test_rho_correct_matches_jax(case):
    rng = np.random.default_rng(1)
    V, _ = np.linalg.qr(rng.standard_normal((4, 4)))
    w = {"psd": [0.5, 0.3, 0.2, 0.0],
         "tiny_negative": [0.6, 0.4, 1e-9, -1e-10],
         "large_negative": [0.7, 0.4, 0.1, -0.2]}[case]
    rho = (V * np.asarray(w)) @ V.T
    if case == "large_negative":
        for m in (mt, mj):
            with pytest.raises(ValueError, match="negative"):
                m.rho_correct(rho)
        return
    np.testing.assert_allclose(mt.rho_correct(rho), mj.rho_correct(rho),
                               rtol=0, atol=1e-15)


def test_float32_model_analyses_on_the_cpu(models, data):
    """The same weights in single precision: the sweeps run in float32 and
    the spectra are solved in float64 on the CPU (MKL's float32 eigensolver
    fails on mostly-zero Grams), close to the float64 analysis."""
    _, tt = models
    narrow = {torch.float64: np.float32, torch.complex128: np.complex64}
    dt = narrow[tt.mps.dtype]
    t32 = mt.TrainedMPS.from_numpy(
        tt.mps.cores.numpy().astype(dt), tt.mps.center.numpy().astype(dt),
        tt.mps.center_pos, tt.opts.replace(dtype=np.dtype(dt).name),
        tt.norms, tt.labels, enc_args=tt.train_data.enc_args, device="cpu")
    for g, w in zip(mt.bipartite_spectrum(t32), mt.bipartite_spectrum(tt)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    for g, w in zip(mt.single_site_spectrum(t32),
                    mt.single_site_spectrum(tt)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_batched_eigvalsh_split_under_the_solver_limit(models, data,
                                                       monkeypatch):
    """see_variation hands n x T x T matrices to the batched eigensolver;
    past EIGH_BATCH (cuSOLVER refuses 32768) they go in slices, with the
    same spectra."""
    from mpstime_tpu_torch.analysis import analyse
    _, tt = models
    Xte = data[2][:2]
    whole = mt.see_variation(tt, Xte)
    monkeypatch.setattr(analyse, "EIGH_BATCH", 1000)
    np.testing.assert_array_equal(mt.see_variation(tt, Xte), whole)


def test_single_contract_batch_matches_jax(models):
    from mpstime_tpu.models.mps import single_contract_batch as jax_single
    from mpstime_tpu_torch.models.mps import single_contract_batch
    jt, tt = models
    X_enc = jt.train_data.X_enc[:12]
    for m_t, m_j in zip(expand_label_index(tt.mps), jax_expand(jt.mps)):
        got = single_contract_batch(m_t, torch.from_numpy(np.array(X_enc)))
        want = np.asarray(jax_single(m_j, X_enc))
        assert got.shape == (12,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0)

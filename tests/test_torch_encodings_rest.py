"""The port's split, projected and data-driven encodings, the per-class
encoding, ``encode_series``, ``function_basis`` / ``fit_mps(custom_encoding=)``
and ``print_opts``, held against the JAX package on the same numpy inputs
(float64, 1e-10)."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpstime_tpu as mj
import mpstime_tpu_torch as mt
from mpstime_tpu.encodings import bases as jbases
from mpstime_tpu.encodings import data_driven as jdd
from mpstime_tpu.encodings import encode_series as jax_encode_series
from mpstime_tpu_torch.encodings import bases as tbases
from mpstime_tpu_torch.encodings import data_driven as tdd
from mpstime_tpu_torch.encodings import encode_dataset, encode_series

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)

# (encoding, projected_basis, d): every encoding the closed-form slices
# did not cover
CASES = [
    ("hist_split_uniform", False, 4),
    ("hist_split_legendre", False, 4),
    ("unif_split_legendre_norm", False, 4),
    ("unif_split_fourier", False, 4),
    ("hist_split_stoudenmire", False, 4),
    ("sahand_legendre", False, 4),
    ("sltd", False, 4),
    ("legendre", True, 3),
    ("legendre_norm", True, 4),
    ("fourier", True, 4),
]


def _opts(pkg, enc, project, d, sep):
    cplx = pkg.get_encoding(enc, project=project).is_complex
    return pkg.MPSOptions(encoding=enc, projected_basis=project, d=d,
                          encode_classes_separately=sep, verbosity=-1,
                          dtype="complex128" if cplx else "float64")


@pytest.fixture(scope="module")
def data(ecg200):
    Xtr, ytr, Xte, yte = ecg200
    return Xtr[:40, :16], ytr[:40], Xte[:20, :16], yte[:20]


def _assert_args_equal(a, b):
    if isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_args_equal(x, y)
    elif isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            _assert_args_equal(a[k], b[k])
    elif b is None:
        assert a is None
    else:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("sep", [False, True])
@pytest.mark.parametrize("enc,project,d", CASES)
def test_encode_dataset_matches_jax(data, enc, project, d, sep):
    Xtr, ytr, Xte, yte = data
    jo, to = (_opts(mj, enc, project, d, sep), _opts(mt, enc, project, d, sep))
    Xs, norms = mj.transform_train_data(Xtr, jo)
    Xts, _ = mj.transform_test_data(Xte, norms, jo)
    dj = mj.encode_dataset(Xtr, Xs, ytr, jo)
    dt = encode_dataset(Xtr, Xs, ytr, to, device="cpu")
    assert dt.encode_separately == dj.encode_separately
    np.testing.assert_array_equal(dt.y_idx, dj.y_idx)
    _assert_args_equal(dt.enc_args, dj.enc_args)
    np.testing.assert_allclose(dt.X_enc.numpy(), np.asarray(dj.X_enc), **TOL)
    # a test set through the training arguments
    tj = mj.encode_dataset(Xte, Xts, yte, jo, labels=dj.labels,
                           training_enc_args=dj.enc_args)
    tt = encode_dataset(Xte, Xts, yte, to, labels=dt.labels,
                        training_enc_args=dt.enc_args, device="cpu")
    np.testing.assert_allclose(tt.X_enc.numpy(), np.asarray(tj.X_enc), **TOL)
    # one series, through each class's arguments
    for ci in range(len(dj.labels)):
        np.testing.assert_allclose(
            encode_series(Xts[3], to, dt.enc_args, class_idx=ci,
                          device="cpu").numpy(),
            np.asarray(jax_encode_series(Xts[3], jo, dj.enc_args,
                                         class_idx=ci)), **TOL)


@pytest.mark.parametrize("name,project", [
    ("hist_split_uniform", False), ("unif_split_fourier", False),
    ("sl", False), ("sltd", False), ("legendre", True),
    ("legendre_norm", True), ("fourier", True), ("stoudenmire", True),
    ("uniform", False), ("sahand", False)])
def test_specs_match_jax(name, project):
    t, j = mt.get_encoding(name, project=project), \
        mj.get_encoding(name, project=project)
    assert (t.name, t.is_complex, t.is_time_dependent, t.is_data_driven,
            t.range) == (j.name, j.is_complex, j.is_time_dependent,
                         j.is_data_driven, j.range)


@pytest.mark.parametrize("ctor,kw", [
    ("stoudenmire", {}), ("fourier", {}), ("fourier", dict(project=True)),
    ("legendre", {}), ("legendre", dict(norm=True, project=True)),
    ("legendre_no_norm", dict(project=True)), ("sahand", {}),
    ("uniform", {}), ("sahand_legendre", {}),
    ("sahand_legendre", dict(time_dependent=False)),
    ("histogram_split", {}), ("histogram_split", dict(aux="legendre")),
    ("uniform_split", dict(aux="fourier"))])
def test_constructors_match_jax(ctor, kw):
    t, j = getattr(mt, ctor)(**kw), getattr(mj, ctor)(**kw)
    assert (t.name, t.is_complex, t.is_time_dependent, t.is_data_driven,
            t.range) == (j.name, j.is_complex, j.is_time_dependent,
                         j.is_data_driven, j.range)


@pytest.mark.parametrize("call,exc,match", [
    (lambda m: m.get_encoding("custom"), ValueError, "function_basis"),
    (lambda m: m.get_encoding("erf"), NotImplementedError, "placeholder"),
    (lambda m: m.get_encoding("hist_split_sl"), ValueError, "data-driven"),
    (lambda m: m.get_encoding("nope"), ValueError, "Unknown encoding"),
])
def test_encoding_errors_match_jax(call, exc, match):
    for m in (mt, mj):
        with pytest.raises(exc, match=match):
            call(m)


def test_polyval_and_kde_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (5, 7))
    cvecs = rng.standard_normal((4, 4))
    np.testing.assert_allclose(
        tbases.polyval_matrix(torch.from_numpy(x), cvecs).numpy(),
        np.asarray(jbases.polyval_matrix(jnp.asarray(x), jnp.asarray(cvecs))),
        **TOL)
    samples = rng.uniform(-1, 1, 30)
    np.testing.assert_allclose(
        tdd.kde_pdf(torch.from_numpy(x), samples, 0.2).numpy(),
        np.asarray(jdd.kde_pdf(jnp.asarray(x), jnp.asarray(samples), 0.2)),
        **TOL)
    samp_t = np.where(rng.random((7, 30)) < 0.2, np.nan,
                      rng.uniform(-1, 1, (7, 30)))
    bw = rng.uniform(0.1, 0.3, 7)
    np.testing.assert_allclose(
        tdd.kde_pdf_masked(torch.from_numpy(x), samp_t, bw).numpy(),
        np.asarray(jdd.kde_pdf_masked(jnp.asarray(x), jnp.asarray(samp_t),
                                      jnp.asarray(bw))), **TOL)


def _basis_torch(x, d):
    # a cosine basis on torch tensors
    k = torch.arange(d, dtype=x.dtype, device=x.device)
    return torch.cos(np.pi * x[..., None] * k) / np.sqrt(d)


def _basis_jax(x, d):
    k = jnp.arange(d, dtype=x.dtype)
    return jnp.cos(jnp.pi * x[..., None] * k) / np.sqrt(d)


FIT_OPTS = dict(encoding="custom", nsweeps=1, chi_max=6, d=3,
                svd_alg="randomized_warm", orth_alg="ns",
                verbosity=-1, log_level=-1, dtype="float64")


def test_custom_encoding_fit_matches_jax(data):
    Xtr, ytr, Xte, _ = data
    Xtr, Xte = Xtr[:, :16], Xte[:, :16]
    spec_t = mt.function_basis(_basis_torch, False, (-1.0, 1.0))
    spec_j = mj.function_basis(_basis_jax, False, (-1.0, 1.0))
    tf, _, _ = mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(**FIT_OPTS),
                          custom_encoding=spec_t, device="cpu")
    jf, _, _ = mj.fit_mps(Xtr, ytr, opts=mj.MPSOptions(**FIT_OPTS),
                          custom_encoding=spec_j)
    assert tf.encoding_spec() is spec_t
    assert tf.opts.custom_encoding_range == jf.opts.custom_encoding_range
    np.testing.assert_allclose(tf.train_data.X_enc.numpy(),
                               np.asarray(jf.train_data.X_enc), **TOL)
    # a one-sweep f64 fit: tests/test_torch_slice.py's bound
    np.testing.assert_allclose(tf.mps.center.numpy(),
                               np.asarray(jf.mps.center), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_array_equal(mt.classify(tf, Xte), mj.classify(jf, Xte))


def test_custom_encoding_needs_the_custom_name(data):
    Xtr, ytr, _, _ = data
    spec = mt.function_basis(_basis_torch, False, (-1.0, 1.0))
    with pytest.raises(ValueError, match="encoding='custom'"):
        mt.fit_mps(Xtr[:, :8], ytr, opts=mt.MPSOptions(
            **{**FIT_OPTS, "encoding": "legendre"}), custom_encoding=spec,
            device="cpu")


@pytest.mark.parametrize("long", [False, True])
@pytest.mark.parametrize("kw", [{}, dict(encoding="fourier", chi_max=40)])
def test_print_opts_equals_jax(long, kw):
    out_t, out_j = io.StringIO(), io.StringIO()
    mt.print_opts(mt.MPSOptions(**kw), long=long, file=out_t)
    mj.print_opts(mj.MPSOptions(**kw), long=long, file=out_j)
    assert out_t.getvalue() == out_j.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mt.print_opts(mt.MPSOptions(**kw), long=long)
    assert buf.getvalue() == out_j.getvalue()

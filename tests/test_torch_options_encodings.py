"""The PyTorch port's options, preprocessing and encodings, held against the
JAX package (mpstime_tpu) on identical inputs."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mpstime_tpu as mj
import mpstime_tpu_torch as mt
from mpstime_tpu.encodings import encode_dataset as jax_encode_dataset
from mpstime_tpu_torch.encodings import encode_dataset, get_encoding

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


OPTION_CASES = [
    {},
    dict(chi_max=17, d=3, eta=0.05, nsweeps=4, loss_grad="mse", bbopt="gd",
         rescale=(True, True), data_bounds=(0.1, 0.9), init_rng=7),
    dict(encoding="Fourier", chi_max=64, subspace_power_iters=2,
         pad_to=(70, 6), orth_alg="ns", svd_alg="randomized"),
    dict(encoding="legendre_norm", bbopt="Optim", subspace_refresh_every=2,
         ritz_rot_exact="jacobi", ritz_rot_track="track", dtype="float32"),
]


@pytest.mark.parametrize("case", range(len(OPTION_CASES)))
def test_options_json_round_trips_across_packages(case):
    kw = OPTION_CASES[case]
    jo, to = mj.MPSOptions(**kw), mt.MPSOptions(**kw)
    assert to.to_dict() == jo.to_dict()
    # one options file drives both packages, either way round
    assert mt.MPSOptions.from_json(jo.to_json()).to_dict() == jo.to_dict()
    assert mj.MPSOptions.from_json(to.to_json()).to_dict() == to.to_dict()
    assert json.loads(to.to_json()) == json.loads(jo.to_json())


@pytest.mark.parametrize("case", range(len(OPTION_CASES)))
def test_cpu_resolution_matches_jax_cpu_branch(case):
    # the JAX tests run on its CPU backend, so its policies take the CPU
    # branch; the port's take it for device "cpu"
    jo, to = mj.MPSOptions(**OPTION_CASES[case]), mt.MPSOptions(**OPTION_CASES[case])
    assert to.resolved_svd_alg("cpu") == jo.resolved_svd_alg()
    assert to.resolved_orth_alg("cpu") == jo.resolved_orth_alg()
    assert to.resolved_power_iters("cpu") == jo.resolved_power_iters()
    assert to.resolved_ritz_rots("cpu") == jo.resolved_ritz_rots()


@pytest.mark.parametrize("kw,svd,orth,q", [
    ({}, "randomized_warm", "ns", 1),
    (dict(encoding="fourier"), "randomized_warm", "ns", 3),
    (dict(encoding="fourier", chi_max=64), "randomized_warm_ritz", "qr", 1),
    (dict(pad_to=(30, 6)), "randomized_warm", "qr", 1),
    (dict(svd_alg="gram_eigh", orth_alg="qr"), "gram_eigh", "qr", 1),
])
def test_cuda_resolution_is_the_accelerator_branch(kw, svd, orth, q):
    # mpstime_tpu/options.py:320-423 on a non-CPU backend
    o = mt.MPSOptions(**kw)
    assert o.resolved_svd_alg("cuda") == svd
    assert o.resolved_orth_alg(torch.device("cuda")) == orth
    assert o.resolved_power_iters("cuda") == q
    assert o.resolved_ritz_rots("cuda") == ("eigh", "jacobi")


def test_resolved_dtype_defaults_to_single_precision():
    assert mt.MPSOptions().resolved_dtype() == np.float32
    assert mt.MPSOptions(encoding="fourier").resolved_dtype() == np.complex64
    assert mt.MPSOptions(dtype="float64").resolved_dtype() == np.float64
    assert mt.MPSOptions().real_dtype() == np.float32


def test_options_validation_matches_jax():
    for bad in (dict(loss_grad="hinge"), dict(bbopt="adam"),
                dict(orth_alg="svd"), dict(pad_to=(3, 3)),
                dict(encoding="nope")):
        with pytest.raises(ValueError):
            mj.MPSOptions(**bad)
        with pytest.raises(ValueError):
            mt.MPSOptions(**bad)


@pytest.mark.parametrize("encoding", ["legendre", "legendre_norm", "uniform"])
def test_preprocessing_matches_jax(ecg200, encoding):
    Xtr, _, Xte, _ = ecg200
    opts_j = mj.MPSOptions(encoding=encoding)
    opts_t = mt.MPSOptions(encoding=encoding)
    # push some test rows out of the training range: the per-series rescue
    Xte = Xte.copy()
    Xte[:3] *= 4.0
    tj = mj.transform_data(Xtr, Xte, opts_j)
    tt = mt.transform_data(Xtr, Xte, opts_t)
    np.testing.assert_array_equal(tt[0], tj[0])
    np.testing.assert_array_equal(tt[1], tj[1])
    assert tt[2].to_dict() == tj[2].to_dict()
    assert tt[3] == tj[3]
    inv_t = mt.invert_test_transform(tt[1], tt[3], tt[2], opts_t)
    np.testing.assert_allclose(inv_t, Xte, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("encoding,d", [("legendre", 5), ("legendre", 2),
                                        ("legendre_norm", 4),
                                        ("uniform", 3)])
def test_encode_dataset_matches_jax_f64(ecg200, encoding, d):
    Xtr, ytr, _, _ = ecg200
    Xtr, ytr = Xtr[:40, :24], ytr[:40]
    opts_j = mj.MPSOptions(encoding=encoding, d=d)
    opts_t = mt.MPSOptions(encoding=encoding, d=d)
    Xs, _ = mj.transform_train_data(Xtr, opts_j)
    dj = jax_encode_dataset(Xtr, Xs, ytr, opts_j, dtype=np.float64)
    dt = encode_dataset(Xtr, Xs, ytr, opts_t, dtype=np.float64)
    assert dt.X_enc.dtype == torch.float64 and dt.X_enc.shape == (40, 24, d)
    # f64: the same recurrence in the same order, rtol 1e-10
    np.testing.assert_allclose(dt.X_enc.numpy(), np.asarray(dj.X_enc),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(dt.y_idx, dj.y_idx)
    np.testing.assert_array_equal(dt.labels, dj.labels)
    np.testing.assert_array_equal(dt.class_distribution, dj.class_distribution)
    np.testing.assert_array_equal(dt.X_scaled, dj.X_scaled)


def test_encode_dataset_casts_to_model_dtype_and_empty_sets():
    opts = mt.MPSOptions(d=3)
    X = np.linspace(-0.9, 0.9, 12).reshape(3, 4)
    ds = encode_dataset(X, X, np.array([1, 0, 1]), opts)
    assert ds.X_enc.dtype == torch.float32
    np.testing.assert_array_equal(ds.y_idx, [0, 1, 1])
    empty = encode_dataset(np.zeros((0, 4)), np.zeros((0, 4)),
                           np.zeros(0), opts, labels=np.array([0, 1]))
    assert len(empty) == 0 and empty.X_enc.shape == (0, 0, 3)
    with pytest.raises(ValueError, match="rescaled"):
        encode_dataset(X, X + 5.0, np.zeros(3), opts)


@pytest.mark.parametrize("name,item", [
    ("fourier", "item 14"), ("stoudenmire", "item 14"), ("sahand", "item 14"),
    ("sahand_legendre", "item 4"), ("sltd", "item 4"),
    ("hist_split_uniform", "item 4"), ("custom", "item 4")])
def test_unported_encodings_name_their_roadmap_item(name, item):
    with pytest.raises(NotImplementedError, match=item):
        get_encoding(name)


def test_projected_bases_are_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_encoding("legendre", project=True)


def test_encoding_range_matches_jax():
    from mpstime_tpu.encodings import encoding_range as jax_range
    for name in ("legendre", "legendre_norm", "uniform", "fourier",
                 "stoudenmire", "sahand", "hist_split_uniform"):
        assert mt.encoding_range(name) == jax_range(name)


def test_import_pulls_in_no_jax():
    # a fresh interpreter: the port must import where JAX does not exist
    code = ("import sys, mpstime_tpu_torch, mpstime_tpu_torch.ops.bond_kernels,"
            " mpstime_tpu_torch.kernels.build; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'mpstime_tpu.')) or m == 'mpstime_tpu']; "
            "assert not bad, bad; assert 'triton' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=120)


def test_port_sources_never_import_jax():
    for path in (ROOT / "mpstime_tpu_torch").rglob("*.py"):
        src = path.read_text()
        assert "import jax" not in src and "from jax" not in src, path
        assert "from mpstime_tpu " not in src and "import mpstime_tpu\n" not in src, path
        assert "from mpstime_tpu." not in src, path

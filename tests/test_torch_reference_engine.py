"""The naive reference engine in the port
(mpstime_tpu_torch/training/reference_engine.py, a copy of the JAX
package's), the port's float64 fit held against it as
tests/test_reference_engine.py holds the JAX fit, and the port's
one-sweep entry points ``full_sweep`` / ``full_sweep_warm`` against the
JAX functions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpstime_tpu as mj
import mpstime_tpu_torch as mt
from mpstime_tpu.encodings import encode_dataset as j_encode
from mpstime_tpu.models import mps as jmps
from mpstime_tpu.training import reference_engine as jre
from mpstime_tpu.training import sweep as jsweep
from mpstime_tpu.utils.preprocessing import transform_data as j_transform
from mpstime_tpu_torch import training
from mpstime_tpu_torch.encodings import encode_dataset as t_encode
from mpstime_tpu_torch.models import mps as tmps
from mpstime_tpu_torch.training import reference_engine as tre
from mpstime_tpu_torch.training import sweep as tsweep
from mpstime_tpu_torch.training.stats import predict_class_indices
from mpstime_tpu_torch.utils.preprocessing import transform_data as t_transform

torch.set_num_threads(1)

#: The cut of tests/test_reference_engine.py:17-27.
OPTS = dict(nsweeps=4, chi_max=8, d=3, verbosity=-1, dtype="float64",
            svd_alg="gram_eigh")


@pytest.fixture(scope="module")
def problem(two_class_sines):
    Xtr, ytr, Xte, yte = two_class_sines
    Xtr, ytr, Xte, yte = Xtr[:24], ytr[:24], Xte[:24], yte[:24]
    opts = mt.MPSOptions(**OPTS)
    Xtr_s, Xte_s, _, _ = t_transform(Xtr, Xte, opts)
    tr = t_encode(Xtr, Xtr_s, ytr, opts, device="cpu")
    te = t_encode(Xte, Xte_s, yte, opts, labels=tr.labels,
                  training_enc_args=tr.enc_args, device="cpu")
    return opts, tr, te


def _naive_kw(opts):
    return dict(nsweeps=opts.nsweeps, chi_max=opts.chi_max,
                chi_init=opts.chi_init, eta=opts.eta, cutoff=opts.cutoff,
                seed=opts.init_rng)


def test_port_copy_equals_jax_copy(two_class_sines):
    """The two copies of the naive engine on the JAX package's encoding of
    the same data: every site, the center and the predictions equal."""
    Xtr, ytr, Xte, _ = two_class_sines
    jo = mj.MPSOptions(**OPTS)
    Xtr_s, Xte_s, _, _ = j_transform(Xtr[:24], Xte[:24], jo)
    X_enc = np.asarray(j_encode(Xtr[:24], Xtr_s, ytr[:24], jo).X_enc)
    Xte_enc = np.asarray(j_encode(Xte[:24], Xte_s, np.zeros(24, int),
                                  jo).X_enc)
    y_idx = np.asarray(ytr[:24])
    kw = dict(nsweeps=2, chi_max=8, chi_init=4, seed=7)
    got = tre.naive_fit_mps(X_enc, y_idx, 2, **kw)
    ref = jre.naive_fit_mps(X_enc, y_idx, 2, **kw)
    assert got.center_pos == ref.center_pos
    for a, b in zip(got.sites, ref.sites):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.center, ref.center)
    np.testing.assert_array_equal(tre.naive_predict(got, Xte_enc),
                                  jre.naive_predict(ref, Xte_enc))


def test_engines_agree(problem):
    """The port's float64 gram_eigh fit on the CPU against the naive engine
    on the identical encoded data: the JAX package's rule
    (tests/test_reference_engine.py:45), agreement >= 0.95."""
    opts, tr, te = problem
    trained, _, _ = mt.fit_mps(tr.X_orig, tr.labels[tr.y_idx], opts=opts,
                               device="cpu")
    fast = predict_class_indices(trained.mps, te.X_enc)
    naive = tre.naive_fit_mps(tr.X_enc.numpy(), tr.y_idx, 2,
                              **_naive_kw(opts))
    slow = tre.naive_predict(naive, te.X_enc.numpy())
    assert np.mean(fast == slow) >= 0.95, (fast.tolist(), slow.tolist())


def test_naive_engine_trains(problem):
    _, tr, _ = problem
    naive = tre.naive_fit_mps(tr.X_enc.numpy(), tr.y_idx, 2, nsweeps=3,
                              chi_max=8, seed=1)
    preds = tre.naive_predict(naive, tr.X_enc.numpy())
    assert np.mean(preds == tr.y_idx) >= 0.9


# ---- full_sweep / full_sweep_warm against the JAX functions ---------------

SWEEP_KW = dict(loss="KLD", bbopt="TSGO", update_iters=1,
                rescale=(False, True))


def _sweep_inputs(ecg200, chi: int, chi_init: int):
    """One float64 problem in both packages: ECG200 X[:20, :12], d 3, the
    bit-identical seeded random MPS at (chi, chi_init)."""
    Xtr, ytr, _, _ = ecg200
    X, y = Xtr[:20, :12], ytr[:20]
    opts = mt.MPSOptions(chi_max=chi, chi_init=chi_init, d=3,
                         dtype="float64", verbosity=-1)
    Xs, _, _, _ = t_transform(X, X[:0], opts)
    enc = t_encode(X, Xs, y, opts, device="cpu")
    m = tmps.random_mps(opts.init_rng, X.shape[1], 3, 2, chi_init, chi,
                        dtype=np.float64, device="cpu")
    phis = enc.X_enc.conj().transpose(0, 1).contiguous()
    y1h = torch.nn.functional.one_hot(torch.as_tensor(enc.y_idx), 2).double()
    w = torch.full((X.shape[0],), 1.0 / X.shape[0], dtype=torch.float64)
    t_args = (phis, y1h, w, 0.05, 1e-10)
    j_args = tuple(jnp.asarray(a.numpy()) for a in (phis, y1h, w)) + \
        (0.05, 1e-10)
    return (m.cores, m.center, t_args), (jnp.asarray(m.cores.numpy()),
                                         jnp.asarray(m.center.numpy()),
                                         j_args), enc.X_enc


@pytest.fixture(scope="module")
def sweep_inputs(ecg200):
    return _sweep_inputs(ecg200, 6, 4)


@pytest.fixture(scope="module")
def full_rank_inputs(ecg200):
    """chi_max = d = chi_init = 3: every bond keeps full rank, where the
    QR-based routes agree trajectory for trajectory (on rank-deficient
    bonds MKL and LAPACK fill the QR's missing columns differently,
    ROADMAP.md "Known differences")."""
    return _sweep_inputs(ecg200, 3, 3)


def _outputs(cores, center, X_enc, jax_side):
    """The contracted outputs of (cores, center) on the training states,
    free of the eigenvectors' sign gauge."""
    T = cores.shape[0]
    if jax_side:
        y, ls = jmps.contract_batch_scaled(
            jmps.MPS(cores, center, T - 1), jnp.asarray(X_enc.numpy()))
        return np.asarray(y) * np.exp(np.asarray(ls))[:, None]
    y, ls = tmps.contract_batch_scaled(tmps.MPS(cores, center, T - 1), X_enc)
    return (y * torch.exp(ls)[:, None]).numpy()


@pytest.mark.parametrize("svd_alg", ["gram_eigh", "svd"])
@pytest.mark.parametrize("track_cost", [False, True])
def test_full_sweep_matches_jax_f64(sweep_inputs, svd_alg, track_cost):
    """One float64 sweep, compared on the outputs it gives (eigh and SVD
    fix each direction up to its sign) and on its per-bond cost trace."""
    (tc, tz, ta), (jc, jz, ja), X_enc = sweep_inputs
    kw = dict(SWEEP_KW, svd_alg=svd_alg, track_cost=track_cost)
    got = training.full_sweep(tc, tz, *ta, donate=True, **kw)
    ref = jsweep.full_sweep(jc, jz, *ja, **kw)
    assert len(got) == len(ref) == (3 if track_cost else 2)
    np.testing.assert_allclose(_outputs(*got[:2], X_enc, False),
                               _outputs(*ref[:2], X_enc, True),
                               rtol=1e-10, atol=1e-12)
    if track_cost:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                                   rtol=1e-10)
    # the inputs stay as they were (donate has no effect)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("orth", ["qr", "ns"])
def test_full_sweep_warm_matches_jax_f64(full_rank_inputs, orth):
    """The warm split's sweeps with explicit subspace state: a refresh
    sweep from cold-started caches, then a frozen one from the caches it
    returned; cores, center and caches at 1e-10 (the warm split has no
    sign gauge)."""
    (tc, tz, ta), (jc, jz, ja), _ = full_rank_inputs
    kw = dict(SWEEP_KW, svd_alg="randomized_warm", orth=orth)
    T, chi, d, _ = tc.shape
    t_sub = tsweep.init_subspaces(T, chi, d, np.float64, "cpu")
    j_sub = jsweep.init_subspaces(T, chi, d, np.float64)
    got, ref = (tc, tz, t_sub), (jc, jz, j_sub)
    for refresh in (True, False):
        got = tsweep.full_sweep_warm(*got, *ta, refresh=refresh, **kw)
        ref = jsweep.full_sweep_warm(*ref, *ja, refresh=refresh, **kw)
        assert len(got) == len(ref) == 3
        for a, b in zip((got[0], got[1], *got[2]),
                        (ref[0], ref[1], *ref[2])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                       atol=1e-12)


def test_full_sweep_is_sweep_once(sweep_inputs):
    """full_sweep is one ``sweep_once``: the same bits, on the warm route
    with cold-started caches."""
    (tc, tz, ta), _, _ = sweep_inputs
    kw = dict(SWEEP_KW, svd_alg="randomized_warm", orth="qr")
    cores, center = training.full_sweep(tc, tz, *ta, **kw)
    ref = tsweep.sweep_once(tc, tz, *ta, **kw)
    assert torch.equal(cores, ref[0]) and torch.equal(center, ref[1])

"""The port's eigensolver at every thread count.

MKL's multi-threaded float64 syevd fails on the Gram matrices of early
bonds, most of whose rows are exactly zero: on the matrix stored in
tests/data/eigh_zero_rows_gram.npy (125 x 125, 116 zero rows, rank 5,
saved from the input of the ``torch.linalg.eigh`` call that raised during
an 8-thread fit of ECG200 at the default options in float64)
``torch.linalg.eigh`` raises LinAlgError at 4 and 8 threads.  The port's
``_eigh_desc`` solves only the live block.  These tests hold its
eigenpairs on that matrix and whole fits at thread counts where the
unrepaired solver raised.  The other torch test files pin one thread, so
each test here restores the thread count it found."""

import os

import numpy as np
import pytest
import torch

import mpstime_tpu as mj
import mpstime_tpu_torch as mt
from mpstime_tpu_torch.ops.decomp import _eigh_desc

GRAM = os.path.join(os.path.dirname(__file__), "data",
                    "eigh_zero_rows_gram.npy")


@pytest.fixture
def threads():
    """Set torch's intra-op thread count; restore the one found after."""
    found = torch.get_num_threads()
    yield torch.set_num_threads
    torch.set_num_threads(found)


def _check_eigh(G: np.ndarray, w: torch.Tensor, V: torch.Tensor):
    Gt = torch.from_numpy(G)
    assert torch.isfinite(V).all()
    assert float((Gt @ V - V * w).abs().max()) <= 1e-12
    assert bool((w[:-1] >= w[1:]).all())
    np.testing.assert_allclose(np.sort(w.numpy()), np.linalg.eigvalsh(G),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose((V.T @ V).numpy(), np.eye(G.shape[0]),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("nthreads", [1, 2, 4, 8])
def test_eigh_desc_on_the_captured_gram(threads, nthreads):
    G = np.load(GRAM)
    assert G.shape == (125, 125)
    assert int((np.abs(G).sum(axis=1) == 0).sum()) == 116
    threads(nthreads)
    w, V = _eigh_desc(torch.from_numpy(G))
    _check_eigh(G, w, V)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128])
def test_eigh_desc_zero_rows_other_dtypes(threads, dtype):
    # the live block of a float32 or complex Gram: eigenpairs of the
    # widened matrix, cast back
    threads(8)
    rng = np.random.default_rng(5)
    B = rng.standard_normal((4, 30))
    if dtype.is_complex:
        B = B + 1j * rng.standard_normal((4, 30))
    B[:, rng.permutation(30)[:22]] = 0
    G = torch.from_numpy(B.conj().T @ B).to(dtype)
    w, V = _eigh_desc(G)
    Gw = G.to(torch.complex128 if dtype.is_complex else torch.float64)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((Gw @ V.to(Gw.dtype) - V.to(Gw.dtype) * w.to(Gw.dtype))
                 .abs().max()) <= tol
    assert bool((w[:-1] >= w[1:]).all())
    np.testing.assert_allclose(np.sort(w.double().numpy()),
                               np.linalg.eigvalsh(Gw.numpy()), atol=tol)


def _golden_fit_holds(ecg200):
    """The configuration of tests/test_torch_golden.py (ECG200, default
    MPSOptions, float64, gram_eigh on the CPU), held as that test holds
    it."""
    Xtr, ytr, Xte, yte = ecg200
    trained, info, _ = mt.fit_mps(Xtr, ytr, Xte, yte,
                                  mt.MPSOptions(verbosity=-1, dtype="float64"),
                                  device="cpu")
    assert info["train_acc"][-1] == 1.0
    assert np.mean(mt.classify(trained, Xte) == yte) >= 0.80


def test_golden_configuration_fits_at_two_threads(threads, ecg200):
    # before the live-block solve it raised at 2 threads (and passed at 1)
    threads(2)
    _golden_fit_holds(ecg200)


@pytest.mark.slow
def test_golden_configuration_fits_at_eight_threads(threads, ecg200):
    """Before the live-block solve the fit raised at 8 threads.  Marked
    slow: alone it takes ~15 s, but in the tier-1 run (six workers on eight
    cores) its eight threads took 512 s and starved the other workers, so
    that run passed its time limit.  Run it with ``-m slow``."""
    threads(8)
    _golden_fit_holds(ecg200)


#: The padded trial of the test below: chi 15, d 4 under the caps (25, 5),
#: 10 sweeps, float64, ECG200.
PADDED = dict(chi_max=15, d=4, pad_to=(25, 5), nsweeps=10, dtype="float64",
              verbosity=-1, log_level=-1)
#: The JAX package's test accuracy for that trial (``mpstime_tpu.fit_mps``
#: on the CPU, then ``classify``), held by
#: ``test_jax_padded_reference_accuracy`` under ``-m slow``: the JAX fit
#: takes ~25 s alone and ~200 s among the tier-1 run's workers.
JAX_PADDED_TEST_ACC = 0.85


def test_padded_fit_at_two_threads(threads, ecg200):
    """The padded trial at 2 threads, where the unrepaired solver raised,
    against the JAX package's fit of the same data.  Both fits' test
    accuracies move with rounding: under input noise of 1e-15 and 1e-14
    the JAX package gives 0.87 and 0.83 (0.85 unperturbed) and the port
    0.88 and 0.86 (0.81 unperturbed, at 1, 2, 4 and 8 threads), so the two
    are held within 0.05."""
    Xtr, ytr, Xte, yte = ecg200
    threads(2)
    trained, _, _ = mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(**PADDED),
                               device="cpu")
    assert bool(torch.isfinite(trained.mps.center).all())
    assert trained.mps.bond_dims().max() <= 15
    acc = np.mean(mt.classify(trained, Xte) == yte)
    assert abs(acc - JAX_PADDED_TEST_ACC) <= 0.05, acc


@pytest.mark.slow
def test_jax_padded_reference_accuracy(ecg200):
    Xtr, ytr, Xte, yte = ecg200
    ref, _, _ = mj.fit_mps(Xtr, ytr, opts=mj.MPSOptions(**PADDED))
    assert np.mean(mj.classify(ref, Xte) == yte) == JAX_PADDED_TEST_ACC

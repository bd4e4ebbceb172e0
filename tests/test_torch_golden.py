"""The port at the configuration of the JAX package's golden constants:
ECG200 at the default MPSOptions in float64 on the CPU."""

import numpy as np
import torch

import mpstime_tpu_torch as mt

torch.set_num_threads(1)


def test_default_f64_fit_trains_ecg200(ecg200):
    """ECG200 at the default MPSOptions in float64 on the CPU, the
    configuration of the JAX package's golden constants
    (tests/test_golden.py:36-39: test accuracy 0.86, train KLD -45.4436
    after sweep 1).  The port does not reach those constants, and neither
    does the JAX package itself once its input moves by one part in 1e15:
    each gram_eigh split truncates inside a dense tail of near-degenerate
    squared singular values (~1e-8 of the largest), where rounding picks
    the kept directions, and the two packages' bond matrices part from
    4e-16 of the largest singular value at bond 0 to 7e-5 at bond 10 of
    the first sweep (tests/torch_golden_spread.py).  Measured (ROADMAP.md
    queue 3): sweep-1 train KLD -45.444 / -45.064 / -44.739 for the JAX
    package at input perturbations 0 / 1e-15 / 1e-14, -44.566 / -43.836 /
    -45.024 for the port; test accuracy 0.86 / 0.88 / 0.88 and 0.85 / 0.88
    / 0.86.  So this test holds what rounding does not move: the fit trains the
    set perfectly, as the golden test asserts, and classifies far above
    chance (floor 0.80)."""
    Xtr, ytr, Xte, yte = ecg200
    trained, info, _ = mt.fit_mps(Xtr, ytr, Xte, yte,
                                  mt.MPSOptions(verbosity=-1, dtype="float64"),
                                  device="cpu")
    assert trained.mps.cores.dtype == torch.float64
    assert len(info["train_KL_div"]) == 10 + 2
    assert info["train_acc"][-1] == 1.0
    assert np.mean(mt.classify(trained, Xte) == yte) >= 0.80
    assert info["test_conf"][-1].sum() == len(yte)

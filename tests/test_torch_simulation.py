"""The port's missing-data simulators and toy-data generators
(mpstime_tpu_torch.simulation, NumPy copies) held bit for bit against the
JAX package's under the same rng."""

import numpy as np
import pytest

import mpstime_tpu as mj
import mpstime_tpu_torch as mt
from mpstime_tpu.simulation import \
    percentage_missing_values as jax_percentage
from mpstime_tpu_torch.simulation import percentage_missing_values

SERIES = np.sin(np.linspace(0, 6, 96)) + np.linspace(-1, 1, 96) ** 2


@pytest.mark.parametrize("fn", ["mcar", "mar", "mnar"])
@pytest.mark.parametrize("fraction", [0.0, 0.13, 0.5, 1.0])
def test_missing_data_mechanisms_equal_jax(fn, fraction):
    kw = {} if fn == "mnar" else dict(rng=np.random.default_rng(7))
    kj = {} if fn == "mnar" else dict(rng=np.random.default_rng(7))
    Xt, it = getattr(mt, fn)(SERIES, fraction, **kw)
    Xj, ij = getattr(mj, fn)(SERIES, fraction, **kj)
    np.testing.assert_array_equal(Xt, Xj)          # NaNs in the same places
    np.testing.assert_array_equal(it, ij)
    assert percentage_missing_values(Xt) == jax_percentage(Xj)


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_mar_windows_from_one_generator_equal_jax(seed):
    gt, gj = np.random.default_rng(seed), np.random.default_rng(seed)
    for p in (0.1, 0.2, 0.3, 0.2):
        np.testing.assert_array_equal(mt.mar(SERIES, p, rng=gt)[1],
                                      mj.mar(SERIES, p, rng=gj)[1])


def test_mnar_highest_and_int_seeds_equal_jax():
    for a, b in zip(mt.mnar(SERIES, 0.3, "highest"),
                    mj.mnar(SERIES, 0.3, "highest")):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mt.mcar(SERIES, 0.4, rng=3)[1],
                                  mj.mcar(SERIES, 0.4, rng=3)[1])


@pytest.mark.parametrize("call,exc", [
    (lambda m: m.mcar(SERIES, 1.5), ValueError),
    (lambda m: m.mar(SERIES, -0.1), ValueError),
    (lambda m: m.mnar(SERIES, 0.2, "middle"), ValueError),
    (lambda m: m.state_space(10, 2, s=1), ValueError),
])
def test_simulation_errors_match_jax(call, exc):
    for m in (mt, mj):
        with pytest.raises(exc):
            call(m)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(period=12.0, slope=(-1.0, 1.0), phase=[0.0, np.pi], sigma=0.1),
    dict(period=(5.0, 9.0), sigma=0.3, return_metadata=False),
])
def test_trendy_sine_equals_jax(kw):
    Xt, it = mt.trendy_sine(64, 7, rng=np.random.default_rng(11), **kw)
    Xj, ij = mj.trendy_sine(64, 7, rng=np.random.default_rng(11), **kw)
    np.testing.assert_array_equal(Xt, Xj)
    if ij is None:
        assert it is None
    else:
        assert it.keys() == ij.keys()
        for k in ij:
            np.testing.assert_array_equal(it[k], ij[k])


@pytest.mark.parametrize("s,sigma", [(2, 0.3), (4, 0.1), (7, 1.0)])
def test_state_space_equals_jax(s, sigma):
    np.testing.assert_array_equal(
        mt.state_space(50, 4, s=s, sigma=sigma, rng=np.random.default_rng(5)),
        mj.state_space(50, 4, s=s, sigma=sigma, rng=np.random.default_rng(5)))

"""The port's hyperopt/ (``tune``, ``evaluate``, the losses, folds, windows,
grids and solvers) held against the JAX package on the CPU: the same folds,
windows, grids and trial sequences on the same seeds, the same cache keys
with losses within 1e-9 (one-sweep float64 fits on two_class_sines, chi <= 8,
d <= 3), the reference's evaluate protocol, and the numerical-error retry,
which lets anything but a numerical failure through."""

import os

import numpy as np
import pytest
import torch

import mpstime_tpu as mj
import mpstime_tpu_torch as mt
from mpstime_tpu.hyperopt import make_grid as jax_make_grid
from mpstime_tpu.hyperopt import random_search as jrs
from mpstime_tpu.hyperopt import tuning as jtuning
from mpstime_tpu_torch.hyperopt import make_grid, random_search, tuning

torch.set_num_threads(1)

LOSS_ATOL = 1e-9
F64_OPTS = dict(nsweeps=1, verbosity=-5, log_level=-1, dtype="float64")
PARAMS = {"chi_max": (4, 8), "d": [2, 3], "eta": (0.01, 0.1)}


def _sines(two_class_sines):
    Xtr, ytr, Xte, yte = two_class_sines
    return np.concatenate([Xtr, Xte]), np.concatenate([ytr, yte])


# ---- folds, windows, grids, parameter maps -----------------------------------

@pytest.mark.parametrize("rng", [0, 7])
@pytest.mark.parametrize("nfolds", [2, 5])
def test_stratified_folds_match_jax(rng, nfolds):
    ys = np.array([0] * 20 + [1] * 11 + [2] * 7)
    Xs = np.zeros((len(ys), 4))
    for shuffle in (True, False):
        a = mt.make_stratified_cvfolds(Xs, ys, nfolds, rng=rng,
                                       shuffle=shuffle)
        b = mj.make_stratified_cvfolds(Xs, ys, nfolds, rng=rng,
                                       shuffle=shuffle)
        for (ta, va), (tb, vb) in zip(a, b):
            np.testing.assert_array_equal(ta, tb)
            np.testing.assert_array_equal(va, vb)
    with pytest.raises(ValueError, match="empty"):
        mt.make_stratified_cvfolds(np.zeros((2, 3)), np.array([0, 1]), 5,
                                   rng=0)


def test_windows_match_jax():
    X = np.zeros((5, 50))
    for args in ((None, [0.1, 0.5, 30]), ([[1, 2, 3], [7]], None),
                 ({"b": [4, 5], "a": [1, 2]}, None)):
        a = mt.make_windows(*args, X, rng=np.random.default_rng(3))
        b = mj.make_windows(*args, X, rng=np.random.default_rng(3))
        assert len(a) == len(b)
        for wa, wb in zip(a, b):
            np.testing.assert_array_equal(wa, wb)
    for args in (([[1]], [0.5]), (None, None)):
        with pytest.raises(ValueError):
            mt.make_windows(*args, X)


@pytest.mark.parametrize("sampling,lb,ub,disc", [
    ("LatinHypercube", [0.0, 1.0, 2.0], [1.0, 5.0, 3.0], [False, True, True]),
    ("UniformRandom", [1.0, 0.5], [3.0, 0.9], [True, False]),
    ("Exhaustive", [1.0, 2.0], [3.0, 4.0], [True, True])])
def test_grids_and_trial_order_match_jax(sampling, lb, ub, disc):
    a = make_grid(np.random.default_rng(4), sampling, lb, ub, disc, 9)
    b = jax_make_grid(np.random.default_rng(4), sampling, lb, ub, disc, 9)
    np.testing.assert_array_equal(np.stack(a), np.stack(b))
    fields = ["chi_max", "d", "eta"][:len(lb)]
    np.testing.assert_array_equal(
        np.stack(random_search.sort_big_trials_first(a, fields)),
        np.stack(jrs.sort_big_trials_first(b, fields)))
    obj = lambda t: float(np.sum((np.asarray(t) - 2.2) ** 2))  # noqa: E731

    class Farmed:                   # grid_search's executor over a farm
        def map(self, f, xs):
            return mt.DeviceFarm(["cpu", "cpu"]).map(lambda x, dev: f(x), xs)

    for run in (None, Farmed()):
        np.testing.assert_array_equal(
            random_search.grid_search(
                np.random.default_rng(1), obj, mt.MPSRandomSearch(sampling),
                lb, ub, disc, fields, 9, executor=run),
            jrs.grid_search(np.random.default_rng(1), obj,
                            mj.MPSRandomSearch(sampling), lb, ub, disc,
                            fields, 9))
    with pytest.raises(ValueError):
        mt.MPSRandomSearch("Sobol")


@pytest.mark.parametrize("params,logspace", [
    (PARAMS, False), ({"eta": (1e-3, 1e-1), "chi_max": [20, 10, 15]}, True),
    ({"d": (2, 1, 6), "cutoff": (), "nsweeps": ()}, False),
    ({"chi_max": (4.0, 7.6)}, False)])
def test_parameter_maps_match_jax(params, logspace):
    to, jo = mt.MPSOptions(), mj.MPSOptions()
    a = tuning._parse_parameters(dict(params), to, logspace)
    b = jtuning._parse_parameters(dict(params), jo, logspace)
    for x, y in zip(a, b):
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y
    assert tuning._padded_caps(dict(params), to) == \
        jtuning._padded_caps(dict(params), jo)
    fields, x0, lb, ub, _, types, vm = a
    for point in (x0, lb, ub, (lb + ub) / 2):
        assert tuning._safe_paramlist(point, fields, types, vm, logspace) == \
            jtuning._safe_paramlist(point, fields, types, vm, logspace)


def test_parameter_errors_match_jax():
    for bad in ({"encoding": [1]}, {"nope": (1, 2)}, {"d": (1, 2, 3, 4)},
                {"d": 3}):
        with pytest.raises(ValueError):
            jtuning._parse_parameters(bad, mj.MPSOptions(), False)
        with pytest.raises(ValueError):
            tuning._parse_parameters(bad, mt.MPSOptions(), False)
    with pytest.raises(ValueError, match="positive"):
        tuning._parse_parameters({"eta": (0, 1)}, mt.MPSOptions(), True)


@pytest.mark.parametrize("method", ["Nelder-Mead", "differential_evolution"])
def test_scipy_solver_matches_jax(method):
    f = lambda x: float((x[0] - 0.3) ** 2 + (x[1] + 0.2) ** 2)  # noqa: E731
    kw = dict(maxiters=40)
    a = mt.ScipySolver(method).solve(f, np.zeros(2), -np.ones(2),
                                     np.ones(2), rng=np.random.default_rng(2),
                                     **kw)
    b = mj.ScipySolver(method).solve(f, np.zeros(2), -np.ones(2),
                                     np.ones(2), rng=np.random.default_rng(2),
                                     **kw)
    np.testing.assert_array_equal(a, b)
    assert mt.ScipySolver(method).supports_workers == \
        (method == "differential_evolution")
    with pytest.raises(ValueError):
        mt.ScipySolver("bogus")


def test_losses_and_helpers_match_jax(monkeypatch):
    for name in ("MisclassificationRate", "BalancedMisclassificationRate",
                 "ImputationLoss"):
        assert repr(getattr(mt, name)()) == repr(getattr(mj, name)())
    for val in ("1", "4"):
        monkeypatch.setenv("OMP_NUM_THREADS", val)
        assert mt.is_omp_threading() == mj.is_omp_threading()


# ---- tune ----------------------------------------------------------------------

def _tune_kw(objective, pkg, **kw):
    opts = {**F64_OPTS}
    if objective == "imputation":
        opts["sigmoid_transform"] = False
        kw["pms"] = [0.2]
    obj = {"misclassification": pkg.MisclassificationRate(),
           "balanced": pkg.BalancedMisclassificationRate(),
           "imputation": pkg.ImputationLoss()}[objective]
    return dict(nfolds=2, parameters=dict(PARAMS), rng=3, maxiters=3,
                verbosity=0, objective=obj,
                opts0=pkg.MPSOptions(**opts), **kw)


@pytest.mark.parametrize("objective,kw", [
    ("misclassification", dict(padded_trials=True)),
    ("balanced", dict(padded_trials=False)),
    ("imputation", dict(padded_trials=True)),
    ("misclassification", dict(padded_trials=True, fold_batch=True))],
    ids=["padded", "unpadded-balanced", "imputation", "fold-batch"])
def test_tune_matches_jax(two_class_sines, objective, kw):
    """The same trial sequence (cache keys in order) and the same best
    point; each trial's mean CV loss within 1e-9 (measured equal)."""
    Xs, ys = two_class_sines[0], two_class_sines[1]
    bt, ct = mt.tune(Xs, ys, **_tune_kw(objective, mt, **kw), device="cpu")
    bj, cj = mj.tune(Xs, ys, **_tune_kw(objective, mj, **kw))
    assert list(ct) == list(cj)
    for k in cj:
        assert ct[k] == pytest.approx(cj[k], abs=LOSS_ATOL)
    assert bt == bj


def test_fold_batch_equals_sequential_folds(two_class_sines):
    """fit_mps_batch trains each fold as fit_mps does (padded trials: the
    same caps and sample padding), so a trial's folds through it give the
    sequential trial losses exactly."""
    Xs, ys = two_class_sines[0], two_class_sines[1]
    kw = {**_tune_kw("imputation", mt, padded_trials=True), "maxiters": 1}
    assert mt.tune(Xs, ys, **kw, fold_batch=True, device="cpu") == \
        mt.tune(Xs, ys, **kw, device="cpu")


def test_tune_solver_route_matches_jax(two_class_sines):
    Xs, ys = two_class_sines[0], two_class_sines[1]
    eta = {"parameters": {"eta": (0.01, 0.1)}}
    bt, ct = mt.tune(Xs, ys, **{**_tune_kw("misclassification", mt), **eta},
                     method=mt.ScipySolver("Nelder-Mead"), device="cpu")
    bj, cj = mj.tune(Xs, ys, **{**_tune_kw("misclassification", mj), **eta},
                     method=mj.ScipySolver("Nelder-Mead"))
    assert list(ct) == list(cj) and len(ct) == 3
    for k in cj:
        assert ct[k] == pytest.approx(cj[k], abs=LOSS_ATOL)
    assert bt == bj


def test_tune_edge_cases(two_class_sines):
    Xs, ys = two_class_sines[0], two_class_sines[1]
    assert mt.tune(Xs, ys, parameters={}, device="cpu") == ({}, {})
    with pytest.warns(UserWarning, match="no cross-validation"):
        best, cache = mt.tune(Xs, ys, nfolds=1, parameters={"d": [2, 3]},
                              objective=mt.MisclassificationRate(),
                              device="cpu")
    assert cache == {} and best == {"d": 2}
    with pytest.raises(ValueError, match="logspace_eta"):
        mt.tune(Xs, ys, parameters={"eta": [0.1, 0.2, 0.3]},
                objective=mt.MisclassificationRate(), logspace_eta=True,
                device="cpu")


def test_numerical_failures_retry_with_svd(two_class_sines, monkeypatch):
    """A fold whose fit raises torch.linalg.LinAlgError is retried with
    svd_alg="svd" (tuning.jl:73-84); a RuntimeError, which a kernel that
    fails to build or launch raises, ends the search."""
    Xs, ys = two_class_sines[0], two_class_sines[1]
    real_fit = tuning.fit_mps
    algs = []

    def flaky(*args, opts=None, **kw):
        algs.append(opts.svd_alg)
        if opts.svd_alg != "svd":
            raise torch.linalg.LinAlgError("linalg.eigh: failed to converge")
        return real_fit(*args, opts=opts, **kw)

    monkeypatch.setattr(tuning, "fit_mps", flaky)
    kw = {**_tune_kw("misclassification", mt), "maxiters": 1}
    _, cache = mt.tune(Xs, ys, **kw, device="cpu")
    assert algs == ["auto", "svd", "auto", "svd"]
    assert all(np.isfinite(v) for v in cache.values())

    def broken(*args, **kw):
        raise RuntimeError("mpst_k12m_launch failed: CUDA error 700")

    monkeypatch.setattr(tuning, "fit_mps", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        mt.tune(Xs, ys, **kw, device="cpu")


def test_fold_batch_falls_back_only_on_numerical_errors(two_class_sines,
                                                        monkeypatch):
    Xs, ys = two_class_sines[0], two_class_sines[1]
    import mpstime_tpu_torch.training.fit as tfit
    calls = []
    monkeypatch.setattr(tfit, "fit_mps_batch", lambda *a, **k: (
        calls.append(1), (_ for _ in ()).throw(ValueError("labels"))))
    kw = {**_tune_kw("misclassification", mt, fold_batch=True),
          "maxiters": 1}
    _, cache = mt.tune(Xs, ys, **kw, device="cpu")
    assert calls == [1] and all(np.isfinite(v) for v in cache.values())
    monkeypatch.setattr(tfit, "fit_mps_batch", lambda *a, **k: (
        _ for _ in ()).throw(RuntimeError("CUDA error 700")))
    with pytest.raises(RuntimeError):
        mt.tune(Xs, ys, **kw, device="cpu")


# ---- evaluate --------------------------------------------------------------------

@pytest.fixture(scope="module")
def evaluations(two_class_sines):
    Xs, ys = _sines(two_class_sines)
    kw = dict(nfolds=5, tuning_parameters={"d": [2, 3]}, n_cvfolds=2,
              tuning_maxiters=2, verbosity=-1)
    opts = dict(nsweeps=1, chi_max=6, d=2, verbosity=-5, log_level=-1,
                dtype="float64")
    ours = mt.evaluate(Xs, ys, objective=mt.MisclassificationRate(),
                       opts0=mt.MPSOptions(**opts), device="cpu", **kw)
    theirs = mj.evaluate(Xs, ys, objective=mj.MisclassificationRate(),
                         opts0=mj.MPSOptions(**opts), **kw)
    return ours, theirs, len(ys)


def test_evaluate_speaks_the_reference_protocol(evaluations):
    """The 13 per-fold keys of the reference's stored baseline
    (tests/data/eval_results.jld2), its partition law, 0-based folds."""
    from mpstime_tpu_torch.models.itensor_import import \
        load_mpstime_jl_eval_results
    ours, _, N = evaluations
    ref_keys = set(load_mpstime_jl_eval_results(os.path.join(
        os.path.dirname(__file__), "data", "eval_results.jld2"))[0])
    assert [r["fold"] for r in ours] == [0, 1, 2, 3, 4]
    tests = np.concatenate([r["test_inds"] for r in ours])
    assert len(tests) == N and len(np.unique(tests)) == N
    for r in ours:
        assert set(r) == ref_keys
        tr, te = set(r["train_inds"].tolist()), set(r["test_inds"].tolist())
        assert not tr & te and len(tr) + len(te) == N
        assert len(te) in (N // 5, N // 5 + 1)
        assert r["objective"] == "MisclassificationRate()"
        assert 0.0 <= r["loss"] <= 1.0 and r["time"] > 0


def test_evaluate_matches_jax(evaluations):
    ours, theirs, _ = evaluations
    for a, b in zip(ours, theirs):
        for k in ("train_inds", "test_inds"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["opts"].to_dict() == b["opts"].to_dict()
        assert list(a["cache"]) == list(b["cache"])
        for k in b["cache"]:
            assert a["cache"][k] == pytest.approx(b["cache"][k],
                                                  abs=LOSS_ATOL)
        assert a["loss"] == pytest.approx(b["loss"], abs=LOSS_ATOL)
        assert (a["optimiser"], a["objective"]) == (b["optimiser"],
                                                    b["objective"])


def test_evaluate_imputation_writes_and_resumes(two_class_sines, tmp_path):
    Xs, ys = _sines(two_class_sines)
    kw = dict(nfolds=2, tuning_parameters={"d": [2, 3]}, n_cvfolds=2,
              tuning_maxiters=1, verbosity=-1, eval_pms=[0.2],
              opts0=mt.MPSOptions(nsweeps=1, chi_max=6, d=2, verbosity=-5,
                                  log_level=-1, dtype="float64",
                                  sigmoid_transform=False),
              write=True, writedir=str(tmp_path), simname="sim",
              device="cpu")
    first = mt.evaluate(Xs, ys, fold_inds=[0], **kw)
    assert os.path.isfile(tmp_path / "sim_tmp" / "f0.pkl")
    again = mt.evaluate(Xs, ys, fold_inds=[0], **kw)
    assert again[0]["time"] == first[0]["time"]      # resumed, not refit
    assert len(first[0]["eval_windows"]) == 1 and first[0]["loss"] > 0

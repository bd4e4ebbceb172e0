"""The port's plots (mpstime_tpu_torch/vis/) and the basis preview
``fit_mps(test_run=True)``, held against the JAX package's figures drawn
from the same inputs: every line's data, the histograms' bars, the texts
and ticks."""

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import mpstime_tpu as mj  # noqa: E402
import mpstime_tpu_torch as mt  # noqa: E402
from mpstime_tpu_torch.utils.preprocessing import transform_train_data  # noqa: E402

torch.set_num_threads(1)


def _lines(fig):
    return [(ax.get_title(), ln.get_label(), np.asarray(ln.get_xdata()),
             np.asarray(ln.get_ydata()))
            for ax in fig.axes for ln in ax.get_lines()]


def _bars(fig):
    return [(ax.get_title(), [(p.get_x(), p.get_width(), p.get_height())
                              for p in ax.patches]) for ax in fig.axes]


def _texts(fig):
    return [(ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
             [t.get_text() for t in ax.texts],
             [t.get_text() for t in ax.get_xticklabels()],
             [t.get_text() for t in ax.get_yticklabels()],
             list(ax.get_xticks()), list(ax.get_yticks()))
            for ax in fig.axes] + [fig._suptitle.get_text()
                                   if fig._suptitle else None]


def _same_figure(got, ref, rtol=1e-12, lines=True):
    try:
        assert _texts(got) == _texts(ref)
        gl, rl = _lines(got), _lines(ref)
        assert len(gl) == len(rl) and (len(gl) > 0) == lines
        for (gt, gn, gx, gy), (rt, rn, rx, ry) in zip(gl, rl):
            assert (gt, gn) == (rt, rn)
            np.testing.assert_allclose(gx, rx, rtol=rtol, atol=1e-14)
            np.testing.assert_allclose(gy, ry, rtol=rtol, atol=1e-14)
        assert _bars(got) == _bars(ref)
    finally:
        plt.close(got)
        plt.close(ref)


def _scaled(two_class_sines, encoding, d):
    Xtr, ytr, _, _ = two_class_sines
    Xs, _ = transform_train_data(Xtr, mt.MPSOptions(d=d, encoding=encoding,
                                                    verbosity=-1))
    return Xs, ytr


@pytest.mark.parametrize("encoding,d,with_data", [
    ("legendre", 4, False), ("legendre_no_norm", 5, True),
    ("fourier", 5, False), ("stoudenmire", 2, True), ("uniform", 3, True),
    ("SL", 3, True), ("SLTD", 3, True), ("hist_split_legendre", 4, True)])
def test_plot_encoding_matches_jax(two_class_sines, encoding, d, with_data):
    """Closed-form, complex (real part), data-driven and time-dependent
    bases (SLTD: one column a site, sites 0, T // 2, T - 1), in float64,
    with the histogram of the scaled data where it is passed."""
    args = _scaled(two_class_sines, encoding, d) if with_data else ()
    kw = {}
    if encoding in ("SL", "SLTD", "hist_split_legendre"):
        kw["opts"] = mt.MPSOptions(d=d, encoding=encoding, verbosity=-1)
        jkw = {"opts": mj.MPSOptions(d=d, encoding=encoding, verbosity=-1)}
    else:
        jkw = {}
    got = mt.plot_encoding(encoding, d, *args, device="cpu", **kw)
    ref = mj.plot_encoding(encoding, d, *args, **jkw)
    if encoding == "SLTD":
        assert [ax.get_title() for ax in got.axes[3:]] == \
            ["site 0", "site 24", "site 47"]
    _same_figure(got, ref)


def test_plot_encoding_sites_and_options(two_class_sines):
    Xs, ytr = _scaled(two_class_sines, "SLTD", 3)
    o = dict(d=3, encoding="SLTD", verbosity=-1)
    got = mt.plot_encoding("SLTD", 3, Xs, ytr, opts=mt.MPSOptions(**o),
                           sites=[3, 10], num_xvals=77, show_hist=False,
                           device="cpu")
    ref = mj.plot_encoding("SLTD", 3, Xs, ytr, opts=mj.MPSOptions(**o),
                           sites=[3, 10], num_xvals=77, show_hist=False)
    assert len(got.axes) == 2 and len(got.axes[0].get_lines()[0]
                                       .get_xdata()) == 77
    _same_figure(got, ref)


@pytest.mark.parametrize("encoding", ["SL", "SLTD"])
def test_plot_encoding_requires_data(encoding):
    with pytest.raises(ValueError, match="data-driven"):
        mt.plot_encoding(encoding, 3, device="cpu")
    with pytest.raises(ValueError, match="data-driven"):
        mj.plot_encoding(encoding, 3)


@pytest.mark.parametrize("confmat,labels", [
    (np.array([[10, 2], [3, 15]]), [0, 1]),
    (np.array([[30, 0, 0], [6, 23, 1], [0, 10, 20]]), None),
    (np.array([[5, 1, 0, 2], [0, 7, 1, 0], [1, 0, 9, 0], [0, 0, 2, 8]]),
     ["a", "b", "c", "d"])])
def test_plot_conf_mat_matches_jax(confmat, labels):
    got = mt.plot_conf_mat(confmat, labels)
    ref = mj.plot_conf_mat(confmat, labels)
    np.testing.assert_array_equal(got.axes[0].images[0].get_array(),
                                  ref.axes[0].images[0].get_array())
    assert len(got.axes[0].texts) == confmat.size
    _same_figure(got, ref, lines=False)


def _info(with_test: bool):
    rng = np.random.default_rng(3)
    n = 6
    info = {"train_loss": list(rng.random(n)),
            "train_acc": list(rng.random(n)),
            "time_taken": [0.0] + list(rng.random(n - 2)) + [float("nan")]}
    if with_test:
        info.update(test_loss=list(rng.random(n)),
                    test_acc=list(rng.random(n)))
    return info


@pytest.mark.parametrize("with_test", [True, False])
def test_plot_training_summary_matches_jax(capsys, with_test):
    info = _info(with_test)
    got = mt.plot_training_summary(info)
    printed = capsys.readouterr().out
    ref = mj.plot_training_summary(info)
    assert printed == capsys.readouterr().out
    assert len(got.axes[2].patches) == 4          # finite sweep times only
    _same_figure(got, ref)


def test_plot_training_summary_of_a_fit(ecg200):
    """The curves of a port fit's own info dict."""
    Xtr, ytr, Xte, yte = ecg200
    _, info, _ = mt.fit_mps(Xtr[:30, :16], ytr[:30], Xte[:20, :16], yte[:20],
                            mt.MPSOptions(nsweeps=2, chi_max=6, d=3,
                                          verbosity=-1), device="cpu")
    fig = mt.plot_training_summary(info)
    np.testing.assert_array_equal(fig.axes[1].get_lines()[0].get_ydata(),
                                  info["train_acc"])
    _same_figure(fig, mj.plot_training_summary(info))


@pytest.mark.parametrize("kw", [
    dict(), dict(encoding="fourier", d=4),
    dict(encoding="SLTD", d=3, sigmoid_transform=False)],
    ids=["legendre", "fourier", "sltd"])
def test_fit_mps_test_run_matches_jax(ecg200, kw):
    """The basis preview: (train_ds, test_ds, fig) without training, the
    encoded states on the fit's device at 1e-12 and the same figure."""
    Xtr, ytr, Xte, yte = ecg200
    X, y, Xt, yt = Xtr[:40, :24], ytr[:40], Xte[:30, :24], yte[:30]
    o = dict(verbosity=-1, dtype="complex128" if kw.get("encoding") ==
             "fourier" else "float64", **kw)
    tr, te, fig = mt.fit_mps(X, y, Xt, yt, opts=mt.MPSOptions(**o),
                             test_run=True, device="cpu")
    jtr, jte, jfig = mj.fit_mps(X, y, Xt, yt, opts=mj.MPSOptions(**o),
                                test_run=True)
    for g, r in ((tr, jtr), (te, jte)):
        assert g.X_enc.device.type == "cpu"
        np.testing.assert_allclose(g.X_enc.numpy(), np.asarray(r.X_enc),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_array_equal(g.y_idx, np.asarray(r.y_idx))
        np.testing.assert_allclose(g.X_scaled, np.asarray(r.X_scaled),
                                   rtol=1e-12, atol=1e-14)
    _same_figure(fig, jfig)

"""The one traffic generator: a traffic file's parameters and a seed in, the
train and test sets out.  Two kinds: ``file`` (a vendored set, the same for
every seed) and ``two_sine`` (sin(t + phase) against sin(3t + phase) plus
noise, drawn from the seed at the file's sizes)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of a run: any whole number seeds it."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2 ** 64, *stream]))


def synth_two_sine(rng, n_a, n_b, T, t_max=2 * np.pi, noise=0.1):
    """Two classes: sin(t + phase) and sin(3t + phase), phases uniform in
    [0, 6), plus Gaussian noise; labels 0 then 1."""
    t_ax = np.linspace(0, t_max, T)
    X = np.concatenate([
        np.sin(t_ax[None] + rng.uniform(0, 6, (n_a, 1))),
        np.sin(3 * t_ax[None] + rng.uniform(0, 6, (n_b, 1)))])
    X += noise * rng.standard_normal(X.shape)
    return X, np.repeat([0, 1], [n_a, n_b])


def make_data(traffic: dict, seed: int):
    """(X_train, y_train, X_test, y_test) of a traffic mix."""
    kind = traffic["kind"]
    if kind == "file":
        d = np.load(REPO / traffic["file"])
        return d["X_train"], d["y_train"], d["X_test"], d["y_test"]
    if kind == "two_sine":
        p, T = traffic["two_sine"], traffic["shape"]["T"]
        rng = seed_rng(seed, 1)
        X_tr, y_tr = synth_two_sine(rng, *p["n_train"], T, p["t_max"],
                                    p["noise"])
        X_te, y_te = synth_two_sine(rng, *p["n_test"], T, p["t_max"],
                                    p["noise"])
        return X_tr, y_tr, X_te, y_te
    raise ValueError(f"unknown traffic kind {kind!r}")

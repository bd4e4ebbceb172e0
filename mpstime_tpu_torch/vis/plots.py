"""Confusion-matrix heatmap and training-curve plots (a copy of
``mpstime_tpu/vis/plots.py``; reference summary.jl:204-222 plot_conf_mat,
utils.jl:111-158 plot_training_summary).  matplotlib is imported when a
plot is drawn, never when the module is imported."""

from __future__ import annotations

from typing import Dict

import numpy as np


def plot_conf_mat(confmat: np.ndarray, class_labels=None):
    """Confusion-matrix heatmap with count annotations
    (reference plot_conf_mat, summary.jl:204-222).  Returns a Figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    confmat = np.asarray(confmat)
    C = confmat.shape[0]
    if class_labels is None:
        class_labels = list(range(C))
    fig, ax = plt.subplots(figsize=(1.2 * C + 3, 1.2 * C + 2))
    im = ax.imshow(confmat, cmap="Blues")
    for i in range(C):
        for j in range(C):
            ax.text(j, i, str(confmat[i, j]), ha="center", va="center",
                    color="black")
    ax.set_xticks(range(C), [f"Predicted {l}" for l in class_labels])
    ax.set_yticks(range(C), [f"Actual {l}" for l in class_labels])
    ax.set_xlabel("Predicted class")
    ax.set_ylabel("Actual class")
    ax.set_title("Confusion Matrix")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return fig


def plot_training_summary(info: Dict[str, list]):
    """Loss/accuracy curves + per-sweep timing bars
    (reference plot_training_summary, utils.jl:111-158).  Returns a Figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    times = [t for t in info.get("time_taken", []) if np.isfinite(t)]
    if times:
        print(f"Mean sweep time: {np.mean(times[1:]) if len(times) > 1 else times[0]} (s)")
    if info.get("test_acc"):
        best = int(np.argmax(info["test_acc"]))
        print(f"Maximum test accuracy: {info['test_acc'][best]} achieved on "
              f"sweep {best}")

    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    sweeps = np.arange(len(info.get("train_loss", [])))

    ax = axes[0]
    ax.plot(sweeps, info.get("train_loss", []), "o-", alpha=0.6,
            label="train loss")
    if info.get("test_loss"):
        ax.plot(sweeps, info["test_loss"], "o-", alpha=0.6, label="test loss")
    ax.set_xlabel("Sweep")
    ax.set_ylabel("Loss")
    ax.legend()

    ax = axes[1]
    ax.plot(sweeps, info.get("train_acc", []), "o-", alpha=0.6,
            label="train acc")
    if info.get("test_acc"):
        ax.plot(sweeps, info["test_acc"], "o-", alpha=0.6, label="test acc")
    ax.set_xlabel("Sweep")
    ax.set_ylabel("Accuracy")
    ax.legend()

    ax = axes[2]
    tt = info.get("time_taken", [])[1:]
    tt = [t for t in tt if np.isfinite(t)]
    ax.bar(np.arange(1, len(tt) + 1), tt, color="skyblue")
    ax.set_xlabel("Sweep")
    ax.set_ylabel("Time taken (s)")
    ax.set_title("Training time per sweep")

    fig.tight_layout()
    return fig

"""Basis visualisation (counterpart of ``mpstime_tpu/vis/vis_encodings.py``;
reference src/Vis/vis_encodings.jl plot_encoding)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..encodings import get_encoding
from ..options import MPSOptions


def plot_encoding(encoding, d: int, X_train: Optional[np.ndarray] = None,
                  y_train: Optional[np.ndarray] = None, *,
                  opts: Optional[MPSOptions] = None,
                  num_xvals: int = 500,
                  sites: Optional[Sequence[int]] = None,
                  show_hist: bool = True, device="cuda"):
    """Plot the d basis functions of ``encoding`` over its domain, with an
    optional histogram of (scaled) training data (reference
    plot_encoding, vis_encodings.jl:2-156).

    ``encoding`` is an encoding name or EncodingSpec.  Data-driven encodings
    require ``X_train`` (already scaled to the encoding domain).  The basis
    is evaluated in float64 on ``device``, the card ("cuda", the default)
    or "cpu".  Returns a matplotlib Figure; matplotlib is imported here.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(encoding, str):
        spec = get_encoding(encoding,
                            project=bool(opts and opts.projected_basis))
        enc_name = encoding
    else:
        spec = encoding
        enc_name = spec.name
    if opts is None:
        opts = MPSOptions(d=d, encoding=enc_name if isinstance(encoding, str)
                          else "custom", verbosity=-1)

    a, b = spec.range
    xs = np.linspace(a, b, num_xvals)

    enc_args = None
    if spec.init is not None:
        if X_train is None:
            raise ValueError(f"{spec.name} is data-driven: pass X_train "
                             "(scaled to the encoding domain)")
        y = np.zeros(X_train.shape[0], int) if y_train is None else y_train
        enc_args = spec.init(np.asarray(X_train, np.float64), y, d, opts)

    if spec.is_time_dependent:
        if X_train is None:
            raise ValueError(f"{spec.name} is time-dependent: pass X_train "
                             "to define the number of sites")
        if sites is None:
            T = X_train.shape[1]
            sites = sorted(set([0, T // 2, T - 1]))
        n_cols = len(sites)
    else:
        sites = [0]
        n_cols = 1

    def encode(X: np.ndarray) -> np.ndarray:
        Xd = torch.as_tensor(X, dtype=torch.float64, device=device)
        return spec.encode_batch(Xd, d, enc_args).cpu().numpy()

    n_rows = 2 if (show_hist and X_train is not None) else 1
    fig, axes = plt.subplots(n_rows, n_cols,
                             figsize=(4.5 * n_cols, 3.5 * n_rows),
                             squeeze=False)

    for ci, t in enumerate(sites):
        if spec.is_time_dependent:
            T = X_train.shape[1]
            Xg = np.zeros((len(xs), T))
            Xg[:, t] = xs
            vals = encode(Xg)[:, t, :]
        else:
            vals = encode(xs[None, :])[0]
        ax = axes[-1][ci]
        for k in range(vals.shape[-1]):
            ax.plot(xs, vals[:, k].real, label=f"b{k}")
        ax.set_xlabel("x")
        ax.set_ylabel("real{Encoding}")
        if spec.is_time_dependent:
            ax.set_title(f"site {t}")
        if d <= 8:
            ax.legend(fontsize=7)

        if n_rows == 2:
            axh = axes[0][ci]
            data = X_train[:, t] if spec.is_time_dependent else \
                np.asarray(X_train).ravel()
            axh.hist(data, bins=25, range=(a, b))
            axh.set_ylabel("Frequency")
            axh.set_title(f"site {t}" if spec.is_time_dependent
                          else "All Observations")

    fig.suptitle(f"Histogram and Basis: {spec.name}")
    fig.tight_layout()
    return fig

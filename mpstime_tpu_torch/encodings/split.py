"""Split (binned) bases (counterpart of ``mpstime_tpu/encodings/split.py``):
uniform-width and histogram (equal-count) bins with an auxiliary encoding
applied within each bin (reference src/Encodings/splitbases.jl).  The bin
edges are host numpy, line for line the JAX package's; the encoding runs on
torch tensors on the data's device.

The encoded vector concatenates, over bins, ``select_i(x) * aux_enc(x_local)``
where select is 1 strictly inside bin i, 0.5 on shared edges (so boundary
points keep unit total weight, splitbases.jl:96-108), and x_local rescales the
bin interior to the full encoding domain.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .bases import const
from .registry import EncodingSpec


def get_nbins_safely(d: int, aux_basis_dim: int) -> int:
    if d % aux_basis_dim != 0:
        raise ValueError(
            f"The auxiliary basis dimension ({aux_basis_dim}) must evenly "
            f"divide the total feature dimension ({d})")
    return d // aux_basis_dim


def unif_split(X: np.ndarray, nbins: int, a: float, b: float) -> np.ndarray:
    """Equal-width bin edges (reference unif_split, splitbases.jl:51-54)."""
    return np.linspace(a, b, nbins + 1)


def hist_split_1d(samples: np.ndarray, nbins: int, a: float, b: float
                  ) -> np.ndarray:
    """Equal-count (histogram) bin edges for one timepoint's samples
    (reference hist_split, splitbases.jl:56-88)."""
    samples = np.asarray(samples, dtype=np.float64)
    npts = len(samples)
    bin_pts = int(round(npts / nbins))
    if bin_pts == 0:
        warnings.warn("Less than one data point per bin! Putting the extra "
                      "bins at the upper edge")
        bin_pts = 1
    bins = np.full(nbins + 1, a, dtype=np.float64)
    ds = np.sort(samples[(a <= samples) & (samples <= b)])
    j = 1
    for i in range(1, len(ds) + 1):
        if i % bin_pts == 0 and i < npts:
            if j == nbins:
                break
            bins[j] = (ds[i - 1] + ds[i]) / 2
            j += 1
    if j <= nbins - 1:
        bins[bins == a] = b
        bins[0] = a
    bins[-1] = b
    return bins


def hist_split(X: np.ndarray, nbins: int, a: float, b: float) -> np.ndarray:
    """Per-timepoint histogram bins [T, nbins+1]; X is [N, T] (the reference
    passes series-as-columns and iterates rows, splitbases.jl:90-92)."""
    X = np.asarray(X, dtype=np.float64)
    return np.stack([hist_split_1d(X[:, t], nbins, a, b)
                     for t in range(X.shape[1])])


def _project_onto_bins_batch(X: torch.Tensor, aux_spec: EncodingSpec,
                             aux_dim: int, bins, aux_enc_args, a: float,
                             b: float, timedep_bins: bool) -> torch.Tensor:
    """Vectorised split encode: X [N, T] -> [N, T, nbins*aux_dim]."""
    scale = b - a
    bins = const(bins, X)                      # [nbins+1] or [T, nbins+1]
    if timedep_bins:
        lo = bins[None, :, :-1]                # [1, T, nbins]
        hi = bins[None, :, 1:]
    else:
        lo = bins[None, None, :-1]             # [1, 1, nbins]
        hi = bins[None, None, 1:]
    nbins = lo.shape[-1]
    x = X[..., None]                           # [N, T, 1]
    dx = hi - lo
    # hist_split_1d collapses unfillable bins to zero width (duplicate
    # edges); guard the division and never select a degenerate bin
    deg = dx <= 0
    x_prop = scale * (x - lo) / torch.where(deg, torch.ones_like(dx), dx)
    frac = x_prop / scale                      # in [0, 1] inside bin i

    inside = (frac > 0) & (frac < 1)
    on_lo = frac == 0
    on_hi = frac == 1
    idx = torch.arange(nbins, device=X.device)
    first = idx == 0
    last = idx == nbins - 1
    # a shared edge normally splits weight 0.5/0.5 with the neighbour; if
    # the neighbour is degenerate it can't take its half
    prev_deg = torch.cat([torch.ones_like(deg[..., :1]), deg[..., :-1]],
                         dim=-1)
    next_deg = torch.cat([deg[..., 1:], torch.ones_like(deg[..., :1])],
                         dim=-1)
    one, half = torch.ones_like(dx), torch.full_like(dx, 0.5)
    select = (inside * 1.0
              + on_lo * torch.where(first | prev_deg, one, half)
              + on_hi * torch.where(last | next_deg, one, half))
    select = select * (~deg)

    # aux encoding at the bin-local coordinate a + x_prop, clipped into the
    # domain (clipped values are masked by select anyway)
    x_local = torch.clamp(a + x_prop, a, b)    # [N, T, nbins]
    # encode all bins at once: reshape the bin axis into the batch
    N, T = X.shape
    xl = torch.movedim(x_local, -1, 0).reshape(nbins * N, T)
    enc = aux_spec.encode_batch(xl, aux_dim, aux_enc_args)
    enc = enc.reshape(nbins, N, T, aux_dim)
    enc = torch.movedim(enc, 0, 2)             # [N, T, nbins, aux_dim]
    out = enc * select[..., None].to(enc.dtype)
    return out.reshape(N, T, nbins * aux_dim)


def make_split_encoding(kind: str, aux: EncodingSpec) -> EncodingSpec:
    """Build a SplitBasis EncodingSpec (reference histogram_split /
    uniform_split, basis_structs.jl:247-276)."""
    if aux.is_data_driven or aux.is_time_dependent:
        raise ValueError("Splitting up a data-driven encoding is not yet "
                         "supported, sorry")
    a, b = aux.range
    is_hist = kind == "hist"
    name = ("Hist Split " if is_hist else "Unif Split ") + aux.name
    timedep = is_hist     # histogram bins are per-timepoint

    def init(X_scaled, y, d, opts):
        nbins = get_nbins_safely(d, opts.aux_basis_dim)
        if is_hist:
            bins = hist_split(X_scaled, nbins, a, b)
        else:
            bins = unif_split(X_scaled, nbins, a, b)
        return {"bins": bins, "aux_basis_dim": opts.aux_basis_dim}

    def encode_batch(X, d, enc_args):
        bins = np.asarray(enc_args["bins"])
        aux_dim = int(enc_args["aux_basis_dim"])
        return _project_onto_bins_batch(X, aux, aux_dim, bins, None, a, b,
                                        timedep_bins=bins.ndim == 2)

    return EncodingSpec(name, aux.is_complex, timedep, True, (a, b),
                        init, encode_batch)

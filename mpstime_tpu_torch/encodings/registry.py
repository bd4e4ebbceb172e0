"""Encoding registry (counterpart of ``mpstime_tpu/encodings/registry.py``):
maps canonical encoding names to EncodingSpec objects.

The reference models encodings as structs of closures (basis_structs.jl:49-92)
constructed by ``model_encoding`` (options.jl:243-279).  Here an encoding is a
lightweight spec with a host-side ``init`` (runs once on training data, numpy)
and an ``encode_batch`` on torch tensors, evaluated on the data's device over
the whole batch at once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..options import canonical_encoding_name
from . import bases


@dataclass(frozen=True)
class EncodingSpec:
    name: str
    is_complex: bool
    is_time_dependent: bool
    is_data_driven: bool
    range: Tuple[float, float]
    # init(X_scaled[N,T], y[N], d, opts) -> enc_args (dict of numpy) | None
    init: Optional[Callable] = None
    # encode_batch(X [N, T] tensor, d, enc_args) -> [N, T, d] on X's device
    encode_batch: Callable = None

    def __repr__(self):
        return f"EncodingSpec({self.name})"


# ---------------------------------------------------------------------------
# closed-form encode_batch implementations (x: [N, T] scaled data)

def _enc_uniform(X, d, enc_args=None):
    return bases.uniform_encode(X, d)


def _enc_stoudenmire(X, d, enc_args=None):
    return bases.angle_encode(X, d)


def _enc_fourier(X, d, enc_args=None):
    if enc_args is not None and "freq_select" in enc_args:
        # projected Fourier: per-time frequency selection [T, d]
        return _timedep_select_fourier(X, d, enc_args)
    return bases.fourier_encode(X, d)


def _timedep_select_fourier(X, d, enc_args):
    # phi[n, t, k] = exp(i pi f[t, k] x[n, t]) / sqrt(max_series_terms)
    # (Euler form, no complex constants — see bases._cis)
    freqs = bases.const(enc_args["freq_select"], X)       # [T, d] float
    nds = float(enc_args["max_series_terms"])
    return bases._cis(math.pi * X[..., None] * freqs) / math.sqrt(nds)


def _enc_legendre(X, d, enc_args=None, norm=False):
    if enc_args is not None and "order_select" in enc_args:
        return _timedep_select_legendre(X, d, enc_args, norm)
    return bases.legendre_encode(X, d, norm=norm)


def _timedep_select_legendre(X, d, enc_args, norm):
    orders = np.asarray(enc_args["order_select"])          # [T, d] int (static)
    lmax = int(orders.max())
    allp = bases.legendre_stack(X, lmax)                   # [N, T, lmax+1]
    idx = bases.const(orders, X, torch.int64)[None].expand(
        allp.shape[:-1] + (orders.shape[1],))
    sel = torch.gather(allp, -1, idx)
    if norm:
        # per-timepoint normalization by that timepoint's max selected order
        # (reference legendre_encode(x, nds, ds[ti]), bases.jl:94-107; the
        # max(l, 1) guard avoids /0 for an all-order-0 selection)
        lmax_t = orders.max(axis=1)                        # [T]
        factor = np.sqrt([bases._legendre_norm_const(int(l)) * max(int(l), 1)
                          for l in lmax_t])
        sel = sel / bases.const(factor, sel)[None, :, None]
    return sel


def _enc_legendre_norm(X, d, enc_args=None):
    return _enc_legendre(X, d, enc_args, norm=True)


def _enc_sahand(X, d, enc_args=None):
    return bases.sahand_encode(X, d)


def _enc_sahand_legendre(X, d, enc_args):
    """Data-driven Sahand-Legendre basis (reference bases.jl:111-129).

    enc_args: kde_samples [M] (train values), kde_bw (scalar), minx, scale,
    cvecs [d, d].  f0 = max(sqrt(max(pdf(x), 0)), minx);
    phi_n(x) = (sum_i c_{n,i} x^i) * f0 / scale.
    """
    from .data_driven import kde_pdf
    pdf = kde_pdf(X, enc_args["kde_samples"], float(enc_args["kde_bw"]))
    f0 = torch.clamp(torch.sqrt(torch.clamp(pdf, min=0.0)),
                     min=float(enc_args["minx"]))
    polys = bases.polyval_matrix(X, enc_args["cvecs"])    # [..., d]
    return polys * (f0 / float(enc_args["scale"]))[..., None]


def _enc_sahand_legendre_td(X, d, enc_args):
    """Time-dependent Sahand-Legendre (reference bases.jl:119-129, init :310-342).

    enc_args hold per-timepoint arrays stacked on axis 0: kde_samples [T, M]
    (nan-padded), kde_bw [T], minx [T], scale [T], cvecs [T, d, d].
    """
    from .data_driven import kde_pdf_masked
    pdf = kde_pdf_masked(X, enc_args["kde_samples"],
                         enc_args["kde_bw"])               # [N, T]
    f0 = torch.maximum(torch.sqrt(torch.clamp(pdf, min=0.0)),
                       bases.const(enc_args["minx"], X))  # bcast [T]
    cvecs = bases.const(enc_args["cvecs"], X)              # [T, d, d]
    powers = torch.pow(X[..., None], torch.arange(
        cvecs.shape[-1], dtype=X.dtype, device=X.device))
    polys = torch.einsum("nti,tdi->ntd", powers, cvecs)
    scale = bases.const(enc_args["scale"], X)
    return polys * (f0 / scale)[..., None]


# ---------------------------------------------------------------------------

def get_encoding(name: str, project: bool = False,
                 custom: Optional[EncodingSpec] = None) -> EncodingSpec:
    """Look up an EncodingSpec by (canonical) name.

    ``project=True`` turns Legendre/Fourier into their data-driven projected
    variants (reference basis_structs.jl:114-139).  ``custom`` supplies a
    user-defined basis when name == 'custom' (reference function_basis,
    basis_structs.jl:235-244).
    """
    s = canonical_encoding_name(name)

    if s.startswith(("hist_split_", "unif_split_")):
        from .split import make_split_encoding
        kind, aux_name = ("hist", s[len("hist_split_"):]) if s.startswith("hist_split_") \
            else ("unif", s[len("unif_split_"):])
        return make_split_encoding(kind, get_encoding(aux_name, project=False, custom=custom))

    if s == "custom":
        if custom is None:
            raise ValueError("encoding='custom' requires a custom EncodingSpec "
                             "(see function_basis)")
        return custom

    if s == "erf":
        # parity with the reference's erf() placeholder, which constructs a
        # basis whose encode function unconditionally errors
        # (basis_structs.jl:178-185); it is not implemented there either
        raise NotImplementedError(
            "The 'erf' basis is a placeholder in MPSTime (reference "
            "basis_structs.jl:178-185) and is not implemented here either.")

    if s == "legendre_no_norm":
        if project:
            from .data_driven import init_project_legendre
            return EncodingSpec("Projected Legendre", False, True, True, (-1.0, 1.0),
                                init_project_legendre, _enc_legendre)
        return EncodingSpec("Legendre", False, False, False, (-1.0, 1.0),
                            None, _enc_legendre)
    if s == "legendre_norm":
        if project:
            from .data_driven import init_project_legendre
            return EncodingSpec("Projected Legendre_Norm", False, True, True, (-1.0, 1.0),
                                init_project_legendre, _enc_legendre_norm)
        return EncodingSpec("Legendre_Norm", False, False, False, (-1.0, 1.0),
                            None, _enc_legendre_norm)
    if s == "fourier":
        if project:
            from .data_driven import init_project_fourier
            return EncodingSpec("Projected Fourier", True, True, True, (-1.0, 1.0),
                                init_project_fourier, _enc_fourier)
        return EncodingSpec("Fourier", True, False, False, (-1.0, 1.0),
                            None, _enc_fourier)
    if s == "stoudenmire":
        return EncodingSpec("Stoudenmire", True, False, False, (0.0, 1.0),
                            None, _enc_stoudenmire)
    if s == "sahand":
        return EncodingSpec("Sahand", True, False, False, (0.0, 1.0),
                            None, _enc_sahand)
    if s == "uniform":
        return EncodingSpec("Uniform", False, False, False, (0.0, 1.0),
                            None, _enc_uniform)
    if s == "sahand_legendre":
        from .data_driven import init_sahand_legendre
        return EncodingSpec("Sahand-Legendre Time Independent", False, False, True,
                            (-1.0, 1.0), init_sahand_legendre, _enc_sahand_legendre)
    if s == "sahand_legendre_time_dependent":
        from .data_driven import init_sahand_legendre_time_dependent
        return EncodingSpec("Sahand-Legendre Time Dependent", False, True, True,
                            (-1.0, 1.0), init_sahand_legendre_time_dependent,
                            _enc_sahand_legendre_td)
    raise ValueError(f"Unknown encoding {name!r}")


def function_basis(basis: Callable, is_complex: bool, range: Tuple[float, float],
                   is_time_dependent: bool = False, is_data_driven: bool = False,
                   init: Optional[Callable] = None, name: str = "Custom"
                   ) -> EncodingSpec:
    """Construct a custom encoding from a function on torch tensors
    (reference basis_structs.jl:235-244).

    Signature: ``basis(x, d, *enc_args) -> [..., d]`` operating on batched x
    ([N, T] scaled data; for a time-dependent basis it receives the full [N, T]
    array and must return [N, T, d] using its per-time enc_args).
    """
    def encode_batch(X, d, enc_args=None):
        args = () if enc_args is None else (enc_args,)
        return basis(X, d, *args)

    return EncodingSpec(name, is_complex, is_time_dependent, is_data_driven,
                        range, init, encode_batch)


# convenience constructors mirroring the reference's exported basis constructors
# (basis_structs.jl:101-283)

def stoudenmire() -> EncodingSpec:
    return get_encoding("stoudenmire")


def fourier(project: bool = False) -> EncodingSpec:
    return get_encoding("fourier", project=project)


def legendre(norm: bool = False, project: bool = False) -> EncodingSpec:
    return get_encoding("legendre_norm" if norm else "legendre_no_norm",
                        project=project)


def legendre_no_norm(project: bool = False) -> EncodingSpec:
    return get_encoding("legendre_no_norm", project=project)


def sahand() -> EncodingSpec:
    return get_encoding("sahand")


def uniform() -> EncodingSpec:
    return get_encoding("uniform")


def sahand_legendre(time_dependent: bool = True) -> EncodingSpec:
    return get_encoding("sahand_legendre_time_dependent" if time_dependent
                        else "sahand_legendre")


def histogram_split(aux: str = "uniform") -> EncodingSpec:
    return get_encoding(f"hist_split_{aux}")


def uniform_split(aux: str = "uniform") -> EncodingSpec:
    return get_encoding(f"unif_split_{aux}")


def encoding_range(name: str) -> Tuple[float, float]:
    """Domain of the (canonical) encoding without constructing data-driven state."""
    s = canonical_encoding_name(name)
    while s.startswith(("hist_split_", "unif_split_")):
        s = s.split("split_", 1)[1]
    if s in ("stoudenmire", "sahand", "uniform"):
        return (0.0, 1.0)
    return (-1.0, 1.0)

"""Encoding registry (counterpart of ``mpstime_tpu/encodings/registry.py``)
for the closed-form bases: ``legendre*``, ``uniform`` and the complex
``fourier``, ``stoudenmire`` and ``sahand``.  The other encodings are later
slices of the port and raise ``NotImplementedError`` naming the module of
the JAX package they wait for."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from ..options import canonical_encoding_name
from . import bases


@dataclass(frozen=True)
class EncodingSpec:
    name: str
    is_complex: bool
    is_time_dependent: bool
    is_data_driven: bool
    range: Tuple[float, float]
    # init(X_scaled[N,T], y[N], d, opts) -> enc_args | None
    init: Optional[Callable] = None
    # encode_batch(X [N, T] tensor, d, enc_args) -> [N, T, d]
    encode_batch: Callable = None

    def __repr__(self):
        return f"EncodingSpec({self.name})"


def _enc_uniform(X, d, enc_args=None):
    return bases.uniform_encode(X, d)


def _enc_stoudenmire(X, d, enc_args=None):
    return bases.angle_encode(X, d)


def _enc_fourier(X, d, enc_args=None):
    return bases.fourier_encode(X, d)


def _enc_sahand(X, d, enc_args=None):
    return bases.sahand_encode(X, d)


def _enc_legendre(X, d, enc_args=None):
    return bases.legendre_encode(X, d, norm=False)


def _enc_legendre_norm(X, d, enc_args=None):
    return bases.legendre_encode(X, d, norm=True)


_DATA_DRIVEN = ("it waits for the port of mpstime_tpu's "
                "encodings/data_driven.py")
_LATER = {
    "sahand_legendre": _DATA_DRIVEN,
    "sahand_legendre_time_dependent": _DATA_DRIVEN,
    "custom": "it waits for the port of mpstime_tpu's "
              "encodings/registry.py function_basis (custom encodings)",
    "erf": "no port is planned, 'erf' is a placeholder basis in MPSTime "
           "(reference basis_structs.jl:178-185) and in mpstime_tpu",
}


def get_encoding(name: str, project: bool = False) -> EncodingSpec:
    """Look up an EncodingSpec by (canonical) name."""
    s = canonical_encoding_name(name)
    if s.startswith(("hist_split_", "unif_split_")):
        raise NotImplementedError(
            f"encoding {name!r}: split bases are not ported yet: they wait "
            "for the port of mpstime_tpu's encodings/split.py")
    if project:
        raise NotImplementedError(
            f"projected_basis=True ({name!r}) is not ported yet: "
            + _DATA_DRIVEN)
    if s in _LATER:
        raise NotImplementedError(
            f"encoding {name!r} is not ported yet: {_LATER[s]}")
    if s == "legendre_no_norm":
        return EncodingSpec("Legendre", False, False, False, (-1.0, 1.0),
                            None, _enc_legendre)
    if s == "legendre_norm":
        return EncodingSpec("Legendre_Norm", False, False, False, (-1.0, 1.0),
                            None, _enc_legendre_norm)
    if s == "uniform":
        return EncodingSpec("Uniform", False, False, False, (0.0, 1.0),
                            None, _enc_uniform)
    if s == "fourier":
        return EncodingSpec("Fourier", True, False, False, (-1.0, 1.0),
                            None, _enc_fourier)
    if s == "stoudenmire":
        return EncodingSpec("Stoudenmire", True, False, False, (0.0, 1.0),
                            None, _enc_stoudenmire)
    if s == "sahand":
        return EncodingSpec("Sahand", True, False, False, (0.0, 1.0),
                            None, _enc_sahand)
    raise ValueError(f"Unknown encoding {name!r}")


def encoding_range(name: str) -> Tuple[float, float]:
    """Domain of the (canonical) encoding."""
    s = canonical_encoding_name(name)
    while s.startswith(("hist_split_", "unif_split_")):
        s = s.split("split_", 1)[1]
    if s in ("stoudenmire", "sahand", "uniform"):
        return (0.0, 1.0)
    return (-1.0, 1.0)

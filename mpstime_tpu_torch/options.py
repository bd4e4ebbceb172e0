"""Training options for the PyTorch port.

Same fields, defaults and JSON as ``mpstime_tpu.options.MPSOptions``, so one
options file drives both packages.  The ``resolved_*`` policies key on the
``torch.device`` a fit runs on, the card unless the caller names the CPU:
``cuda`` resolves as the JAX package's accelerator branch does (its
``jax.default_backend()`` on a TPU), ``cpu`` as its CPU branch does.
``resolved_dtype``
defaults to float32 (complex64 for complex encodings), as JAX without x64.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

_COMPLEX_ENCODINGS = frozenset({
    "fourier", "stoudenmire", "sahand",
})


def canonical_encoding_name(name: str) -> str:
    """Normalise encoding names as the reference's ``model_encoding`` does
    (options.jl:243-279): lowercase, aliases collapsed."""
    s = name.lower().strip()
    aliases = {
        "legendre": "legendre_no_norm",
        "legendre_no_norm": "legendre_no_norm",
        "legendre_norm": "legendre_norm",
        "stoudenmire": "stoudenmire",
        "fourier": "fourier",
        "sahand": "sahand",
        "sl": "sahand_legendre",
        "sahand_legendre": "sahand_legendre",
        "sahand_legendre_time_independent": "sahand_legendre",
        "sltd": "sahand_legendre_time_dependent",
        "sahand_legendre_time_dependent": "sahand_legendre_time_dependent",
        "uniform": "uniform",
        "custom": "custom",
        "erf": "erf",
    }
    if s in aliases:
        return aliases[s]
    for prefix, canon in (("hist_split_", "hist_split_"),
                          ("histogram_split_", "hist_split_"),
                          ("unif_split_", "unif_split_"),
                          ("uniform_split_", "unif_split_")):
        if s.startswith(prefix):
            return canon + canonical_encoding_name(s[len(prefix):])
    raise ValueError(
        f"Unknown encoding {name!r}. Options: legendre, legendre_norm, fourier, "
        f"stoudenmire, sahand, sahand_legendre (sl), sahand_legendre_time_dependent (sltd), "
        f"uniform, custom, hist_split_<basis>, unif_split_<basis>")


def encoding_is_complex(name: str) -> bool:
    s = canonical_encoding_name(name)
    while s.startswith(("hist_split_", "unif_split_")):
        s = s.split("split_", 1)[1]
    return s in _COMPLEX_ENCODINGS


#: Largest chi_max at which the plain warm split tracks the complex
#: encodings' degenerate bond spectra; above it svd_alg="auto" resolves to
#: "randomized_warm_ritz" for complex encodings (mpstime_tpu/options.py:85).
COMPLEX_RITZ_CHI_GATE = 40


def _device(device) -> torch.device:
    return device if isinstance(device, torch.device) else torch.device(device)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or dtype name); a torch dtype
    passes through."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


@dataclass(frozen=True)
class MPSOptions:
    """Hyperparameters and options for :func:`fit_mps`; field semantics as in
    ``mpstime_tpu.options.MPSOptions`` and the reference (options.jl:11-39)."""

    # Logging
    verbosity: int = 1
    log_level: int = 3
    track_cost: bool = False

    # MPS training hyperparameters
    nsweeps: int = 10
    chi_max: int = 25
    eta: float = 0.01
    d: int = 5
    cutoff: float = 1e-10
    update_iters: int = 1
    dtype: Optional[str] = None   # None -> float32 / complex64 by encoding
    exit_early: bool = False

    # Encoding
    encoding: str = "legendre_no_norm"
    projected_basis: bool = False
    aux_basis_dim: int = 2
    encode_classes_separately: bool = False

    # Preprocessing & init
    sigmoid_transform: bool = True
    minmax: bool = True
    data_bounds: Tuple[float, float] = (0.0, 1.0)
    init_rng: int = 1234
    chi_init: int = 4

    # Loss / optimiser
    loss_grad: str = "KLD"          # "KLD" | "MSE"
    bbopt: str = "TSGO"             # "TSGO" | "GD"
    rescale: Tuple[bool, bool] = (False, True)
    train_classes_separately: bool = False

    # Truncated-split algorithm ("auto": cpu -> "gram_eigh", cuda ->
    # "randomized_warm"; see resolved_svd_alg)
    svd_alg: str = "auto"
    subspace_refresh_every: int = 1
    subspace_power_iters: int = 0
    ritz_exact_sweeps: int = 2
    ritz_rot_exact: str = "auto"
    ritz_rot_track: str = "auto"
    orth_alg: str = "auto"

    custom_encoding_range: Optional[Tuple[float, float]] = None
    pad_to: Optional[Tuple[int, int]] = None

    # Debug
    return_encoding_meta_info: bool = False

    def __post_init__(self):
        object.__setattr__(self, "encoding", canonical_encoding_name(self.encoding))
        if self.loss_grad.upper() not in ("KLD", "MSE", "MIXED"):
            raise ValueError(f"loss_grad must be 'KLD', 'MSE' or 'Mixed', "
                             f"got {self.loss_grad!r}")
        object.__setattr__(self, "loss_grad", self.loss_grad.upper())
        bb = self.bbopt.upper()
        if bb in ("GD", "CUSTOMGD"):
            bb = "GD"
        elif bb in ("TSGO", "CGD"):
            pass
        elif bb in ("OPTIM", "OPTIMKIT"):
            # mapped to the closest working optimiser, as the JAX package
            # does (mpstime_tpu/options.py:258-271)
            bb = "CGD"
        else:
            raise ValueError(f"bbopt must be 'GD', 'TSGO' or 'CGD', "
                             f"got {self.bbopt!r}")
        object.__setattr__(self, "bbopt", bb)
        if self.orth_alg not in ("auto", "qr", "ns"):
            raise ValueError(f"orth_alg must be 'auto', 'qr' or 'ns', "
                             f"got {self.orth_alg!r}")
        if self.ritz_rot_exact not in ("auto", "eigh", "eigh_r", "jacobi"):
            raise ValueError(f"ritz_rot_exact must be 'auto', 'eigh', "
                             f"'eigh_r' or 'jacobi', got "
                             f"{self.ritz_rot_exact!r}")
        if self.ritz_rot_track not in ("auto", "track", "jacobi"):
            raise ValueError(f"ritz_rot_track must be 'auto', 'track' or "
                             f"'jacobi', got {self.ritz_rot_track!r}")
        for name in ("rescale", "data_bounds", "custom_encoding_range"):
            if isinstance(getattr(self, name), list):
                object.__setattr__(self, name, tuple(getattr(self, name)))
        if self.pad_to is not None:
            pt = tuple(int(v) for v in self.pad_to)
            if len(pt) != 2:
                raise ValueError("pad_to must be (chi_cap, d_cap)")
            if pt[0] < self.chi_max or pt[1] < self.d:
                raise ValueError(
                    f"pad_to {pt} must dominate (chi_max, d) = "
                    f"({self.chi_max}, {self.d})")
            object.__setattr__(self, "pad_to", pt)

    # ---- resolution policies ---------------------------------------------
    def resolved_dtype(self) -> np.dtype:
        """Explicit option wins, else complex64 for complex encodings and
        float32 otherwise."""
        if self.dtype is not None:
            return np.dtype(self.dtype)
        if encoding_is_complex(self.encoding):
            return np.dtype(np.complex64)
        return np.dtype(np.float32)

    def real_dtype(self) -> np.dtype:
        return np.dtype(np.zeros(0, self.resolved_dtype()).real.dtype)

    def resolved_svd_alg(self, device="cuda") -> str:
        if self.svd_alg != "auto":
            return self.svd_alg
        if _device(device).type == "cpu":
            return "gram_eigh"
        if (encoding_is_complex(self.encoding)
                and self.chi_max > COMPLEX_RITZ_CHI_GATE):
            return "randomized_warm_ritz"
        return "randomized_warm"

    def resolved_orth_alg(self, device="cuda") -> str:
        """Explicit value wins; padded runs and the ritz route resolve to
        "qr" everywhere; otherwise "qr" on the CPU and the Newton-Schulz
        polar route ("ns") on the GPU (mpstime_tpu/options.py:344-386)."""
        if self.orth_alg != "auto":
            return self.orth_alg
        if self.pad_to is not None:
            return "qr"
        if self.resolved_svd_alg(device) == "randomized_warm_ritz":
            return "qr"
        return "qr" if _device(device).type == "cpu" else "ns"

    def resolved_ritz_rots(self, device="cuda") -> Tuple[str, str]:
        cpu = _device(device).type == "cpu"
        exact = (self.ritz_rot_exact if self.ritz_rot_exact != "auto"
                 else "eigh")
        track = (self.ritz_rot_track if self.ritz_rot_track != "auto"
                 else ("track" if cpu else "jacobi"))
        if exact == "jacobi":
            exact = "jacobi_warm"
        return exact, track

    def resolved_power_iters(self, device="cuda") -> int:
        if self.subspace_power_iters > 0:
            return int(self.subspace_power_iters)
        if not encoding_is_complex(self.encoding):
            return 1
        return (1 if self.resolved_svd_alg(device) == "randomized_warm_ritz"
                else 3)

    # ---- convenience ------------------------------------------------------
    def replace(self, **kwargs) -> "MPSOptions":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "MPSOptions":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, s: str) -> "MPSOptions":
        return cls.from_dict(json.loads(s))


def print_opts(opts: MPSOptions, long: bool = False, file=None) -> None:
    """Print options as a table (reference: summary.jl:438-456), the JAX
    package's ``print_opts`` layout line for line."""
    if long:
        names = [f.name for f in dataclasses.fields(opts)]
    else:
        names = ["chi_max", "d", "eta", "nsweeps", "encoding",
                 "sigmoid_transform", "loss_grad"]
    width = max(len(n) for n in names)
    print("┌" + "─" * (width + 2) + "┬" + "─" * 30 + "┐", file=file)
    for n in names:
        print(f"│ {n:<{width}} │ {getattr(opts, n)!s:<28} │", file=file)
    print("└" + "─" * (width + 2) + "┴" + "─" * 30 + "┘", file=file)

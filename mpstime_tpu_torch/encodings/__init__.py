from .registry import (EncodingSpec, get_encoding, function_basis,
                       encoding_range, stoudenmire, fourier, legendre,
                       legendre_no_norm, sahand, uniform, sahand_legendre,
                       histogram_split, uniform_split)
from .pipeline import EncodedDataset, encode_dataset, encode_series
from . import bases

__all__ = [
    "EncodingSpec", "get_encoding", "function_basis", "encoding_range",
    "EncodedDataset", "encode_dataset", "encode_series", "bases",
    "stoudenmire", "fourier", "legendre", "legendre_no_norm", "sahand",
    "uniform", "sahand_legendre", "histogram_split", "uniform_split",
]

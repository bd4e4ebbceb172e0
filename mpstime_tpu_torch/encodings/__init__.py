from .registry import EncodingSpec, get_encoding, encoding_range
from .pipeline import EncodedDataset, encode_dataset
from . import bases

__all__ = ["EncodingSpec", "get_encoding", "encoding_range",
           "EncodedDataset", "encode_dataset", "bases"]

"""mpstime_tpu_torch: the PyTorch + CUDA port of mpstime_tpu.

Time-series classification with label-indexed Matrix Product States
(MPSTime.jl's method), trained by DMRG-style two-site sweeps.  This package
keeps the JAX package's module paths, public names and array layouts; the
JAX package stays the reference each module is held against.  The training
sweep's fused bond step runs as a hand-written CUDA kernel on an NVIDIA GPU
(``fit_mps(..., device="cuda")``) and as its plain PyTorch version on the
CPU.  Importing the package imports neither JAX nor a compiler.
"""

from .options import MPSOptions
from .encodings import (EncodingSpec, get_encoding, encoding_range,
                        EncodedDataset, encode_dataset)
from .models.mps import (MPS, SingleMPS, random_mps, contract_batch,
                         contract_batch_scaled, expand_label_index)
from .training.fit import fit_mps, TrainedMPS
from .summary import classify, classify_encoded
from .utils.preprocessing import (TransformNorms, transform_data,
                                  transform_train_data, transform_test_data,
                                  invert_test_transform)

__version__ = "0.1.0"

__all__ = [
    "MPSOptions",
    "EncodingSpec", "get_encoding", "encoding_range", "EncodedDataset",
    "encode_dataset",
    "MPS", "SingleMPS", "random_mps", "contract_batch",
    "contract_batch_scaled", "expand_label_index",
    "fit_mps", "TrainedMPS", "classify", "classify_encoded",
    "TransformNorms", "transform_data", "transform_train_data",
    "transform_test_data", "invert_test_transform",
]

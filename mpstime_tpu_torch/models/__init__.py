from .mps import (MPS, SingleMPS, random_mps, contract_batch,
                  contract_batch_scaled, expand_label_index,
                  single_contract_batch)
from .itensor_import import load_mpstime_jl

__all__ = ["MPS", "SingleMPS", "random_mps", "contract_batch",
           "contract_batch_scaled", "expand_label_index",
           "single_contract_batch", "load_mpstime_jl"]

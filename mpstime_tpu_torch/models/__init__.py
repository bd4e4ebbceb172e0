from .mps import (MPS, SingleMPS, random_mps, contract_batch,
                  contract_batch_scaled, expand_label_index,
                  single_contract_batch)

__all__ = ["MPS", "SingleMPS", "random_mps", "contract_batch",
           "contract_batch_scaled", "expand_label_index",
           "single_contract_batch"]

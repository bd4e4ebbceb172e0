from .mps import (MPS, SingleMPS, random_mps, contract_batch,
                  contract_batch_scaled, expand_label_index)

__all__ = ["MPS", "SingleMPS", "random_mps", "contract_batch",
           "contract_batch_scaled", "expand_label_index"]

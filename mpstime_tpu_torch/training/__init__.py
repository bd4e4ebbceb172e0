from .fit import fit_mps, fit_mps_batch, TrainedMPS
from .sweep import full_sweeps
from .stats import loss_acc_conf

__all__ = ["fit_mps", "fit_mps_batch", "TrainedMPS", "full_sweeps",
           "loss_acc_conf"]

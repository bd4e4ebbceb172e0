from .fit import fit_mps, TrainedMPS
from .sweep import full_sweeps
from .stats import loss_acc_conf

__all__ = ["fit_mps", "TrainedMPS", "full_sweeps", "loss_acc_conf"]

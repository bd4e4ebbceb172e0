from .problem import (ImputationProblem, init_imputation_problem,
                      get_predictions, mps_impute, get_cdfs, kNN_impute,
                      impute_batch, impute_windows, sample_trajectories)
from .metrics import (mape, mse, mae, rmse, mase, compute_all_forecast_metrics)

# reference-style alias
MPS_impute = mps_impute

__all__ = [
    "ImputationProblem", "init_imputation_problem", "get_predictions",
    "mps_impute", "MPS_impute", "get_cdfs", "kNN_impute",
    "impute_batch", "impute_windows", "sample_trajectories",
    "mape", "mse", "mae", "rmse", "mase", "compute_all_forecast_metrics",
]

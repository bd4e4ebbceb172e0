"""Forecast/imputation error metrics (a copy of
``mpstime_tpu/imputation/metrics.py``; reference
src/Imputation/metrics.jl).  Host numpy."""

from __future__ import annotations

from typing import Dict

import numpy as np


def mape(forecast, actual, symmetric: bool = False) -> float:
    """(Symmetric) mean absolute percentage error (metrics.jl:2-20)."""
    forecast = np.asarray(forecast, dtype=np.float64)
    actual = np.asarray(actual, dtype=np.float64)
    num = np.abs(actual - forecast)
    den = (np.abs(actual) + np.abs(forecast)) / 2 if symmetric else np.abs(actual)
    return float(np.sum(num / den) / len(forecast))


def mse(forecast, actual) -> float:
    forecast, actual = np.asarray(forecast), np.asarray(actual)
    assert len(forecast) == len(actual), \
        "forecast/actual length mismatch"
    return float(np.mean(np.abs(forecast - actual) ** 2))


def mae(forecast, actual) -> float:
    forecast, actual = np.asarray(forecast), np.asarray(actual)
    assert len(forecast) == len(actual), \
        "forecast/actual length mismatch"
    return float(np.mean(np.abs(forecast - actual)))


def rmse(forecast, actual) -> float:
    return float(np.sqrt(mse(forecast, actual)))


def mase(train, forecast, actual, seasonal_period: int = 1) -> float:
    """Mean absolute scaled error (metrics.jl:53-75)."""
    train = np.asarray(train, dtype=np.float64)
    mae_forecast = mae(forecast, actual)
    m = seasonal_period
    if m == 1:
        mae_naive = float(np.mean(np.abs(np.diff(train))))
    else:
        mae_naive = float(np.mean(np.abs(train[m:] - train[:-m])))
    return mae_forecast / mae_naive


def compute_all_forecast_metrics(forecast, actual,
                                 print_table: bool = False) -> Dict[str, float]:
    """MAPE/SMAPE/MAE/MSE/RMSE (metrics.jl:78-103).

    Divergence from the reference: its ``:RMSE`` entry actually computes MSE
    (metrics.jl:95, a latent bug); here RMSE is the true root."""
    out = {
        "MAPE": mape(forecast, actual),
        "SMAPE": mape(forecast, actual, symmetric=True),
        "MAE": mae(forecast, actual),
        "MSE": mse(forecast, actual),
        "RMSE": rmse(forecast, actual),
    }
    if print_table:
        for k, v in out.items():
            print(f"  {k:>6}: {v:.6g}")
    return out

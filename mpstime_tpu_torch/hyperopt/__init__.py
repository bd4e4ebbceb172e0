"""Hyperparameter tuning and nested-resampling evaluation (counterpart of
``mpstime_tpu/hyperopt``)."""

from .losses import (TuningLoss, MisclassificationRate,
                     BalancedMisclassificationRate, ImputationLoss,
                     make_stratified_cvfolds, make_windows, eval_loss)
from .random_search import MPSRandomSearch, make_grid, grid_search
from .solvers import ScipySolver
from .tuning import tune
from .evaluate import evaluate

__all__ = [
    "TuningLoss", "MisclassificationRate", "BalancedMisclassificationRate",
    "ImputationLoss", "make_stratified_cvfolds", "make_windows", "eval_loss",
    "MPSRandomSearch", "ScipySolver", "make_grid", "grid_search", "tune", "evaluate",
]

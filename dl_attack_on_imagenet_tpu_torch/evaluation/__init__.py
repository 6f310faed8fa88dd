"""Evaluation harness: hyper-grids, fooling rate / RMSE / MSE / time,
budget-based selection, transfer matrices and top-1 accuracy."""

from .harness import (
    expand_grid,
    get_atks,
    get_performance,
    get_transfer_performance,
    performance,
    select_hyperparameter,
)
from .metrics import compute_fooling_rate, compute_mse, compute_rmse, model_accuracy

__all__ = [
    "compute_fooling_rate",
    "compute_mse",
    "compute_rmse",
    "expand_grid",
    "get_atks",
    "get_performance",
    "get_transfer_performance",
    "model_accuracy",
    "performance",
    "select_hyperparameter",
]

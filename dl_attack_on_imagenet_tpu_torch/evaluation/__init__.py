"""Attack-quality metrics."""

from .metrics import compute_fooling_rate, compute_mse, compute_rmse

__all__ = ["compute_fooling_rate", "compute_mse", "compute_rmse"]

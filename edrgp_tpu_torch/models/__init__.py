"""GP estimators (sklearn interface, without sklearn)."""

from .regression import GaussianProcessRegressor, SparseGaussianProcessRegressor

__all__ = ["GaussianProcessRegressor", "SparseGaussianProcessRegressor"]

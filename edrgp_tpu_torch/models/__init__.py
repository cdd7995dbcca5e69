"""GP estimators (sklearn interface, without sklearn)."""

from .regression import GaussianProcessRegressor

__all__ = ["GaussianProcessRegressor"]

"""GP estimators (sklearn interface, without sklearn)."""

from .regression import GaussianProcessRegressor, SparseGaussianProcessRegressor
from .svgp import SVGPRegressor

__all__ = ["GaussianProcessRegressor", "SparseGaussianProcessRegressor",
           "SVGPRegressor"]

"""GP estimators (sklearn interface, without sklearn)."""

from .bayesian import BayesianGaussianProcessRegressor
from .classification import (GaussianProcessClassifier,
                             SparseGaussianProcessClassifier)
from .heteroscedastic import GaussianProcessHeteroscedasticRegressor
from .regression import GaussianProcessRegressor, SparseGaussianProcessRegressor
from .svgp import SVGPRegressor

__all__ = ["GaussianProcessRegressor", "SparseGaussianProcessRegressor",
           "SVGPRegressor", "GaussianProcessClassifier",
           "SparseGaussianProcessClassifier",
           "GaussianProcessHeteroscedasticRegressor",
           "BayesianGaussianProcessRegressor"]

"""GP regression estimators (sklearn interface, no sklearn).

The port of :mod:`edrgp_tpu.models.regression`: the same constructor
arguments and defaults, plus the ``device`` the model runs on.
"""

from __future__ import annotations

from ..ops.kernels import RBF
from .base import _BaseGP
from .state import ExactGPModel, SGPRModel

__all__ = ["GaussianProcessRegressor", "SparseGaussianProcessRegressor"]


class GaussianProcessRegressor(_BaseGP):
    """Exact GP regressor (native ``GPy.models.GPRegression`` equivalent).

    Every argument is stored verbatim so ``clone`` works (the EDR layer
    depends on it).
    """

    def __init__(self, kernels=None, kernel_options=None, Y_metadata=None,
                 normalizer=True, noise_var=1.0, mean_function=None,
                 method="optimize", device=None):
        self.normalizer = normalizer
        self.noise_var = noise_var
        self.kernels = kernels
        self.kernel_options = kernel_options
        self.Y_metadata = Y_metadata
        self.mean_function = mean_function
        self.method = method
        self.device = device

    def _get_model(self, X, y, kernel):
        if kernel is None:
            kernel = RBF(X.shape[1])
        return ExactGPModel(X, y, kernel, normalizer=self.normalizer,
                            noise_var=self.noise_var,
                            mean_function=self.mean_function,
                            device=self.device)


class SparseGaussianProcessRegressor(_BaseGP):
    """Sparse (Titsias) GP regressor (native ``SparseGPRegression``
    equivalent): ``num_inducing`` inducing inputs drawn from the training
    rows unless ``Z`` is given, uncertain inputs with ``X_variance``."""

    def __init__(self, kernels=None, kernel_options=None, Z=None,
                 num_inducing=10, Y_metadata=None, X_variance=None,
                 normalizer=True, mean_function=None, method="optimize",
                 device=None):
        self.kernels = kernels
        self.kernel_options = kernel_options
        self.Z = Z
        self.num_inducing = num_inducing
        self.Y_metadata = Y_metadata
        self.X_variance = X_variance
        self.normalizer = normalizer
        self.mean_function = mean_function
        self.method = method
        self.device = device

    def _get_model(self, X, y, kernel):
        if kernel is None:
            kernel = RBF(X.shape[1])
        return SGPRModel(X, y, kernel, Z=self.Z,
                         num_inducing=self.num_inducing,
                         X_variance=self.X_variance,
                         normalizer=self.normalizer,
                         mean_function=self.mean_function,
                         device=self.device)

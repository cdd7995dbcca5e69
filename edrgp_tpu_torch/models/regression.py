"""GP regression estimator (sklearn interface, no sklearn).

The port of :class:`edrgp_tpu.models.regression.GaussianProcessRegressor`:
the same constructor arguments and defaults, plus the ``device`` the model
runs on.
"""

from __future__ import annotations

from ..ops.kernels import RBF
from .base import _BaseGP
from .state import ExactGPModel

__all__ = ["GaussianProcessRegressor"]


class GaussianProcessRegressor(_BaseGP):
    """Exact GP regressor (native ``GPy.models.GPRegression`` equivalent).

    Every argument is stored verbatim so ``clone`` works (the EDR layer
    depends on it).  ``mean_function`` is not ported yet and must be None.
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
        if self.mean_function is not None:
            raise NotImplementedError("mean_function is not ported yet")
        if kernel is None:
            kernel = RBF(X.shape[1])
        return ExactGPModel(X, y, kernel, normalizer=self.normalizer,
                            noise_var=self.noise_var, device=self.device)

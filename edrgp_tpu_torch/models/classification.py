"""GP classification estimators (sklearn interface, no sklearn).

The port of :mod:`edrgp_tpu.models.classification`: the same constructor
arguments and defaults, plus the ``device`` the model runs on.  ``predict``
maps P(class 1) > 0.5 to labels from ``classes_``; ``predict_proba``
returns the raw P(class 1).
"""

from __future__ import annotations

from ..estimator import ClassifierMixin
from ..ops.kernels import RBF
from ..ops.vgp import canonical_likelihood
from .base import _BaseGP
from .cls_state import (EPClassificationModel, SparseEPClassificationModel,
                        SparseVGPClassificationModel, VGPClassificationModel)

__all__ = ["GaussianProcessClassifier", "SparseGaussianProcessClassifier"]


def _check_inference(inference) -> None:
    if inference not in ("vi", "ep"):
        raise ValueError(f"unknown inference {inference!r}; "
                         "expected 'vi' or 'ep'")


class _BaseGPClassifier(ClassifierMixin, _BaseGP):
    def fit(self, X, y, **opt_kws):
        super().fit(X, y, **opt_kws)
        self.classes_ = self.estimator_.classes_
        return self

    def predict(self, X):
        """Labels from ``classes_`` for P(class 1) > 0.5."""
        return self.classes_[(super().predict(X) > 0.5).astype(int)]

    def predict_proba(self, X):
        """P(class 1) at each row of X."""
        return super().predict(X)


class GaussianProcessClassifier(_BaseGPClassifier):
    """Binary GP classifier (``GPy.models.GPClassification``; Bernoulli
    likelihood with probit link).

    ``inference``: ``"vi"`` (default) is the whitened variational fit;
    ``"ep"`` is damped parallel Expectation Propagation, the inference GPy
    runs."""

    def __init__(self, kernels=None, kernel_options=None, Y_metadata=None,
                 mean_function=None, method="optimize", inference="vi",
                 device=None):
        self.kernels = kernels
        self.kernel_options = kernel_options
        self.Y_metadata = Y_metadata
        self.mean_function = mean_function
        self.method = method
        self.inference = inference
        self.device = device

    def _get_model(self, X, y, kernel):
        if kernel is None:
            kernel = RBF(X.shape[1])
        _check_inference(self.inference)
        cls = (EPClassificationModel if self.inference == "ep"
               else VGPClassificationModel)
        return cls(X, y, kernel, mean_function=self.mean_function,
                   device=self.device)


class SparseGaussianProcessClassifier(_BaseGPClassifier):
    """Sparse binary GP classifier (``GPy.models.SparseGPClassification``).

    ``inference="vi"`` (default) is the whitened sparse variational fit;
    ``inference="ep"`` is EP-DTC, the inference GPy runs, probit link
    only."""

    def __init__(self, kernels=None, kernel_options=None, likelihood=None,
                 Z=None, num_inducing=10, Y_metadata=None, method="optimize",
                 inference="vi", device=None):
        self.kernels = kernels
        self.kernel_options = kernel_options
        self.likelihood = likelihood
        self.Z = Z
        self.num_inducing = num_inducing
        self.Y_metadata = Y_metadata
        self.method = method
        self.inference = inference
        self.device = device

    def _get_model(self, X, y, kernel):
        if kernel is None:
            kernel = RBF(X.shape[1])
        _check_inference(self.inference)
        if self.inference == "ep":
            if canonical_likelihood(self.likelihood) != "probit":
                raise ValueError("inference='ep' supports the probit "
                                 "(Bernoulli) likelihood only — use "
                                 "inference='vi' for the logit link")
            return SparseEPClassificationModel(
                X, y, kernel, Z=self.Z, num_inducing=self.num_inducing,
                device=self.device)
        return SparseVGPClassificationModel(
            X, y, kernel, Z=self.Z, num_inducing=self.num_inducing,
            likelihood=self.likelihood, device=self.device)

"""Estimator facade over the GP engine (sklearn interface, no sklearn).

The port of :class:`edrgp_tpu.models.base._BaseGP`: ``fit(X, y, **opt_kws)``
builds a kernel from string names and options, creates the model with
``_get_model`` and calls ``getattr(model, self.method)(**opt_kws)`` with the
reference's defaults (``messages=False, max_iters=1000``); ``predict``,
``predict_variance`` and ``predict_gradient`` return numpy arrays; ``save``
and ``load`` write and read the fitted model's pickle.
"""

from __future__ import annotations

from abc import ABCMeta, abstractmethod

import numpy as np

from ..estimator import (BaseEstimator, assert_all_finite, check_array,
                         check_classification_targets, check_is_fitted,
                         check_X_y, is_classifier)
from ..ops.kernels import Kernel, make_kernel
from .state import load_model

__all__ = ["_BaseGP"]


class _BaseGP(BaseEstimator, metaclass=ABCMeta):
    """Base class of the GP estimators.

    kernels : str, list of str, or Kernel, optional — registry names
        (default "RBF").
    kernel_options : dict or list of dict, optional — per-kernel options,
        e.g. ``{"ARD": True}``.
    method : {'optimize', 'optimize_restarts', 'optimize_sharded'} — fit
        method on the model (``optimize_sharded``: the exact GP only, with
        ``fit(X, y, mesh=...)``).
    device : torch device the model lives on (None: the card; "cpu" only
        when asked for).
    """

    def fit(self, X, y, **opt_kws):
        X, y = self._check_data(X, y)
        self.n_features_ = X.shape[1]
        kernel = self._make_kernel()
        self.estimator_ = self._get_model(X, y, kernel)
        opt_kws.setdefault("messages", False)
        opt_kws.setdefault("max_iters", 1000)
        getattr(self.estimator_, self.method)(**opt_kws)
        return self

    def _check_data(self, X, y):
        classifier = is_classifier(self)
        X, y = check_X_y(X, y, y_numeric=not classifier)
        if classifier:
            check_classification_targets(y)
        return X, y[:, np.newaxis]

    def _check_input(self, X):
        X = check_array(X)
        if X.shape[1] != self.n_features_:
            raise ValueError("X has {} features per sample; expecting {}"
                             .format(X.shape[1], self.n_features_))
        return X

    def _make_kernel(self) -> Kernel | None:
        if self.kernels is None:
            return None
        return make_kernel(self.kernels, self.kernel_options,
                           self.n_features_)

    @abstractmethod
    def _get_model(self, X, y, kernel):
        ...

    def _check_predict(self, X):
        check_is_fitted(self, "estimator_")
        return self._check_input(X)

    def predict(self, X):
        X = self._check_predict(X)
        y_pred = self.estimator_.predict(X)[0][:, 0]
        assert_all_finite(y_pred)
        return y_pred

    def predict_variance(self, X):
        X = self._check_predict(X)
        return self.estimator_.predict(X)[1]

    def predict_gradient(self, X):
        X = self._check_predict(X)
        return self.estimator_.predictive_gradients(X)[0][:, :, 0]

    def supports_sharded_gradients(self) -> bool:
        """True when the fitted model can run the data-parallel gradient
        extraction (:mod:`edrgp_tpu_torch.parallel.edr_sharded`)."""
        from ..parallel.edr_sharded import supports_sharded_gradients
        return (hasattr(self, "estimator_")
                and supports_sharded_gradients(self.estimator_))

    def predict_gradient_sharded(self, X, mesh, axis="data", chunk=None):
        """Predictive gradients with the rows split over ``mesh``'s
        dimension ``axis``, and their summed Gram: ``(grad [N, Q], gram
        [Q, Q])`` with ``gram == grad.T @ grad``, the multi-device EDR
        extraction.  Every rank of ``axis`` calls it with the same X."""
        X = self._check_predict(X)
        from ..parallel.edr_sharded import model_gradient_gram
        return model_gradient_gram(self.estimator_, X, mesh, axis=axis,
                                   chunk=chunk)

    def save(self, model_path):
        if not model_path.endswith(".pickle"):
            model_path += ".pickle"
        self.estimator_.pickle(model_path)

    def load(self, model_path):
        """Load a fitted model saved with :meth:`save` onto this
        estimator's ``device`` and return ``self``."""
        if not model_path.endswith(".pickle"):
            model_path += ".pickle"
        self.estimator_ = load_model(model_path, device=self.device)
        self.n_features_ = int(self.estimator_._X.shape[1])
        if hasattr(self.estimator_, "classes_"):
            self.classes_ = self.estimator_.classes_
        return self

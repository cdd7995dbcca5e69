"""Estimator plumbing without scikit-learn.

The JAX package's estimator and EDR layers lean on scikit-learn; the machine
with the card has no scikit-learn, so the port carries the few pieces it
uses: ``get_params``/``set_params``/``clone``, input checks (class labels
too), the classifier mixin, a standard scaler and row normalization, with
scikit-learn's semantics for the cases this package meets.
"""

from __future__ import annotations

import copy
import inspect

import numpy as np

__all__ = ["BaseEstimator", "TransformerMixin", "ClassifierMixin",
           "NotFittedError", "clone", "is_classifier", "check_array",
           "check_X_y", "check_classification_targets", "check_is_fitted",
           "assert_all_finite", "StandardScaler", "normalize_rows"]


class NotFittedError(ValueError, AttributeError):
    """Raised when an estimator is used before ``fit``."""


class BaseEstimator:
    """``get_params``/``set_params`` over the ``__init__`` arguments, which
    every subclass stores verbatim under their own names."""

    @classmethod
    def _get_param_names(cls) -> list:
        if cls.__init__ is object.__init__:
            return []
        params = inspect.signature(cls.__init__).parameters.values()
        return sorted(p.name for p in params if p.name != "self"
                      and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD))

    def get_params(self, deep: bool = True) -> dict:
        out = {}
        for name in self._get_param_names():
            value = getattr(self, name)
            if deep and hasattr(value, "get_params") \
                    and not isinstance(value, type):
                out.update((f"{name}__{k}", v)
                           for k, v in value.get_params().items())
            out[name] = value
        return out

    def set_params(self, **params):
        valid = self.get_params(deep=False)
        nested: dict = {}
        for key, value in params.items():
            name, _, sub = key.partition("__")
            if name not in valid:
                raise ValueError(f"invalid parameter {name!r} for "
                                 f"{type(self).__name__}")
            if sub:
                nested.setdefault(name, {})[sub] = value
            else:
                setattr(self, name, value)
                valid[name] = value
        for name, sub in nested.items():
            valid[name].set_params(**sub)
        return self

    def __repr__(self) -> str:
        args = ", ".join(f"{k}={v!r}"
                         for k, v in self.get_params(deep=False).items())
        return f"{type(self).__name__}({args})"


class TransformerMixin:
    def fit_transform(self, X, y=None, **fit_params):
        return self.fit(X, y, **fit_params).transform(X)


class ClassifierMixin:
    """``_estimator_type = "classifier"`` and ``score`` as accuracy."""

    _estimator_type = "classifier"

    def score(self, X, y) -> float:
        """Share of the rows of X whose predicted label is y's."""
        return float(np.mean(self.predict(X) == np.asarray(y).reshape(-1)))


def is_classifier(estimator) -> bool:
    return getattr(estimator, "_estimator_type", None) == "classifier"


def clone(estimator):
    """A new unfitted estimator with the same parameters (deep-copied
    unless they are estimators themselves, which are cloned)."""
    if isinstance(estimator, (list, tuple, set, frozenset)):
        return type(estimator)(clone(e) for e in estimator)
    if not hasattr(estimator, "get_params") or isinstance(estimator, type):
        return copy.deepcopy(estimator)
    params = estimator.get_params(deep=False)
    return type(estimator)(**{k: clone(v) for k, v in params.items()})


def assert_all_finite(X) -> None:
    if not np.all(np.isfinite(X)):
        raise ValueError("Input contains NaN or infinity.")


def check_array(X, copy: bool = False) -> np.ndarray:
    """A finite, numeric, 2-D array with at least one row."""
    X = np.array(X, copy=True) if copy else np.asarray(X)
    if X.dtype.kind not in "biuf":
        X = X.astype(np.float64)
    if X.ndim != 2:
        raise ValueError(f"Expected a 2-D array, got {X.ndim}-D input; "
                         "reshape a single feature with X.reshape(-1, 1)")
    if X.shape[0] < 1:
        raise ValueError("Found an array with 0 samples")
    assert_all_finite(X)
    return X


def check_X_y(X, y, y_numeric: bool = True):
    """(X, y) with X checked by :func:`check_array` and y a 1-D array (a
    column vector is raveled) of the same length.  With ``y_numeric`` a
    non-numeric y is cast to float64; a numeric y must be finite.  Labels
    (``y_numeric=False``) keep their type."""
    if y is None:
        raise ValueError("y must not be None")
    X = check_array(X)
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    if y.ndim != 1:
        raise ValueError(f"y must be 1-D, got shape {y.shape}")
    if y_numeric and y.dtype.kind not in "biuf":
        y = y.astype(np.float64)
    if y.dtype.kind in "biuf":
        assert_all_finite(y)
    if y.shape[0] != X.shape[0]:
        raise ValueError(f"X has {X.shape[0]} samples, y has {y.shape[0]}")
    return X, y


def check_classification_targets(y) -> None:
    """Raise unless y holds class labels: a float y with a non-integral
    value is a continuous target ("Unknown label type: 'continuous'", as
    scikit-learn words it)."""
    y = np.asarray(y)
    if y.dtype.kind == "f" and np.any(y != np.round(y)):
        raise ValueError("Unknown label type: 'continuous'. Maybe you are "
                         "trying to fit a classifier, which expects "
                         "discrete classes on a regression target with "
                         "continuous values.")


def check_is_fitted(estimator, attributes=None) -> None:
    """Raise :class:`NotFittedError` unless the named attributes (default:
    any attribute ending in ``_``) are set."""
    if attributes is None:
        fitted = any(k.endswith("_") and not k.startswith("__")
                     for k in vars(estimator))
    else:
        if isinstance(attributes, str):
            attributes = [attributes]
        fitted = all(hasattr(estimator, a) for a in attributes)
    if not fitted:
        raise NotFittedError(f"This {type(estimator).__name__} instance is "
                             "not fitted yet; call 'fit' first.")


class StandardScaler(BaseEstimator, TransformerMixin):
    """Centre and scale by the population standard deviation; a feature
    whose deviation is zero keeps scale 1."""

    def fit(self, X, y=None):
        X = check_array(X)
        self.mean_ = X.mean(axis=0)
        std = X.std(axis=0)
        self.scale_ = np.where(std == 0.0, 1.0, std)
        return self

    def transform(self, X):
        check_is_fitted(self, "scale_")
        return (check_array(X) - self.mean_) / self.scale_


def normalize_rows(X) -> np.ndarray:
    """Rows scaled to unit l2 norm; all-zero rows stay zero."""
    X = np.asarray(X, dtype=np.float64)
    norms = np.linalg.norm(X, axis=1, keepdims=True)
    return X / np.where(norms == 0.0, 1.0, norms)

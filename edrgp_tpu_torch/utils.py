"""Projector-quality linear algebra and the SVD transformer (numpy).

The port of :mod:`edrgp_tpu.utils` without scikit-learn, with three fixes
the JAX package's review asked for: an all-zero gradient matrix or Gram
raises instead of producing NaN ratios, and :func:`discrepancy` takes the
span of a rank-deficient estimate from its SVD, not from a QR that would
pad it with arbitrary directions.
"""

from __future__ import annotations

import numpy as np

from .estimator import BaseEstimator, TransformerMixin, check_array

__all__ = ["ort_space", "subspace_variance_ratio", "discrepancy",
           "SVDTransformer"]


def ort_space(A: np.ndarray) -> np.ndarray:
    """Orthonormal basis [n_features, n_features − rank(A)] of the
    orthogonal complement of span(A), for A [n_features, n_components]."""
    A = np.asarray(A)
    U, s, _ = np.linalg.svd(A, full_matrices=True)
    rank = int(np.sum(np.abs(s) > 1e-10))
    return U[:, rank:]


def subspace_variance_ratio(X: np.ndarray, V: np.ndarray):
    """Energy of X along each column of the projector V.

    A non-orthonormal V is QR-orthonormalized first.  Returns
    (‖X vᵢ‖ per column, (‖X vᵢ‖/‖X‖)² per column).
    """
    X = np.asarray(X)
    V = np.asarray(V)
    if not np.allclose(V.T @ V, np.eye(V.shape[1])):
        V = np.linalg.qr(V)[0]
    sv = np.linalg.norm(X @ V, axis=0)
    ratio = (sv / np.linalg.norm(X)) ** 2
    return sv, ratio


def _span(V: np.ndarray, rtol: float = 1e-10) -> np.ndarray:
    """Orthonormal basis of span(V): left singular vectors above the rank
    tolerance."""
    U, s, _ = np.linalg.svd(V, full_matrices=False)
    return U[:, s > rtol * max(s.max(initial=0.0), 1e-300)]


def discrepancy(B: np.ndarray, V: np.ndarray) -> float:
    """Subspace mismatch ‖B Bᵀ (I − V Vᵀ)‖_F / d for a true projector
    B [n_features, d] and an estimate V [n_features, k]; zero iff
    span(B) ⊆ span(V).  A non-orthonormal V is replaced by an orthonormal
    basis of its span."""
    B = np.asarray(B)
    V = np.asarray(V)
    if not np.allclose(V.T @ V, np.eye(V.shape[1])):
        V = _span(V)
    n = B.shape[0]
    resid = B @ B.T @ (np.eye(n) - V @ V.T)
    return float(np.linalg.norm(resid)) / B.shape[1]


def _ratio(energy: np.ndarray) -> np.ndarray:
    total = energy.sum()
    if not total > 0:
        raise ValueError("all-zero input: no direction carries energy")
    return energy / total


class SVDTransformer(BaseEstimator, TransformerMixin):
    """PCA without centering: top right-singular vectors of X.

    ``n_components`` may be None (keep all), an int, or a float in (0, 1):
    the smallest count whose cumulative variance ratio exceeds it.

    Attributes: ``components_`` (n_components, n_features),
    ``subspace_variance_`` (squared singular values) and
    ``subspace_variance_ratio_``.
    """

    def __init__(self, n_components=None):
        self.n_components = n_components

    def _n_keep(self, ratio, n_features: int) -> int:
        nc = self.n_components
        if nc is None:
            return n_features
        if isinstance(nc, (int, np.integer)):
            if not 0 < nc <= n_features:
                raise ValueError(
                    f"n_components={nc} out of range for {n_features} "
                    "features")
            return int(nc)
        if isinstance(nc, float) and 0.0 < nc < 1.0:
            return int(np.searchsorted(np.cumsum(ratio), nc) + 1)
        raise ValueError(f"invalid n_components: {nc!r}")

    def fit(self, X, y=None):
        X = check_array(X)
        _, S, Vh = np.linalg.svd(X, full_matrices=False)
        energy = S ** 2
        ratio = _ratio(energy)
        n_keep = min(X.shape[0], self._n_keep(ratio, X.shape[1]), len(S))
        self.components_ = Vh[:n_keep, :]
        self.subspace_variance_ = energy[:n_keep]
        self.subspace_variance_ratio_ = ratio[:n_keep]
        return self

    def fit_gram(self, gram, n_rows=None):
        """Fit from the [Q, Q] Gram matrix XᵀX instead of X: the same
        subspace (up to component signs)."""
        gram = check_array(gram)
        w, V = np.linalg.eigh(gram)
        energy = np.maximum(w[::-1], 0.0)           # descending, clipped
        V = V[:, ::-1]
        ratio = _ratio(energy)
        n_keep = min(self._n_keep(ratio, gram.shape[0]), gram.shape[0])
        if n_rows is not None:
            n_keep = min(n_keep, int(n_rows))
        self.components_ = V[:, :n_keep].T
        self.subspace_variance_ = energy[:n_keep]
        self.subspace_variance_ratio_ = ratio[:n_keep]
        return self

    def transform(self, X):
        return np.asarray(X) @ self.components_.T

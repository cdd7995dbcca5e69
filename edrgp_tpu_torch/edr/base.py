"""EDR meta-algorithm: single-pass, iterative and block variants (numpy).

The port of :mod:`edrgp_tpu.edr.base` without scikit-learn.  The algorithm:
fit a gradient-capable estimator, extract predictive gradients at the
training points, fit a linear DR transformer to the gradient matrix,
project, and (iteratively) repeat while composing projectors.  Estimator
and transformer are duck-typed: ``fit``/``predict_gradient`` and
``fit``/``components_``.
"""

from __future__ import annotations

import warnings
from copy import deepcopy

import numpy as np

from ..estimator import (BaseEstimator, TransformerMixin, check_array,
                         check_is_fitted, check_X_y, clone, normalize_rows)
from ..utils import subspace_variance_ratio

__all__ = ["BaseEDR", "IterativeEDR", "BlockEDR"]


class BaseEDR(BaseEstimator, TransformerMixin):
    """Single-pass effective dimensionality reduction.

    estimator : object with ``fit(X, y, **opt_kws)`` and
        ``predict_gradient(X) -> [n_samples, n_features]``.
    transformer : object with ``fit(grad)`` exposing
        ``components_ [n_components, n_features]``.
    n_components : int or None — None keeps all features.

    After fit: ``components_`` (the learned projector), ``estimator_``,
    ``transformer_``, ``first_estimator_``, ``subspace_variance_`` and
    ``subspace_variance_ratio_``, and ``_first_gradients_``, the expensive
    artifact :meth:`refit` reuses.
    """

    def __init__(self, estimator=None, transformer=None, n_components=None):
        self.estimator = estimator
        self.transformer = transformer
        self.n_components = n_components

    # ------------------------------------------------------------------ fit
    def fit(self, X, y=None, **opt_kws):
        self._check_init(X.shape[1])
        self.components_ = None
        self.num_iter = 0
        self._fit_estimator(X, y, **opt_kws)
        self._fit_transformer(X)
        X_proj = self.transform(X)
        self.num_iter += 1
        self._last_fit(X_proj, y, **opt_kws)
        return self

    def _check_init(self, n_features):
        if self.estimator is None:
            raise ValueError("estimator should be specified")
        if self.transformer is None:
            raise ValueError("transformer should be specified")
        self.n_components_ = (n_features if self.n_components is None
                              else self.n_components)

    def _fit_estimator(self, X, y, **opt_kws):
        X, y = check_X_y(X, y, y_numeric=False)
        self.estimator_ = clone(self.estimator)
        self.estimator_.fit(X, y, **opt_kws)
        if self.num_iter == 0:
            self.first_estimator_ = clone(self.estimator_)
        return self

    def _fit_transformer(self, X):
        check_is_fitted(self, "estimator_")
        grad = self._get_estimator_gradients(X)
        if self.num_iter == 0:
            self._first_gradients_ = grad
        self.transformer_ = clone(self.transformer)
        self._fit_dr(self.transformer_, grad)
        self._check_transformer(self.transformer_)
        comps = deepcopy(self.transformer_.components_)[:self.n_components_, :]
        # New axes are expressed in the current (projected) space.
        self.components_ = (comps if self.components_ is None
                            else comps @ self.components_)
        return self

    def _fit_dr(self, transformer, grad):
        """Fit the cloned DR transformer on the gradient matrix.
        ``EffectiveDimensionalityReduction`` overrides it to feed the
        distributed Gram instead, when one was summed."""
        transformer.fit(grad)
        return transformer

    def _last_fit(self, X, y, **opt_kws):
        """Refit in the reduced subspace; record gradient/variance summaries."""
        self._fit_estimator(X, y, **opt_kws)
        self.subspace_gradients_ = self._get_estimator_gradients(X)
        self._recovered_gradients_ = self.subspace_gradients_ @ self.components_
        (self.subspace_variance_,
         self.subspace_variance_ratio_) = subspace_variance_ratio(
            self._first_gradients_, self.components_.T)
        return self

    # ---------------------------------------------------------------- refit
    def refit(self, refit_transformer, index=None):
        """Re-extract a projector from the cached first-fit gradients, with
        no GP re-fit."""
        check_is_fitted(self, "components_")
        if index is None:
            index = slice(None)
        self.refit_transformer_ = clone(refit_transformer)
        self.refit_transformer_.fit(self._first_gradients_[index, :])
        self._check_transformer(self.refit_transformer_)
        comps = normalize_rows(self.refit_transformer_.components_)
        self.refit_components_ = self._remove_zero_components(comps)
        (self.refit_subspace_variance_,
         self.refit_subspace_variance_ratio_) = subspace_variance_ratio(
            self._first_gradients_[index, :], self.refit_components_.T)
        return self

    def _remove_zero_components(self, components):
        dead = np.where(np.linalg.norm(components, axis=1) == 0)[0]
        if dead.size:
            warnings.warn(
                "Components with numbers {} will be dropped because they "
                "contain only zeros".format(dead.tolist()), RuntimeWarning)
            components = np.delete(components, dead, axis=0)
        return components

    # ------------------------------------------------------------ gradients
    def get_estimator_gradients(self, X):
        """Predictive gradients [n_samples, n_features] at X."""
        return self._get_estimator_gradients(check_array(X))

    def _get_estimator_gradients(self, X):
        check_is_fitted(self, "estimator_")
        return self.estimator_.predict_gradient(X)

    # ------------------------------------------------------------ transform
    def transform(self, X, refitted=False):
        check_is_fitted(self, "components_")
        X = check_array(X)
        if refitted:
            check_is_fitted(self, ["refit_transformer_", "refit_components_"])
            return X @ self.refit_components_.T
        return X @ self.components_.T

    def inverse_transform(self, X):
        check_is_fitted(self, "components_")
        return check_array(X) @ np.linalg.pinv(self.components_).T

    @property
    def feature_importances_(self):
        check_is_fitted(self, "components_")
        return self.components_

    @staticmethod
    def _check_transformer(transformer):
        if not hasattr(transformer, "components_"):
            raise AttributeError(
                'The transformer does not expose "components_" attribute')


class IterativeEDR(BaseEDR):
    """EDR with iterative component dropping.

    ``step``: None — a single iteration; int > 0 — drop ``step`` worst
    components per iteration until ``n_components`` remain; float in
    (0, 1) — per iteration keep the fewest components whose cumulative
    variance ratio reaches ``step`` (``n_components`` must then be None).
    """

    def __init__(self, estimator=None, transformer=None, n_components=None,
                 step=None):
        super().__init__(estimator, transformer, n_components)
        self.step = step

    def fit(self, X, y=None, **opt_kws):
        n_features = X.shape[1]
        self._check_init(n_features)
        self._check_step(n_features)
        self.components_ = None
        self.continue_iteration = True
        self.num_iter = 0
        X_proj = np.array(X, copy=True)
        while self.continue_iteration:
            self._fit_estimator(X_proj, y, **opt_kws)
            self._fit_transformer(X_proj)
            X_proj = self.transform(X)
            self.num_iter += 1
        self._last_fit(X_proj, y, **opt_kws)
        return self

    def _check_step(self, n_features):
        self.adaptive_step = False
        if self.step is None:
            self.step_ = self.n_components_
        elif isinstance(self.step, (int, np.integer)) and self.step > 0:
            if self.n_components_ == n_features:
                raise ValueError(
                    "If step is int (n_components < n_features) must be True")
            self.step_ = int(self.step)
        elif isinstance(self.step, float) and 0 < self.step < 1:
            if self.n_components is not None:
                raise ValueError("If step is float n_components should be None")
            self.adaptive_step = True
            self.step_ = self.step
        else:
            raise ValueError("Step should be None or int > 0 or float from 0 to 1")

    def _fit_transformer(self, X):
        check_is_fitted(self, "estimator_")
        grad = self._get_estimator_gradients(X)
        if self.num_iter == 0:
            self._first_gradients_ = grad
        self.transformer_ = clone(self.transformer)
        self._fit_dr(self.transformer_, grad)
        self._check_transformer(self.transformer_)
        comps = deepcopy(self.transformer_.components_)
        n_keep = self._select_n_components(grad, comps)
        self.components_ = self._select_best_components(comps, n_keep)
        return self

    def _select_n_components(self, grad, components):
        if self.adaptive_step:
            _, ratio = subspace_variance_ratio(grad, components.T)
            n_keep = int(np.sum(np.cumsum(ratio) < self.step_)) + 1
            if n_keep == grad.shape[1]:
                self.continue_iteration = False
        else:
            n_keep = max(self.n_components_, grad.shape[1] - self.step_)
            if n_keep == self.n_components_:
                self.continue_iteration = False
        return n_keep

    def _select_best_components(self, components, n_keep):
        # Compose into the original feature space, then keep the n_keep
        # composed axes that capture most first-iteration gradient energy.
        self.components_ = (components if self.components_ is None
                            else components @ self.components_)
        _, ratio = subspace_variance_ratio(self._first_gradients_,
                                           self.components_.T)
        best = np.argsort(ratio)[-n_keep:][::-1]
        return self.components_[best, :]


class _BlockFitMixin:
    """Block-diagonal projector fitting shared by :class:`BlockEDR` and the
    block mode of ``EffectiveDimensionalityReduction``."""

    def _fit_transformer_blocks(self, X):
        check_is_fitted(self, "estimator_")
        grad = self._get_estimator_gradients(X)
        if self.num_iter == 0:
            self._first_gradients_ = grad
        # Blocks index GRADIENT columns, so they always refer to input
        # features, preprocessing or not.
        self._make_blocks(grad.shape[1])
        per_block = [
            self._fit_single_block(clone(self.transformer), grad, block)
            for block in self.blocks_
        ]
        self.components_ = self._merge_components(per_block)
        # Block mode is single-pass: no component-dropping iteration.
        self.continue_iteration = False
        return self

    def _fit_single_block(self, transformer, grads, block, index=None,
                          params=None):
        """Fit one transformer on grads[:, block] → [len(block), k]."""
        columns = np.asarray(block["columns"])
        if index is None:
            index = np.ones(grads.shape[0], dtype=bool)
        sub = grads[np.ix_(np.arange(grads.shape[0])[index], columns)]
        transformer.set_params(n_components=block["n_components"])
        if params is not None:
            transformer.set_params(**params)
        transformer.fit(sub)
        self._check_transformer(transformer)
        return transformer.components_.T

    def _merge_components(self, per_block):
        """Assemble the per-block projectors into one block-diagonal
        [total_components, n_features] matrix; remaps ``blocks_`` to the
        projected columns."""
        n_features = self._first_gradients_.shape[1]
        total = sum(c.shape[1] for c in per_block)
        merged = np.zeros((n_features, total))
        start = 0
        for i, comp in enumerate(per_block):
            stop = start + comp.shape[1]
            merged[np.asarray(self.blocks_[i]["columns"]), start:stop] = comp
            self.blocks_[i]["columns"] = np.arange(start, stop)
            start = stop
        return merged.T

    def refit_blocks(self, refit_transformer, index=None, params=None):
        n_features = self._first_gradients_.shape[1]
        self._make_blocks(n_features)
        self.refit_transformer_ = clone(refit_transformer)
        if index is None:
            self.refit_index_ = np.ones(self._first_gradients_.shape[0],
                                        dtype=bool)
        else:
            self.refit_index_ = index
        per_block = [
            self._fit_single_block(
                clone(refit_transformer), self._first_gradients_, block,
                index=self.refit_index_,
                params=None if params is None else params[i])
            for i, block in enumerate(self.blocks_)
        ]
        self.refit_components_ = self._remove_zero_components(
            normalize_rows(self._merge_components(per_block)))
        (self.refit_subspace_variance_,
         self.refit_subspace_variance_ratio_) = subspace_variance_ratio(
            self._first_gradients_[self.refit_index_, :],
            self.refit_components_.T)
        return self

    def _make_blocks(self, n_features):
        if self.blocks is None:
            if isinstance(self.n_components_, (int, np.integer)):
                self.blocks_ = [{"columns": np.arange(n_features),
                                 "n_components": int(self.n_components_)}]
            else:
                raise ValueError(
                    "blocks should be specified if n_components is list")
        elif isinstance(self.blocks, list):
            if isinstance(self.n_components_, list):
                self.blocks_ = [
                    {"columns": np.asarray(list(block)), "n_components": k}
                    for block, k in zip(self.blocks, self.n_components_)
                ]
            elif isinstance(self.n_components_, (int, np.integer)):
                # min(): a block cannot give more components than columns.
                self.blocks_ = [
                    {"columns": np.asarray(list(block)),
                     "n_components": min(int(self.n_components_),
                                         len(list(block)))}
                    for block in self.blocks
                ]
        return self


class BlockEDR(_BlockFitMixin, BaseEDR):
    """EDR with a block-diagonal projector over user-specified column blocks.

    ``blocks`` is a list of column-index lists; a transformer clone is fitted
    per block on the corresponding gradient sub-matrix and the per-block
    projectors are assembled block-diagonally.  ``n_components`` may be an
    int (shared) or a per-block list.
    """

    def __init__(self, estimator, transformer, n_components=None, blocks=None):
        super().__init__(estimator, transformer, n_components)
        self.blocks = blocks

    def _fit_transformer(self, X):
        return self._fit_transformer_blocks(X)

    def refit(self, refit_transformer, index=None, params=None):
        return self.refit_blocks(refit_transformer, index, params)

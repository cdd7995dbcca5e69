"""User-facing EDR class with normalization and linear preprocessing.

The port of :class:`edrgp_tpu.edr.edr.EffectiveDimensionalityReduction`
without scikit-learn.
"""

from __future__ import annotations

import numpy as np

from ..estimator import StandardScaler, check_array, check_is_fitted, clone
from .base import IterativeEDR, _BlockFitMixin

__all__ = ["EffectiveDimensionalityReduction"]


class EffectiveDimensionalityReduction(_BlockFitMixin, IterativeEDR):
    """Effective dimensionality reduction with preprocessing.

    estimator : gradient-capable supervised estimator.
    dr_transformer : linear DR method exposing ``components_``.
    n_components, step : see :class:`IterativeEDR`.
    normalize : bool (default True) — standardize the inputs before
        fitting; the learned components are mapped back through the inverse
        scaling so ``transform`` stays a pure linear map on raw features.
    preprocessor : optional linear preprocessor exposing ``components_``,
        applied after normalization; requires ``normalize=True``.
    blocks : optional list of feature-index lists — fit one transformer
        clone per block of gradient columns and assemble a block-diagonal
        projector.  ``n_components`` as a list with ``blocks=None`` splits
        the features into that many contiguous near-equal blocks.  Block
        mode is single-pass (``step`` must be None).
    gradient_mesh : optional ``torch.distributed`` device mesh (see
        :mod:`edrgp_tpu_torch.parallel.mesh`) — run the fit-time gradient
        extraction data-parallel over its ``"data"`` dimension and feed a
        Gram-capable DR transformer the summed [Q, Q] Gram instead of the
        [N, Q] gradients (:mod:`edrgp_tpu_torch.parallel.edr_sharded`).
        Every rank fits the same EDR.  Estimators whose fitted model has
        no sharded gradient basis take the single-device path.
    """

    def __init__(self, estimator=None, dr_transformer=None, n_components=None,
                 step=None, normalize=True, preprocessor=None, blocks=None,
                 gradient_mesh=None):
        self.normalize = normalize
        self.preprocessor = preprocessor
        self.blocks = blocks
        self.gradient_mesh = gradient_mesh
        super().__init__(estimator, dr_transformer, n_components, step)

    @property
    def _block_mode(self):
        return (self.blocks is not None
                or isinstance(self.n_components, (list, tuple)))

    def _fit_transformer(self, X):
        if self._block_mode:
            return self._fit_transformer_blocks(X)
        return super()._fit_transformer(X)

    def _make_blocks(self, n_features):
        if self.blocks is None and isinstance(self.n_components_,
                                              (list, tuple)):
            cols = np.array_split(np.arange(n_features),
                                  len(self.n_components_))
            self.blocks_ = [{"columns": c, "n_components": int(k)}
                            for c, k in zip(cols, self.n_components_)]
            return self
        return super()._make_blocks(n_features)

    def _check_step(self, n_features):
        if self._block_mode:
            if self.step is not None:
                raise ValueError("block mode is single-pass: step must be "
                                 "None when blocks/per-block n_components "
                                 "are given")
            self.adaptive_step = False
            self.step_ = None
            return
        super()._check_step(n_features)

    # ``transformer`` is named ``dr_transformer`` in this class's public API.
    @property
    def dr_transformer(self):
        return self.transformer

    @dr_transformer.setter
    def dr_transformer(self, value):
        self.transformer = value

    @property
    def dr_transformer_(self):
        """The fitted DR transformer (alias of ``transformer_``)."""
        return self.transformer_

    # ------------------------------------------------------------------ fit
    def fit(self, X, y=None, **opt_kws):
        self.fitted = False
        X = self._preprocessing_fit(X)
        super().fit(X, y, **opt_kws)
        if self.normalize:
            # Fold the scaling into the projector: components act on raw X.
            self.components_ = self.components_ @ self._reverse_scaling_
        self.fitted = True
        return self

    def refit(self, refit_transformer, rows=None):
        super().refit(refit_transformer, rows)
        if self.normalize:
            self.refit_components_ = (self.refit_components_
                                      @ self._reverse_scaling_)
        return self

    # -------------------------------------------------------- preprocessing
    def _preprocessing_fit(self, X):
        if not self.normalize:
            if self.preprocessor is not None:
                raise ValueError(
                    "To apply preprocessing, normalize should be True")
            return X
        self.scaler_ = StandardScaler()
        X_pre = self.scaler_.fit_transform(X)
        self._scaling_ = np.diag(self.scaler_.scale_)
        self._reverse_scaling_ = np.diag(1.0 / self.scaler_.scale_)
        # X is centred for training (robustness for the GP); transform stays
        # a pure linear map without the translation.
        if self.preprocessor is not None:
            self.preprocessor_ = clone(self.preprocessor)
            X_pre = self.preprocessor_.fit_transform(X_pre)
            self._check_transformer(self.preprocessor_)
            self._preprocessing_ = self.preprocessor_.components_
        return X_pre

    def _preprocessing_transform(self, X):
        """Raw X → the reduced coordinates the final estimator was fit on."""
        X = check_array(X)
        if self.normalize is True:
            check_is_fitted(self, "scaler_")
            X = self.scaler_.transform(X) @ self._scaling_
        return X @ self.components_.T

    # ------------------------------------------------------------ gradients
    def get_estimator_gradients(self, X):
        return self._get_estimator_gradients(check_array(X), True)

    def _get_estimator_gradients(self, X, preprocessing_transform=False):
        """Gradients mapped back to the (preprocessed) input space: the
        first-iteration gradients pass through the preprocessor, so the
        cached ``_first_gradients_`` live in normalized-feature space.

        With ``gradient_mesh``, fit-time extraction runs the sharded path
        and its summed Gram is staged for the DR transformer (see
        :meth:`_fit_dr`), mapped through the preprocessor with the
        gradients (grad' = G·P, so gram' = Pᵀ·gram·P)."""
        if preprocessing_transform:
            X = self._preprocessing_transform(X)
        check_is_fitted(self, "estimator_")
        gram = None
        if (self.gradient_mesh is not None and not preprocessing_transform
                and getattr(self.estimator_, "supports_sharded_gradients",
                            lambda: False)()):
            grad, gram = self.estimator_.predict_gradient_sharded(
                X, self.gradient_mesh)
        else:
            grad = self.estimator_.predict_gradient(X)
        if (self.preprocessor is not None and self.num_iter == 0
                and not preprocessing_transform):
            check_is_fitted(self, "preprocessor_")
            grad = grad @ self._preprocessing_
            if gram is not None:
                gram = self._preprocessing_.T @ gram @ self._preprocessing_
        if preprocessing_transform:
            grad = grad @ self.components_
        if gram is not None:
            self._pending_gram_ = gram
            self._pending_gram_key_ = grad
        return grad

    def _fit_dr(self, transformer, grad):
        """Feed the distributed Gram to a Gram-capable transformer when
        the gradient matrix being fitted is the one the sharded path just
        extracted: ``fit_gram`` takes the [Q, Q] sum (the same subspace as
        ``fit(grad)``).  Any other transformer or gradient matrix takes the
        plain ``fit``."""
        gram = getattr(self, "_pending_gram_", None)
        if (gram is not None
                and grad is getattr(self, "_pending_gram_key_", None)
                and hasattr(transformer, "fit_gram")):
            transformer.fit_gram(gram, n_rows=grad.shape[0])
            return transformer
        return super()._fit_dr(transformer, grad)

    @property
    def feature_importances_(self):
        """Components expressed w.r.t. the scaled features."""
        check_is_fitted(self, "components_")
        importances = self.components_
        if self.normalize is True:
            importances = importances @ self._scaling_
        return importances

    # ------------------------------------------------------------ transform
    def transform(self, X, refitted=False):
        check_is_fitted(self, "components_")
        X = check_array(X)
        if refitted:
            check_is_fitted(self, ["refit_transformer_", "refit_components_"])
            return X @ self.refit_components_.T
        if self.fitted:
            components = self.components_
        else:
            # Mid-fit: X arrives normalized and preprocessed, while the
            # components accumulate in preprocessed space.
            components = (self.components_ if self.preprocessor is None
                          else self.components_ @ self._preprocessing_.T)
        return X @ components.T

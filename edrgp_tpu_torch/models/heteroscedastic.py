"""Heteroscedastic GP regression: learnable noise variances per group.

The port of :mod:`edrgp_tpu.models.heteroscedastic`.  The likelihood is
N(yᵢ | fᵢ, σ²_{g(i)}), where the grouping g follows GPy's ``Y_metadata``
contract: ``Y_metadata={"output_index": idx}`` ties the noise variances
within each group (one learnable σ² per unique index); without metadata
every observation has its own σᵢ².  All σ² are fitted jointly with the
kernel by ML-II.  Predictions at new points are the *latent* mean and
variance (a new point has no observation-noise estimate).

The NLML builds K(X, X) + diag(σ²) through
:func:`~edrgp_tpu_torch.ops.exact.noisy_K`: for a plain RBF in float32 on
the card that is kernel K forward and kernel A backward, with the per-row
noise's gradient read off the cotangent's diagonal.  ``predict`` takes
K(X, X*) through kernel K and dμ/dx* goes through kernel G (C = X, w = α).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..config import default_dtype, resolve_device
from ..ops import exact as _exact
from ..ops.kernels import RBF, Kernel, positive
from ..ops.linalg import cho_solve, logdet_and_quad, safe_cholesky
from . import state as _state
from .base import _BaseGP
from .state import Normalizer, _BaseModel

__all__ = ["HeteroscedasticGPModel", "GaussianProcessHeteroscedasticRegressor",
           "het_nlml"]

_LOG2PI = math.log(2.0 * math.pi)


def het_nlml(gp, X, y, idx) -> torch.Tensor:
    """NLML with per-group noise: σ²ᵢ = positive(raw_noise)[idx[i]]."""
    noise = positive(gp.raw_noise)[idx]
    logdet, quad = logdet_and_quad(_exact.noisy_K(gp.kernel, X, noise), y)
    return 0.5 * (X.shape[0] * _LOG2PI + logdet + quad)


@torch.no_grad()
def het_posterior(gp, X, y, idx):
    """(L, α): L = chol(K + diag(σ²)), α = (K + diag(σ²))⁻¹ y."""
    noise = positive(gp.raw_noise)[idx]
    L = safe_cholesky(_exact.noisy_K(gp.kernel, X, noise))
    return L, cho_solve(L, y[:, None])[:, 0]


class HeteroscedasticGPModel(_BaseModel):
    """GPy-like surface over the per-group-noise exact GP."""

    def __init__(self, X, y, kernel: Kernel, Y_metadata=None,
                 normalizer: bool = True, noise_var: float = 1.0,
                 dtype: torch.dtype | None = None, device=None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        y = np.asarray(y).reshape(-1)
        n = np.shape(X)[0]
        if Y_metadata is not None and "output_index" in Y_metadata:
            raw_idx = np.asarray(Y_metadata["output_index"]).reshape(-1)
            if raw_idx.shape[0] != n:
                raise ValueError(
                    f"Y_metadata['output_index'] has {raw_idx.shape[0]} "
                    f"entries for {n} observations")
            groups, idx = np.unique(raw_idx, return_inverse=True)
        else:
            groups, idx = np.arange(n), np.arange(n)
        self.Y_metadata = Y_metadata
        self.normalizer = Normalizer(y, enabled=bool(normalizer))
        self._setup(X, self.normalizer.normalize(y), kernel, noise_var,
                    dtype, device)
        self.raw_noise = nn.Parameter(
            self.raw_noise.detach().expand(len(groups)).clone())
        self._set_groups(groups, idx)

    def _set_groups(self, groups, idx) -> None:
        self.groups_ = np.asarray(groups)
        self._idx = torch.as_tensor(np.asarray(idx).reshape(-1),
                                    dtype=torch.long, device=self._X.device)

    def _objective_fn(self):
        return lambda: het_nlml(self, self._X, self._y, self._idx)

    def optimize_restarts(self, num_restarts: int = 1, **kw):
        """One fit: perturbing one noise per point helps no restart."""
        return self.optimize(**kw)

    def _posterior(self):
        if self._cache is None:
            self._cache = het_posterior(self, self._X, self._y, self._idx)
        return self._cache

    def log_likelihood(self) -> float:
        with torch.no_grad():
            return -float(het_nlml(self, self._X, self._y, self._idx))

    @property
    def group_noise_variances_(self) -> np.ndarray:
        """Learned noise per ``Y_metadata`` group (original y scale),
        ordered like ``groups_``."""
        return (positive(self.raw_noise.detach()).cpu().numpy()
                * self.normalizer.std ** 2)

    @property
    def noise_variances_(self) -> np.ndarray:
        """Per-point learned noise in the original y scale."""
        return self.group_noise_variances_[self._idx.cpu().numpy()]

    @property
    def noise_variance(self) -> float:
        return float(positive(self.raw_noise.detach()).mean())

    def predict(self, Xnew, include_likelihood: bool = False):
        """Latent posterior mean/var at Xnew; ``include_likelihood=True``
        adds the *mean* learned noise as a crude predictive band."""
        return super().predict(Xnew, include_likelihood)

    def _moments(self, Xnew, include_likelihood):
        mean, var = _exact.predict(self, self._X, self._posterior(), Xnew,
                                   include_likelihood=False)
        if include_likelihood:
            var = var + positive(self.raw_noise.detach()).mean()
        return mean, var

    def _gradients(self, Xnew, batch):
        if batch is None:
            batch = _exact.grad_batch_size(Xnew.shape[0], self._X.shape[0])
        dmu = _exact.grad_rows(self.kernel, self._X, self._posterior()[1],
                               Xnew, batch)
        return dmu, torch.zeros_like(dmu)

    def _pickle_state(self) -> dict:
        state = super()._pickle_state()
        state["idx"] = self._idx.cpu().numpy()
        state["groups"] = self.groups_
        state["Y_metadata"] = self.Y_metadata
        return state

    def _restore(self, state: dict) -> None:
        self._restore_parameters(state, ("raw_noise",))
        self.Y_metadata = state.get("Y_metadata")
        self._set_groups(state["groups"], state["idx"])


_state._MODEL_CLASSES["HeteroscedasticGPModel"] = HeteroscedasticGPModel


class GaussianProcessHeteroscedasticRegressor(_BaseGP):
    """Estimator over :class:`HeteroscedasticGPModel` (GPy's
    ``GPHeteroscedasticRegression``)."""

    _estimator_type = "regressor"

    def __init__(self, kernels=None, kernel_options=None, Y_metadata=None,
                 normalizer=True, noise_var=1.0, method="optimize",
                 device=None):
        self.kernels = kernels
        self.kernel_options = kernel_options
        self.Y_metadata = Y_metadata
        self.normalizer = normalizer
        self.noise_var = noise_var
        self.method = method
        self.device = device

    def _get_model(self, X, y, kernel):
        if kernel is None:
            kernel = RBF(X.shape[1])
        return HeteroscedasticGPModel(X, y, kernel,
                                      Y_metadata=self.Y_metadata,
                                      normalizer=self.normalizer,
                                      noise_var=self.noise_var,
                                      device=self.device)

"""Fitted binary classification models with a GPy-compatible surface.

The port of :mod:`edrgp_tpu.models.cls_state`.  ``predict`` returns the
class-1 probability and the latent variance (GPy Bernoulli semantics),
``predictive_gradients`` the gradient of the *latent* posterior mean,
``log_likelihood`` the variational bound or log Z_EP.  Labels map to ±1
with ``classes_[1]`` positive; anything but two classes raises.

Each model's latent mean is a weighted kernel sum k(x*, C)·w, with w formed
once per fitted state:

=============================  =====  ==============
model                          C      w
=============================  =====  ==============
VGPClassificationModel         X      L_K⁻ᵀm
SparseVGPClassificationModel   Z      L_uu⁻ᵀm
EPClassificationModel          X      α
SparseEPClassificationModel    Z      L_m⁻ᵀ·u_mean
=============================  =====  ==============

so dμ/dx* goes through :func:`~edrgp_tpu_torch.ops.exact.grad_rows`, which
is kernel G on the card for a plain RBF.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import default_dtype, resolve_device
from ..ops import ep as _ep
from ..ops import ep_dtc as _ep_dtc
from ..ops import vgp as _vgp
from ..ops.exact import grad_batch_size, grad_rows
from ..ops.kernels import Kernel
from . import state as _state
from .state import _BaseModel

__all__ = ["VGPClassificationModel", "SparseVGPClassificationModel",
           "EPClassificationModel", "SparseEPClassificationModel"]


def _inducing_init(X, Z, num_inducing: int, seed: int):
    """Z as given, else ``num_inducing`` training rows drawn by the JAX
    package's seeded permutation."""
    if Z is None:
        rng = np.random.default_rng(seed)
        m = min(int(num_inducing), X.shape[0])
        Z = np.asarray(X)[rng.permutation(X.shape[0])[:m]]
    return np.asarray(Z)


class _BaseClsModel(_BaseModel):
    """Shared classification surface."""

    _lik = "probit"  # Bernoulli link; GPy's default

    def _setup_cls(self, X, y, kernel: Kernel, mean_function, dtype,
                   device) -> None:
        """Kernel and ±1 labels on ``device``; no noise parameter."""
        y = np.asarray(y).reshape(-1)
        classes = np.unique(y)
        if classes.size != 2:
            raise ValueError(
                f"binary classification requires 2 classes, got {classes}")
        self.classes_ = classes
        self.normalizer = None
        self._set_mean_function(mean_function)
        self._setup(X, np.where(y == classes[1], 1.0, -1.0), kernel, None,
                    dtype, device)

    def _variational(self, n: int) -> None:
        m, tril = _vgp.init_variational_params(n, self._X.dtype,
                                               self._X.device)
        self.m = nn.Parameter(m)
        self.tril = nn.Parameter(tril)

    def _latent(self, Xnew):
        """Latent (mean [S], var [S]) at Xnew."""
        raise NotImplementedError

    def _mean_basis(self):
        """(C, w): the latent mean at x* is k(x*, C)·w."""
        raise NotImplementedError

    def log_likelihood(self) -> float:
        with torch.no_grad():
            return -float(self._objective_fn()())

    def predict(self, Xnew, include_likelihood: bool = True):
        """(P(y=1|x*) [S, 1], latent var [S, 1]) — GPy Bernoulli predict."""
        mean, var = self._latent(self._as_input(Xnew))
        proba = _vgp.bernoulli_predict_proba(mean, var, self._lik)
        return proba.cpu().numpy()[:, None], var.cpu().numpy()[:, None]

    def predictive_gradients(self, Xnew, batch: int | None = None):
        """(dμ/dx* [S, Q, 1] of the latent mean, zeros [S, Q])."""
        Xnew = self._as_input(Xnew)
        C, w = self._mean_basis()
        if batch is None:
            batch = grad_batch_size(Xnew.shape[0], C.shape[0])
        dmu = grad_rows(self.kernel, C.detach(), w, Xnew, batch)
        dmu = dmu.cpu().numpy()
        return dmu[:, :, None], np.zeros_like(dmu)

    @property
    def noise_variance(self) -> float:  # no Gaussian likelihood here
        return 0.0

    def _pickle_state(self) -> dict:
        state = super()._pickle_state()
        state["lik"] = self._lik
        state["classes"] = self.classes_
        return state

    def _restore(self, state: dict) -> None:
        self._restore_parameters(state, ("Z", "m", "tril"))
        self.classes_ = np.asarray(state["classes"])
        self._lik = state["lik"]


class VGPClassificationModel(_BaseClsModel):
    """Full (non-sparse) variational GP binary classifier.  Its variational
    state holds N(N+1)/2 parameters."""

    def __init__(self, X: np.ndarray, y: np.ndarray, kernel: Kernel,
                 mean_function=None, dtype: torch.dtype | None = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self._setup_cls(X, y, kernel, mean_function,
                        dtype or default_dtype(device), device)
        self._variational(self._X.shape[0])

    def _objective_fn(self):
        return lambda: -_vgp.vgp_elbo(self, self._X, self._y, self._lik)

    def _latent(self, Xnew):
        return _vgp.vgp_predict_latent(self, self._X, Xnew)

    def _mean_basis(self):
        if self._cache is None:
            self._cache = _vgp.mean_weights(self, self._X)
        return self._X, self._cache


class SparseVGPClassificationModel(_BaseClsModel):
    """Sparse (inducing-point) variational GP binary classifier.

    ``likelihood``: None/'bernoulli'/'probit' is the Bernoulli-probit
    default; 'bernoulli_logit'/'logit' swaps the link."""

    def __init__(self, X: np.ndarray, y: np.ndarray, kernel: Kernel,
                 Z: np.ndarray | None = None, num_inducing: int = 10,
                 likelihood=None, mean_function=None,
                 dtype: torch.dtype | None = None, seed: int = 0,
                 device=None):
        super().__init__()
        self._lik = _vgp.canonical_likelihood(likelihood)
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        self._setup_cls(X, y, kernel, mean_function, dtype, device)
        self.Z = nn.Parameter(torch.tensor(       # a copy, see SGPRModel
            _inducing_init(X, Z, num_inducing, seed), dtype=dtype,
            device=device))
        self._variational(self.Z.shape[0])

    def _objective_fn(self):
        return lambda: -_vgp.svgp_cls_elbo(self, self._X, self._y, self._lik)

    def _latent(self, Xnew):
        return _vgp.svgp_cls_predict_latent(self, Xnew)

    def _mean_basis(self):
        if self._cache is None:
            self._cache = _vgp.mean_weights(self, self.Z)
        return self.Z, self._cache


class EPClassificationModel(_BaseClsModel):
    """Binary GP classifier fitted by Expectation Propagation, the inference
    GPy's ``GPClassification`` runs (damped parallel form,
    :mod:`edrgp_tpu_torch.ops.ep`).  ``log_likelihood`` reports log Z_EP."""

    def __init__(self, X: np.ndarray, y: np.ndarray, kernel: Kernel,
                 mean_function=None, dtype: torch.dtype | None = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self._setup_cls(X, y, kernel, mean_function,
                        dtype or default_dtype(device), device)

    def _objective_fn(self):
        return _ep.ep_neg_energy_objective(self, self._X, self._y)

    def _ep(self):
        """Lazy (sites, prediction cache); reset on every optimize()."""
        if self._cache is None:
            state = _ep.ep_fit(self, self._X, self._y)
            cache = _ep.ep_posterior_cache(self, self._X, state.nu,
                                           state.tau)
            self._cache = (state, cache)
        return self._cache

    def log_likelihood(self) -> float:
        state, _ = self._ep()
        with torch.no_grad():
            return float(_ep.ep_energy(self, self._X, self._y, state.nu,
                                       state.tau))

    def _latent(self, Xnew):
        return _ep.ep_predict_latent(self, self._X, self._ep()[1], Xnew)

    def _mean_basis(self):
        return self._X, self._ep()[1][0]


class SparseEPClassificationModel(_BaseClsModel):
    """Sparse binary GP classifier fitted by EP-DTC, the inference GPy's
    ``SparseGPClassification`` runs (:mod:`edrgp_tpu_torch.ops.ep_dtc`);
    probit link only.  ``log_likelihood`` reports log Z_EP-DTC."""

    def __init__(self, X: np.ndarray, y: np.ndarray, kernel: Kernel,
                 Z: np.ndarray | None = None, num_inducing: int = 10,
                 mean_function=None, dtype: torch.dtype | None = None,
                 seed: int = 0, device=None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        self._setup_cls(X, y, kernel, mean_function, dtype, device)
        self.Z = nn.Parameter(torch.tensor(       # a copy, see SGPRModel
            _inducing_init(X, Z, num_inducing, seed), dtype=dtype,
            device=device))

    def _objective_fn(self):
        return _ep_dtc.ep_dtc_neg_energy_objective(self, self._X, self._y)

    def _ep(self):
        """Lazy (sites, prediction cache); reset on every optimize()."""
        if self._cache is None:
            state = _ep_dtc.ep_dtc_fit(self, self._X, self._y)
            cache = _ep_dtc.ep_dtc_posterior_cache(self, self._X, state.nu,
                                                   state.tau)
            self._cache = (state, cache)
        return self._cache

    def log_likelihood(self) -> float:
        state, _ = self._ep()
        with torch.no_grad():
            return float(_ep_dtc.ep_dtc_energy(self, self._X, self._y,
                                               state.nu, state.tau))

    def _latent(self, Xnew):
        return _ep_dtc.ep_dtc_predict_latent(self, self._ep()[1], Xnew)

    def _mean_basis(self):
        return self.Z, _ep_dtc.mean_weights(self._ep()[1])


for _cls in (VGPClassificationModel, SparseVGPClassificationModel,
             EPClassificationModel, SparseEPClassificationModel):
    _state._MODEL_CLASSES[_cls.__name__] = _cls

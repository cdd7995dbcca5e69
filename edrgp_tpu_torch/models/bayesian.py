"""Fully Bayesian GP regression: NUTS-marginalized hyperparameters.

The port of :mod:`edrgp_tpu.models.bayesian`.  ``optimize`` runs NUTS
chains (batch-first, each with its own adaptation, as ``jax.vmap`` of
``run_nuts`` gives) over the exact GP's flat hyperparameters θ = (kernel
parameters, raw noise) in the JAX package's layout
(:func:`~edrgp_tpu_torch.ops.exact.theta_layout`); every leapfrog step is
one chain-batched NLML value+gradient, :func:`~edrgp_tpu_torch.ops.exact.
nlml_chains`, which for a plain RBF in float32 on the card runs kernel K in
the forward and kernel A in the backward, once per chain.  ``predict`` and
``predictive_gradients`` average over a thinned sample set: K(X, X*) goes
through kernel K and dμ/dx* through kernel G once per kept sample, so EDR
on this estimator uses *posterior-averaged* gradients.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import default_dtype, resolve_device
from ..inference.nuts import run_nuts
from ..metrics import potential_scale_reduction
from ..ops import exact as _exact
from ..ops.kernels import RBF, Kernel, positive
from . import state as _state
from .base import _BaseGP
from .state import Normalizer, _BaseModel

__all__ = ["BayesianGPModel", "BayesianGaussianProcessRegressor"]


class BayesianGPModel(_BaseModel):
    """GPy-like model surface with a posterior *ensemble* behind it.  The
    module's own kernel parameters and noise hold the initial θ until a
    prediction loads each kept sample into them in turn."""

    def __init__(self, X, y, kernel: Kernel, normalizer: bool = True,
                 noise_var: float = 1.0, num_chains: int = 4,
                 num_warmup: int = 300, num_samples: int = 300,
                 max_depth: int = 8, max_models: int = 32,
                 prior_scale: float = 3.0, seed: int = 0,
                 target_accept: float = 0.9,
                 dtype: torch.dtype | None = None, device=None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        y = np.asarray(y).reshape(-1)
        self.normalizer = Normalizer(y, enabled=bool(normalizer))
        self._setup(X, self.normalizer.normalize(y), kernel, noise_var,
                    dtype, device)
        # target_accept 0.9 (not the generic 0.8): GP hyperparameter
        # posteriors are funnel-prone, and the sharper dual-averaging
        # adaptation otherwise settles on step sizes that clip divergent
        # regions.
        self._cfg = dict(num_chains=num_chains, num_warmup=num_warmup,
                         num_samples=num_samples, max_depth=max_depth,
                         prior_scale=float(prior_scale),
                         target_accept=float(target_accept))
        self.max_models = max_models
        self._seed = seed
        self.samples_ = None         # [S, D] thinned unconstrained samples
        self.diagnostics_ = {}

    # --- fitting ----------------------------------------------------------
    def _flat0(self) -> torch.Tensor:
        return _exact.flatten_theta(self.kernel, self.raw_noise)

    def optimize(self, messages: bool = False, max_iters=None, **_ignored):
        kernel, X, y = self.kernel, self._X, self._y
        scale2 = self._cfg["prior_scale"] ** 2

        def logprob(q):
            return (-_exact.nlml_chains(kernel, q, X, y)
                    - 0.5 * (q * q).sum(-1) / scale2)

        flat0 = self._flat0()
        q0 = flat0.expand(self._cfg["num_chains"], flat0.shape[0])
        chains, info = run_nuts(
            logprob, q0, self._seed, num_warmup=self._cfg["num_warmup"],
            num_samples=self._cfg["num_samples"],
            max_depth=self._cfg["max_depth"],
            target_accept=self._cfg["target_accept"])     # [C, S, D]
        self.diagnostics_ = {
            "rhat": potential_scale_reduction(chains),
            "divergences": int(info["divergences"]),
            "step_size": info["step_size"],
        }
        pooled = chains.reshape(-1, chains.shape[-1])
        stride = max(1, pooled.shape[0] // self.max_models)
        self.samples_ = torch.as_tensor(pooled[::stride][:self.max_models],
                                        device=X.device)
        self._cache = None
        self._posterior()
        if messages:
            print(f"BayesianGP: {self.samples_.shape[0]} posterior models, "
                  f"max R-hat {self.diagnostics_['rhat'].max():.3f}, "
                  f"{self.diagnostics_['divergences']} divergences")
        return self

    optimize_restarts = optimize

    # --- posterior ensemble -----------------------------------------------
    def _posterior(self):
        """(L [S, N, N], α [S, N]) of every kept sample: one batched
        Cholesky."""
        if self._cache is None:
            self._cache = _exact.posterior_chains(self.kernel, self.samples_,
                                                  self._X, self._y)
        return self._cache

    @torch.no_grad()
    def _use_sample(self, theta: torch.Tensor) -> None:
        """Load one flat θ [D] into the module's kernel and noise."""
        params, raw_noise = _exact.unflatten_theta(self.kernel, theta[None])
        named = dict(self.kernel.named_parameters())
        for name, value in params.items():
            named[name].copy_(value[0])
        self.raw_noise.copy_(raw_noise[0])

    def _per_sample(self, fn):
        """``fn(s, (L_s, α_s))`` for every kept sample s, with its θ
        loaded, stacked."""
        L, alpha = self._posterior()
        out = []
        for s, theta in enumerate(self.samples_):
            self._use_sample(theta)
            out.append(fn(s, (L[s], alpha[s])))
        return out

    # --- prediction (posterior mixture) -----------------------------------
    def _moments(self, Xnew, include_likelihood):
        parts = self._per_sample(lambda s, cache: _exact.predict(
            self, self._X, cache, Xnew, include_likelihood))
        means = torch.stack([m for m, _ in parts])
        vars_ = torch.stack([v for _, v in parts])
        mean = means.mean(0)
        # mixture variance: E[var] + Var[mean]
        return mean, (vars_ + means ** 2).mean(0) - mean ** 2

    def predictive_gradients(self, Xnew, batch: int | None = None):
        """(dμ/dx* [M, Q, 1] averaged over the kept samples, its standard
        deviation over them [M, Q] on the normalized scale), as the JAX
        package returns them."""
        Xnew = self._as_input(Xnew)
        grads = torch.stack(self._per_sample(
            lambda s, cache: _exact.predict_mean_grad(self, self._X,
                                                      cache[1], Xnew)))
        dmu = self.normalizer.unnorm_grad(grads.mean(0).cpu().numpy())
        return dmu[:, :, None], grads.std(0, correction=0).cpu().numpy()

    def log_likelihood(self) -> float:
        """Posterior-mean log marginal likelihood (diagnostic summary)."""
        with torch.no_grad():
            return float((-_exact.nlml_chains(self.kernel, self.samples_,
                                              self._X, self._y)).mean())

    @property
    def noise_variance(self) -> float:
        return float(positive(self.samples_[:, -1]).mean())

    # --- persistence ------------------------------------------------------
    def _pickle_state(self) -> dict:
        state = super()._pickle_state()
        state.update(samples=self.samples_.cpu().numpy(),
                     diagnostics=self.diagnostics_, cfg=dict(self._cfg),
                     max_models=self.max_models, seed=self._seed)
        return state

    def _restore(self, state: dict) -> None:
        self.samples_ = torch.as_tensor(state["samples"],
                                        device=self._X.device)
        self.diagnostics_ = state["diagnostics"]
        self._cfg = state["cfg"]
        self.max_models = state["max_models"]
        self._seed = state["seed"]


_state._MODEL_CLASSES["BayesianGPModel"] = BayesianGPModel


class BayesianGaussianProcessRegressor(_BaseGP):
    """Estimator facade: a drop-in for ``GaussianProcessRegressor`` with the
    hyperparameter posterior integrated out."""

    _estimator_type = "regressor"

    def __init__(self, kernels=None, kernel_options=None, normalizer=True,
                 noise_var=1.0, num_chains=4, num_warmup=300,
                 num_samples=300, max_depth=8, max_models=32,
                 prior_scale=3.0, seed=0, target_accept=0.9,
                 method="optimize", device=None):
        self.kernels = kernels
        self.kernel_options = kernel_options
        self.normalizer = normalizer
        self.noise_var = noise_var
        self.num_chains = num_chains
        self.num_warmup = num_warmup
        self.num_samples = num_samples
        self.max_depth = max_depth
        self.max_models = max_models
        self.prior_scale = prior_scale
        self.seed = seed
        self.target_accept = target_accept
        self.method = method
        self.device = device

    def _get_model(self, X, y, kernel):
        if kernel is None:
            kernel = RBF(X.shape[1])
        return BayesianGPModel(
            X, y, kernel, normalizer=self.normalizer,
            noise_var=self.noise_var, num_chains=self.num_chains,
            num_warmup=self.num_warmup, num_samples=self.num_samples,
            max_depth=self.max_depth, max_models=self.max_models,
            prior_scale=self.prior_scale, seed=self.seed,
            target_accept=self.target_accept, device=self.device)

"""Fitted GP model objects with a GPy-compatible surface.

The port of :mod:`edrgp_tpu.models.state` (exact GP only).  A model is an
``nn.Module`` whose ``state_dict()`` keys are the JAX package's pytree paths
(``kernel.variance``, ``kernel.lengthscale``, ``raw_noise``), all in
unconstrained space; the training data are plain attributes, not buffers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import default_dtype, resolve_device
from ..inference.lbfgs import minimize, minimize_restarts
from ..ops import exact as _exact
from ..ops.kernels import Kernel, inv_positive, positive

__all__ = ["Normalizer", "ExactGPModel"]


class Normalizer:
    """y standardization, the ``normalizer=True`` semantics of GPy: train on
    standardized y, un-normalize predictions (mean·σ+μ, var·σ²)."""

    def __init__(self, y: np.ndarray, enabled: bool = True):
        self.enabled = bool(enabled)
        if self.enabled:
            self.mean = float(np.mean(y))
            std = float(np.std(y))
            self.std = std if std > 0 else 1.0
        else:
            self.mean, self.std = 0.0, 1.0

    def normalize(self, y):
        return (y - self.mean) / self.std

    def unnorm_mean(self, m):
        return m * self.std + self.mean

    def unnorm_var(self, v):
        return v * self.std ** 2

    def unnorm_grad(self, g):
        return g * self.std


def _perturb_inits(state: dict, num: int, generator: torch.Generator,
                   scale: float = 1.0) -> list:
    """``num`` initializations: the given state, then ``num − 1`` copies
    perturbed by N(0, scale²) noise drawn from ``generator`` (on the CPU, so
    a seed gives the same inits on every device)."""
    inits = [dict(state)]
    for _ in range(num - 1):
        inits.append({
            k: v + scale * torch.randn(v.shape, generator=generator,
                                       dtype=v.dtype).to(v.device)
            for k, v in state.items()})
    return inits


class _BaseModel(nn.Module):
    """Shared GPy-like surface: optimize / optimize_restarts."""

    #: Restarts ``optimize()`` runs by default in float32: the fp32 NLML
    #: surface is multimodal enough that one default-init fit lands in a
    #: wrong basin often (``edrgp_tpu/models/state.py:167``); f64 keeps one.
    _f32_default_restarts = 1

    def _default_tol(self) -> float:
        """Gradient-norm tolerance matched to the working precision: 1e-6
        is reachable in float64, not in float32."""
        return 1e-6 if self._X.dtype == torch.float64 else 3e-4

    def _objective_fn(self):
        raise NotImplementedError

    def _finish(self, res, label: str, messages: bool):
        self._objective = float(res.value)
        self._cache = None
        if messages:
            print(f"{type(self).__name__}: {label}objective="
                  f"{self._objective:.6f} iters={res.num_iters} "
                  f"|g|={res.grad_norm:.3e}")
        return self

    def optimize(self, messages: bool = False, max_iters: int = 1000,
                 tol: float | None = None, num_restarts: int | None = None,
                 **_ignored):
        if num_restarts is None:
            num_restarts = (self._f32_default_restarts
                            if self._X.dtype == torch.float32 else 1)
        if int(num_restarts) > 1:
            return self.optimize_restarts(
                num_restarts=int(num_restarts), messages=messages,
                max_iters=max_iters, tol=tol)
        tol = self._default_tol() if tol is None else tol
        res = minimize(self._objective_fn(), list(self.parameters()),
                       max_iters=int(max_iters), tol=float(tol))
        return self._finish(res, "", messages)

    def optimize_restarts(self, num_restarts: int = 3, verbose: bool = False,
                          messages: bool = False, max_iters: int = 1000,
                          tol: float | None = None, seed: int = 0,
                          generator: torch.Generator | None = None,
                          **_ignored):
        """Best of ``num_restarts`` fits: the current parameters and
        perturbations of them drawn from ``generator`` (default: a CPU
        generator seeded with ``seed``)."""
        tol = self._default_tol() if tol is None else tol
        if num_restarts <= 1:
            return self.optimize(messages=messages, max_iters=max_iters,
                                 tol=tol, num_restarts=1)
        if generator is None:
            generator = torch.Generator().manual_seed(int(seed))
        names = [n for n, _ in self.named_parameters()]
        state = {n: p.detach().clone() for n, p in self.named_parameters()}
        inits = [[s[n] for n in names] for s in
                 _perturb_inits(state, int(num_restarts), generator)]
        res = minimize_restarts(self._objective_fn(), list(self.parameters()),
                                inits, max_iters=int(max_iters),
                                tol=float(tol))
        return self._finish(res, f"best of {num_restarts} restarts ",
                            verbose or messages)

    @property
    def noise_variance(self) -> float:
        return float(positive(self.raw_noise))

    def get_hyperparameters(self) -> dict:
        """Constrained-space hyperparameters as plain numpy, keyed like the
        JAX package's (``['kernel']['variance']``, …, ``['noise']``)."""
        out = {}
        for name, p in self.named_parameters():
            key = "".join(f"['{part}']" for part in name.split("."))
            out[key.replace("raw_", "")] = (
                positive(p.detach()).cpu().numpy())
        return out


class ExactGPModel(_BaseModel):
    """Exact GP regression: native ``GPy.models.GPRegression`` equivalent."""

    _f32_default_restarts = 5   # fp32 NLML is multimodal; see _BaseModel

    def __init__(self, X: np.ndarray, y: np.ndarray, kernel: Kernel,
                 normalizer: bool = True, noise_var: float = 1.0,
                 dtype: torch.dtype | None = None, device=None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        y = np.asarray(y).reshape(-1)
        self.normalizer = Normalizer(y, enabled=bool(normalizer))
        self.kernel = kernel.to(device=device, dtype=dtype)
        self.raw_noise = nn.Parameter(inv_positive(
            torch.tensor(float(noise_var), dtype=dtype, device=device)))
        self._X = torch.as_tensor(np.asarray(X), dtype=dtype, device=device)
        self._y = torch.as_tensor(self.normalizer.normalize(y), dtype=dtype,
                                  device=device)
        self._objective = float("nan")
        self._cache = None

    def _objective_fn(self):
        return lambda: _exact.nlml(self, self._X, self._y)

    def _as_input(self, Xnew) -> torch.Tensor:
        return torch.as_tensor(np.asarray(Xnew), dtype=self._X.dtype,
                               device=self._X.device)

    # --- posterior --------------------------------------------------------
    def _posterior(self):
        if self._cache is None:
            self._cache = _exact.posterior(self, self._X, self._y)
        return self._cache

    def log_likelihood(self) -> float:
        with torch.no_grad():
            return float(-_exact.nlml(self, self._X, self._y))

    def predict(self, Xnew, include_likelihood: bool = True):
        """(mean [M, 1], var [M, 1]) as numpy, in the original y scale."""
        mean, var = _exact.predict(self, self._X, self._posterior(),
                                   self._as_input(Xnew), include_likelihood)
        mean = self.normalizer.unnorm_mean(mean.cpu().numpy())
        var = self.normalizer.unnorm_var(var.cpu().numpy())
        return mean[:, None], var[:, None]

    def predictive_gradients(self, Xnew, batch: int | None = None):
        """(dmu [M, Q, 1], dvar [M, Q]) as numpy — GPy's contract.

        ``batch`` chunks the generic paths' test points; None picks a size
        that bounds the [batch, N] block.
        """
        Xnew = self._as_input(Xnew)
        cache = self._posterior()
        if batch is None:
            batch = _exact.grad_batch_size(Xnew.shape[0], self._X.shape[0])
        dmu = _exact.predict_mean_grad_batched(self, self._X, cache[1], Xnew,
                                               batch)
        dvar = _exact.predict_var_grad_batched(self, self._X, cache, Xnew,
                                               batch)
        dmu = self.normalizer.unnorm_grad(dmu.cpu().numpy())
        dvar = self.normalizer.unnorm_var(dvar.cpu().numpy())
        return dmu[:, :, None], dvar

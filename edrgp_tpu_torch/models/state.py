"""Fitted GP model objects with a GPy-compatible surface.

The port of :mod:`edrgp_tpu.models.state` (exact GP and SGPR; the SVGP,
classification, heteroscedastic and Bayesian models add themselves to
``_MODEL_CLASSES`` from their modules, which ``models`` imports).  A model is
an ``nn.Module`` whose ``state_dict()`` keys are the JAX package's pytree
paths (``kernel.variance``, ``kernel.lengthscale``, ``raw_noise``, ``Z``),
all in unconstrained space but ``Z``; the training data are plain
attributes, not buffers.  ``pickle``/:func:`load_model` save and restore a
model as numpy and plain Python, so a pickle holds no tensor on a device.
"""

from __future__ import annotations

import os
import pickle as _pickle
import warnings

import numpy as np
import torch
from torch import nn

from ..config import default_dtype, resolve_device
from ..inference.lbfgs import minimize, minimize_restarts
from ..ops import exact as _exact
from ..ops import sgpr as _sgpr
from ..ops import uncertain as _uncertain
from ..ops.kernels import (Kernel, inv_positive, kernel_from_spec,
                           kernel_spec, positive)

__all__ = ["Normalizer", "ExactGPModel", "SGPRModel", "load_model"]

#: Prefix of the class name a pickle of this package records, so that
#: neither package takes the other's pickles for its own.
_PICKLE_PREFIX = "edrgp_tpu_torch."


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


def _as_numpy(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    return np.asarray(values).reshape(-1)


def _autograd_mean_grad(mean_function, X: np.ndarray):
    """dm/dx at each row of X by autograd, or None when ``mean_function``
    does not work on a float64 tensor that requires grad (a numpy-only
    callable raises whatever error, as the JAX package's fallback takes
    any, or returns something autograd cannot follow).  Each output
    depends only on its own row, so one backward of the sum gives every
    row."""
    x = torch.tensor(X, dtype=torch.float64, requires_grad=True)
    try:
        out = mean_function(x)
    except Exception:
        return None
    if not (isinstance(out, torch.Tensor) and out.requires_grad):
        return None
    (g,) = torch.autograd.grad(out.reshape(-1).sum(), x)
    return g.numpy()


class _MeanFunctionMixin:
    """Prior mean-function semantics (GPy ``mean_function``): the GP is fit
    on the residual y − m(X), and m(x*) is added back to every posterior
    mean.  ``mean_function`` maps an [N, Q] array to [N] values (numpy or
    torch; it is called with numpy arrays).

    As in the JAX package (PARITY.md G8), ``m`` acts in the *original*
    output space under ``normalizer=True``: the residuals are m(X)/σ_y on
    the normalized scale and m(x*) is added after un-normalization, so far
    from the data the prediction reverts to m(x*) plus the targets' mean
    (the normalizer's μ_y), whatever σ_y is.
    """

    mean_function = None

    def _set_mean_function(self, mean_function) -> None:
        # Past nn.Module's __setattr__: a module given as the mean function
        # must not become a submodule whose parameters ML-II would fit.
        object.__setattr__(self, "mean_function", mean_function)

    def _residual_targets(self, X, y_n):
        """Subtract m(X)/σ_y from normalized targets."""
        if self.mean_function is None:
            return y_n
        shift = _as_numpy(self.mean_function(np.asarray(X)))
        return y_n - shift / max(self.normalizer.std, 1e-300)

    def _mean_shift_at(self, Xnew) -> np.ndarray:
        """m(x*) in the original (unnormalized) output space."""
        if self.mean_function is None:
            return np.zeros(np.shape(Xnew)[0])
        return _as_numpy(self.mean_function(np.asarray(Xnew)))

    def _mean_grad_at(self, Xnew) -> np.ndarray:
        """dm/dx* [M, Q]: autograd when the callable works on a float64
        tensor, central differences otherwise (the JAX package's ``eps``)."""
        if self.mean_function is None:
            return np.zeros(np.shape(Xnew))
        Xnew = np.asarray(Xnew, float)
        g = _autograd_mean_grad(self.mean_function, Xnew)
        if g is not None:
            return g
        eps = 1e-5 * max(1.0, float(np.abs(Xnew).max()))
        G = np.zeros_like(Xnew)
        for q in range(Xnew.shape[1]):
            Xp, Xm = Xnew.copy(), Xnew.copy()
            Xp[:, q] += eps
            Xm[:, q] -= eps
            G[:, q] = (_as_numpy(self.mean_function(Xp))
                       - _as_numpy(self.mean_function(Xm))) / (2 * eps)
        return G


def _atomic_pickle_dump(state, path: str):
    """Serialize to a sibling tmp file, then rename: a failed dump never
    truncates an existing checkpoint."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            _pickle.dump(state, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


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


class _BaseModel(_MeanFunctionMixin, nn.Module):
    """Shared GPy-like surface: optimize / optimize_restarts / pickle."""

    #: Restarts ``optimize()`` runs by default in float32: the fp32 NLML
    #: surface is multimodal enough that one default-init fit lands in a
    #: wrong basin often (``edrgp_tpu/models/state.py:167``); f64 keeps one.
    _f32_default_restarts = 1

    def _setup(self, X, y_n, kernel: Kernel, noise_var: float | None, dtype,
               device) -> None:
        """Kernel and noise parameters, training data on ``device``; no
        noise parameter when ``noise_var`` is None (the classifiers)."""
        self.kernel = kernel.to(device=device, dtype=dtype)
        if noise_var is not None:
            self.raw_noise = nn.Parameter(inv_positive(
                torch.tensor(float(noise_var), dtype=dtype, device=device)))
        self._X = torch.as_tensor(np.asarray(X), dtype=dtype, device=device)
        self._y = torch.as_tensor(np.asarray(y_n), dtype=dtype,
                                  device=device)
        self._objective = float("nan")
        self._cache = None

    def _as_input(self, Xnew) -> torch.Tensor:
        return torch.as_tensor(np.asarray(Xnew), dtype=self._X.dtype,
                               device=self._X.device)

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

    # --- persistence ------------------------------------------------------
    def _pickle_state(self) -> dict:
        return {
            "class": _PICKLE_PREFIX + type(self).__name__,
            "kernel": kernel_spec(self.kernel),
            "params": {k: v.detach().cpu().numpy()
                       for k, v in self.state_dict().items()},
            "X": self._X.cpu().numpy(),
            "y": self._y.cpu().numpy(),
            "normalizer": self.normalizer,
            "objective": self._objective,
            "mean_function": self.mean_function,
        }

    def _restore(self, state: dict) -> None:
        """Parameters and switches beyond the kernel and the noise, from
        :meth:`_pickle_state`'s ``state`` (before ``load_state_dict``)."""

    def _restore_parameters(self, state: dict, names) -> None:
        """Each of ``names`` that the pickle holds as a parameter of its
        saved shape, for ``load_state_dict`` to fill."""
        for name in names:
            if name in state["params"]:
                setattr(self, name, nn.Parameter(torch.as_tensor(
                    state["params"][name], device=self._X.device)))

    def pickle(self, path: str):
        """Save the model to ``path`` (restore it with :func:`load_model`).
        A mean function that cannot be pickled (a lambda, a closure) is
        dropped with a ``RuntimeWarning``: the loaded model then predicts
        without the prior-mean shift."""
        state = self._pickle_state()
        mf = state["mean_function"]
        if mf is not None:
            try:
                _pickle.dumps(mf)
            except (_pickle.PicklingError, AttributeError, TypeError):
                warnings.warn("mean_function is not picklable; saving the "
                              "model without it", RuntimeWarning)
                state["mean_function"] = None
        _atomic_pickle_dump(state, path)

    # --- prediction -------------------------------------------------------
    def _moments(self, Xnew: torch.Tensor, include_likelihood: bool):
        """Posterior (mean [S], var [S]) on the normalized scale."""
        raise NotImplementedError

    def _gradients(self, Xnew: torch.Tensor, batch: int | None):
        """(dμ/dx* [S, Q], dvar/dx* [S, Q]) on the normalized scale."""
        raise NotImplementedError

    def predict(self, Xnew, include_likelihood: bool = True):
        """(mean [S, 1], var [S, 1]) as numpy, in the original y scale."""
        Xnew = self._as_input(Xnew)
        mean, var = self._moments(Xnew, include_likelihood)
        mean = (self.normalizer.unnorm_mean(mean.cpu().numpy())
                + self._mean_shift_at(Xnew.cpu().numpy()))
        var = self.normalizer.unnorm_var(var.cpu().numpy())
        return mean[:, None], var[:, None]

    def predictive_gradients(self, Xnew, batch: int | None = None):
        """(dmu [S, Q, 1], dvar [S, Q]) as numpy — GPy's contract.

        ``batch`` chunks the generic paths' test points; None picks a size
        that bounds the [batch, N] (sparse: [batch, M]) block.
        """
        Xnew = self._as_input(Xnew)
        dmu, dvar = self._gradients(Xnew, batch)
        dmu = (self.normalizer.unnorm_grad(dmu.cpu().numpy())
               + self._mean_grad_at(Xnew.cpu().numpy()))
        dvar = self.normalizer.unnorm_var(dvar.cpu().numpy())
        return dmu[:, :, None], dvar

    @property
    def noise_variance(self) -> float:
        return float(positive(self.raw_noise.detach()))

    def get_hyperparameters(self) -> dict:
        """Hyperparameters as plain numpy, keyed like the JAX package's
        (``['kernel']['variance']``, ``['kernel'][0]['variance']`` for the
        parts of a sum, ``['noise']``): constrained, but the inducing inputs
        ``['Z']`` as they are."""
        out = {}
        for name, p in self.named_parameters():
            parts = name.split(".")
            key = "".join(
                f"[{part}]" if part.isdigit() else f"['{part}']"
                for i, part in enumerate(parts)
                if not (part == "kernels" and i + 1 < len(parts)
                        and parts[i + 1].isdigit()))
            value = p.detach() if name == "Z" else positive(p.detach())
            out[key.replace("raw_", "")] = value.cpu().numpy()
        return out


class ExactGPModel(_BaseModel):
    """Exact GP regression: native ``GPy.models.GPRegression`` equivalent."""

    _f32_default_restarts = 5   # fp32 NLML is multimodal; see _BaseModel

    def __init__(self, X: np.ndarray, y: np.ndarray, kernel: Kernel,
                 normalizer: bool = True, noise_var: float = 1.0,
                 mean_function=None, dtype: torch.dtype | None = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        self._set_mean_function(mean_function)
        y = np.asarray(y).reshape(-1)
        self.normalizer = Normalizer(y, enabled=bool(normalizer))
        y_n = self._residual_targets(X, self.normalizer.normalize(y))
        self._setup(X, y_n, kernel, noise_var, dtype, device)

    def _objective_fn(self):
        return lambda: _exact.nlml(self, self._X, self._y)

    # --- distributed fitting (kernel-block parallel) ------------------------
    def optimize_sharded(self, mesh=None, axis: str = "data",
                         messages: bool = False, max_iters: int = 1000,
                         tol: float | None = None, **_ignored):
        """ML-II with the N×N system row-slab-sharded over ``mesh``'s
        dimension ``axis``: L-BFGS on the distributed NLML of
        :mod:`edrgp_tpu_torch.parallel.exact_sharded`, whose value and
        gradient have the same bits on every rank, so every rank takes the
        same steps.  A rank's working set is O(N²/p).  Every rank calls it
        with the same model; ``mesh=None`` builds a 1-D mesh over the
        ranks of the default group.  N must be divisible by the axis size.
        Reachable from the estimator as
        ``GaussianProcessRegressor(method="optimize_sharded")``."""
        from ..parallel.exact_sharded import (make_sharded_nlml_objective,
                                              shard_rows)
        from ..parallel.mesh import axis_size, make_mesh
        if mesh is None:
            mesh = make_mesh((axis,))
        X_local, y_local = shard_rows(mesh, axis, self._X, self._y)
        fun = make_sharded_nlml_objective(self, mesh, axis)
        tol = self._default_tol() if tol is None else tol
        res = minimize(lambda: fun(X_local, y_local), list(self.parameters()),
                       max_iters=int(max_iters), tol=float(tol))
        return self._finish(res, f"sharded({axis_size(mesh, axis)}x "
                            f"{axis}) ", messages)

    # --- posterior --------------------------------------------------------
    def _posterior(self):
        if self._cache is None:
            self._cache = _exact.posterior(self, self._X, self._y)
        return self._cache

    def log_likelihood(self) -> float:
        with torch.no_grad():
            return float(-_exact.nlml(self, self._X, self._y))

    def _moments(self, Xnew, include_likelihood):
        return _exact.predict(self, self._X, self._posterior(), Xnew,
                              include_likelihood)

    def _gradients(self, Xnew, batch):
        cache = self._posterior()
        if batch is None:
            batch = _exact.grad_batch_size(Xnew.shape[0], self._X.shape[0])
        return (_exact.predict_mean_grad_batched(self, self._X, cache[1],
                                                 Xnew, batch),
                _exact.predict_var_grad_batched(self, self._X, cache, Xnew,
                                                batch))

    def _gradient_basis(self):
        """(kernel, C, w) with dμ/dx* = ∇ₓ Σᵢ wᵢ k(x, Cᵢ) on the
        normalized-y scale: (X, α), the basis the data-parallel EDR shards
        over (:mod:`edrgp_tpu_torch.parallel.edr_sharded`)."""
        return self.kernel, self._X, self._posterior()[1]

    def predict_full_cov(self, Xnew):
        """Posterior mean [M] and full covariance [M, M] of the latent
        function, as numpy in the original y scale."""
        Xnew = self._as_input(Xnew)
        mean, cov = _exact.predict_full_cov(self, self._X, self._posterior(),
                                            Xnew)
        return (self.normalizer.unnorm_mean(mean.cpu().numpy())
                + self._mean_shift_at(Xnew.cpu().numpy()),
                self.normalizer.unnorm_var(cov.cpu().numpy()))

    def posterior_samples_f(self, Xnew, size: int = 10, seed: int = 0,
                            generator: torch.Generator | None = None):
        """Joint samples of the latent function at Xnew: [size, M] numpy
        (GPy's ``posterior_samples_f``), the normal draws from
        ``generator`` (default: one on the model's device seeded with
        ``seed``)."""
        Xnew = self._as_input(Xnew)
        if generator is None:
            generator = torch.Generator(device=self._X.device).manual_seed(
                int(seed))
        samples = _exact.posterior_samples_f(self, self._X, self._posterior(),
                                             Xnew, size, generator)
        return (self.normalizer.unnorm_mean(samples.cpu().numpy())
                + self._mean_shift_at(Xnew.cpu().numpy())[None, :])


class SGPRModel(_BaseModel):
    """Titsias sparse GP regression: ``GPy.models.SparseGPRegression``
    equivalent (inducing inputs Z optimized jointly, unconstrained).

    ``X_variance`` (a scalar or [N, Q]) makes the inputs Gaussian,
    x_n ~ N(X_n, diag(X_variance_n)), and switches the bound and posterior
    to the psi statistics of :mod:`edrgp_tpu_torch.ops.uncertain` (RBF
    kernels only).
    """

    _f32_default_restarts = 5   # fp32 ML-II is multimodal; see _BaseModel

    def __init__(self, X: np.ndarray, y: np.ndarray, kernel: Kernel,
                 Z: np.ndarray | None = None, num_inducing: int = 10,
                 X_variance=None, normalizer: bool = True,
                 noise_var: float = 1.0, mean_function=None,
                 dtype: torch.dtype | None = None, seed: int = 0,
                 device=None):
        super().__init__()
        if X_variance is not None:
            _uncertain._check_kernel(kernel)
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        self._set_mean_function(mean_function)
        y = np.asarray(y).reshape(-1)
        self.normalizer = Normalizer(y, enabled=bool(normalizer))
        y_n = self._residual_targets(X, self.normalizer.normalize(y))
        if Z is None:
            # Random-subset init, GPy's default when only num_inducing given.
            rng = np.random.default_rng(seed)
            m = min(int(num_inducing), X.shape[0])
            Z = np.asarray(X)[rng.permutation(X.shape[0])[:m]]
        self._setup(X, y_n, kernel, noise_var, dtype, device)
        # A copy: the optimizer updates Z in place, and an array given as
        # Z (a slice of X, say) must not change under the caller.
        self.Z = nn.Parameter(torch.tensor(np.asarray(Z), dtype=dtype,
                                           device=device))
        self._set_x_variance(X_variance)

    def _set_x_variance(self, X_variance) -> None:
        self._Xvar = (None if X_variance is None else torch.as_tensor(
            np.asarray(X_variance), dtype=self._X.dtype,
            device=self._X.device).expand(self._X.shape).clone())

    def _objective_fn(self):
        if self._Xvar is None:
            return lambda: -_sgpr.elbo(self, self._X, self._y)
        return lambda: -_uncertain.elbo(self, self._X, self._y, self._Xvar)

    def _posterior(self):
        if self._cache is None:
            if self._Xvar is None:
                self._cache = _sgpr.sgpr_posterior(self, self._X, self._y)
            else:
                self._cache = _uncertain.posterior(self, self._X, self._y,
                                                   self._Xvar)
        return self._cache

    def log_likelihood(self) -> np.ndarray:
        """The bound as a [[value]] array, as GPy's sparse models give it
        (read as ``[0][0]`` by the reference's tests)."""
        with torch.no_grad():
            return np.array([[-float(self._objective_fn()())]])

    def _pickle_state(self) -> dict:
        state = super()._pickle_state()
        if self._Xvar is not None:
            state["X_variance"] = self._Xvar.cpu().numpy()
        return state

    def _restore(self, state: dict) -> None:
        self._restore_parameters(state, ("Z",))
        self._set_x_variance(state.get("X_variance"))

    def _moments(self, Xnew, include_likelihood):
        return _sgpr.predict(self, self._posterior(), Xnew,
                             include_likelihood)

    def _gradients(self, Xnew, batch):
        """dμ/dx* goes through kernel G (C = Z, w = β) on the card for an
        RBF."""
        cache = self._posterior()
        return (_sgpr.predict_mean_grad(self, cache[2], Xnew, batch),
                _sgpr.predict_var_grad(self, cache, Xnew, batch))

    def _gradient_basis(self):
        """(kernel, Z, β): see ``ExactGPModel._gradient_basis``."""
        return self.kernel, self.Z, self._posterior()[2]


_MODEL_CLASSES = {"ExactGPModel": ExactGPModel, "SGPRModel": SGPRModel}


def load_model(path: str, device=None) -> _BaseModel:
    """Restore a model saved by ``pickle`` onto ``device`` (None: the
    card), in the dtype it was saved in.  Unpickling runs code named in
    the file: load only files this package wrote."""
    with open(path, "rb") as f:
        state = _pickle.load(f)
    name = state.get("class", "") if isinstance(state, dict) else ""
    if not name.startswith(_PICKLE_PREFIX) \
            or name[len(_PICKLE_PREFIX):] not in _MODEL_CLASSES:
        raise ValueError(f"{path} is not a model pickle of edrgp_tpu_torch "
                         f"(class {name!r})")
    cls = _MODEL_CLASSES[name[len(_PICKLE_PREFIX):]]
    device = resolve_device(device)
    obj = cls.__new__(cls)
    nn.Module.__init__(obj)
    obj._set_mean_function(state["mean_function"])
    obj.normalizer = state["normalizer"]
    noise = 1.0 if "raw_noise" in state["params"] else None
    obj._setup(state["X"], state["y"], kernel_from_spec(state["kernel"]),
               noise, torch.from_numpy(state["X"]).dtype, device)
    obj._restore(state)
    obj.load_state_dict({k: torch.from_numpy(np.asarray(v))
                         for k, v in state["params"].items()})
    obj._objective = state["objective"]
    return obj

"""SVGP regression model and its estimator, the large-N path.

The port of :mod:`edrgp_tpu.models.svgp`.  Each step draws one minibatch,
takes one Adam step of the hyperparameters (kernel, noise, inducing inputs)
on the minibatch ELBO and one closed-form natural-gradient step of the
variational posterior
(:func:`edrgp_tpu_torch.ops.svgp.natural_gradient_update`) with
ρ = 0.5 / (1 + 0.05·t) at global step t.  :meth:`SVGPModel.optimize`
draws the minibatches from training data held on the device;
:meth:`SVGPModel.optimize_stream` takes them from a host iterator such as
:meth:`edrgp_tpu_torch.data.MMapDataset.batches`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..config import default_dtype, resolve_device
from ..ops import svgp as _svgp
from ..ops.exact import grad_batch_size
from ..ops.kernels import RBF, Kernel
from . import state as _state
from .base import _BaseGP
from .state import Normalizer, _BaseModel

__all__ = ["SVGPModel", "SVGPRegressor"]


def _rho(step: int) -> float:
    """The natural-gradient step size at global step ``step``."""
    return 0.5 / (1.0 + 0.05 * step)


class _ChunkFeed:
    """Chunks of host batches onto the model's device in one copy each.

    On the card a chunk is staged in one of two pinned host buffers and sent
    with one ``non_blocking`` copy, so the host gathers the next chunk while
    the card runs this one.  A CUDA event recorded after each copy is waited
    on before its buffer is refilled: without it a refill could overwrite a
    copy still in flight.  On the CPU the arrays are converted as they are.
    """

    def __init__(self, device: torch.device, dtype: torch.dtype):
        self.device, self.dtype = device, dtype
        self._slots = []
        self._turn = 0

    def put(self, Xc: np.ndarray, yc: np.ndarray):
        if self.device.type != "cuda":
            return (torch.as_tensor(Xc, dtype=self.dtype),
                    torch.as_tensor(yc, dtype=self.dtype))
        if not self._slots:
            self._slots = [
                (torch.empty(Xc.shape, dtype=self.dtype, pin_memory=True),
                 torch.empty(yc.shape, dtype=self.dtype, pin_memory=True),
                 torch.cuda.Event())
                for _ in range(2)]
        hX, hy, copied = self._slots[self._turn]
        self._turn ^= 1
        copied.synchronize()
        k = Xc.shape[0]
        hX[:k].copy_(torch.from_numpy(Xc))
        hy[:k].copy_(torch.from_numpy(yc))
        out = (hX[:k].to(self.device, non_blocking=True),
               hy[:k].to(self.device, non_blocking=True))
        copied.record()
        return out


class SVGPModel(_BaseModel):
    """Minibatch SVGP regression with the GPy-like model surface."""

    def __init__(self, X: np.ndarray, y: np.ndarray, kernel: Kernel,
                 Z: np.ndarray | None = None, num_inducing: int = 128,
                 normalizer: bool = True, noise_var: float = 1.0,
                 dtype: torch.dtype | None = None, seed: int = 0,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        y = np.asarray(y).reshape(-1)
        self.normalizer = Normalizer(y, enabled=bool(normalizer))
        if Z is None:
            rng = np.random.default_rng(seed)
            m = min(int(num_inducing), X.shape[0])
            Z = np.asarray(X)[rng.permutation(X.shape[0])[:m]]
        self._setup(X, self.normalizer.normalize(y), kernel, noise_var,
                    dtype, device)
        # A copy: the optimizer updates Z in place, and an array given as
        # Z (a slice of X, say) must not change under the caller.
        self.Z = nn.Parameter(torch.tensor(np.asarray(Z), dtype=dtype,
                                           device=device))
        self.qstate = _svgp.init_svgp_state(self.Z.shape[0], dtype, device)
        self._seed = seed
        self.elbo_trace_ = None

    @classmethod
    def from_dataset(cls, dataset, kernel: Kernel, num_inducing: int = 128,
                     subsample: int = 4096, normalizer: bool = True,
                     noise_var: float = 1.0, dtype=None, seed: int = 0,
                     device=None):
        """Construct from an on-disk :class:`edrgp_tpu_torch.data.MMapDataset`
        without loading it: a sorted random subsample provides the
        y-normalizer statistics and the inducing-point init; training then
        runs through :meth:`optimize_stream`."""
        rng = np.random.default_rng(seed)
        idx = np.sort(rng.choice(dataset.n_rows,
                                 size=min(subsample, dataset.n_rows),
                                 replace=False))
        Xs, ys = dataset.read_rows(idx)
        return cls(Xs, ys, kernel, num_inducing=num_inducing,
                   normalizer=normalizer, noise_var=noise_var, dtype=dtype,
                   seed=seed, device=device)

    # --- fitting ----------------------------------------------------------
    def _step(self, opt, Xb, yb, n_total, rho) -> torch.Tensor:
        """One Adam step on the minibatch ELBO, then one natural-gradient
        step of q(u) at the updated parameters; returns the ELBO before
        both, on the device.  The parts run under ``torch.profiler`` labels
        (``svgp.q``, ``svgp.elbo``, ``svgp.adam``, ``svgp.natgrad``; the
        backward is the rest), which cost a few µs outside a profiler."""
        with record_function("svgp.q"):
            m, S = _svgp.q_from_natural(self.qstate)
        opt.zero_grad(set_to_none=True)
        with record_function("svgp.elbo"):
            elbo = _svgp.svgp_elbo(self, m, S, Xb, yb, n_total)
        (-elbo).backward()
        with record_function("svgp.adam"):
            opt.step()
        with record_function("svgp.natgrad"):
            self.qstate = _svgp.natural_gradient_update(
                self, self.qstate, Xb, yb, n_total, rho)
        return elbo.detach()

    def optimize(self, messages: bool = False, max_iters: int = 1000,
                 batch_size: int = 256, lr: float = 3e-3, **_ignored):
        """``max_iters`` steps on minibatches of the training data, drawn
        with replacement by a generator on the model's device seeded with
        ``seed``.  Adam's state is new at each call."""
        X, y = self._X, self._y
        n = X.shape[0]
        batch_size = min(int(batch_size), n)
        gen = torch.Generator(device=X.device).manual_seed(self._seed)
        opt = torch.optim.Adam(self.parameters(), lr=float(lr))
        elbos = torch.empty(int(max_iters), dtype=X.dtype, device=X.device)
        for t in range(int(max_iters)):
            idx = torch.randint(0, n, (batch_size,), generator=gen,
                                device=X.device)
            elbos[t] = self._step(opt, X[idx], y[idx], n, _rho(t))
        self.elbo_trace_ = elbos.cpu().numpy()
        self._objective = float(-self.elbo_trace_[-1])
        self._cache = None
        if messages:
            print(f"SVGP: final minibatch ELBO={self.elbo_trace_[-1]:.4f}")
        return self

    def optimize_restarts(self, num_restarts: int = 1, **kw):
        """SVI is stochastic already: restarts degrade to one run."""
        return self.optimize(**kw)

    def optimize_stream(self, batches, n_total: int, steps: int = 1000,
                        lr: float = 3e-3, messages: bool = False,
                        log_every: int = 0, metrics_logger=None,
                        scan_chunk: int = 16):
        """Train from a host-side minibatch iterator (the N ≫ memory path).

        ``batches`` yields (X_b [B,Q], y_b [B]), typically
        :meth:`edrgp_tpu_torch.data.MMapDataset.batches` on the native
        loader.  y_b is normalized on the host with the model's normalizer.
        ``scan_chunk`` batches go to the device in one copy (see
        :class:`_ChunkFeed`); no value is read back to the host inside a
        chunk, and the minibatch ELBO only every ``log_every`` steps and at
        the end.
        """
        opt = torch.optim.Adam(self.parameters(), lr=float(lr))
        chunk = max(int(scan_chunk), 1)
        feed = _ChunkFeed(self._X.device, self._X.dtype)
        mu_y, std_y = self.normalizer.mean, self.normalizer.std
        elbo = torch.tensor(float("nan"))
        t = 0
        while t < steps:
            k = min(chunk, steps - t)
            Xs, ys = zip(*(next(batches) for _ in range(k)))
            with record_function("svgp.feed"):
                Xc, yc = feed.put(np.stack(Xs),
                                  (np.stack(ys) - mu_y) / std_y)
            for i in range(k):
                elbo = self._step(opt, Xc[i], yc[i], n_total, _rho(t + i))
            if log_every and (t // chunk) % max(log_every // chunk, 1) == 0:
                if metrics_logger is not None:
                    metrics_logger.log(t, elbo=float(elbo))
                if messages:
                    print(f"step {t}: minibatch ELBO {float(elbo):.2f}")
            t += k
        self._objective = float(-elbo)
        self._cache = None
        return self

    # --- posterior --------------------------------------------------------
    def _mS(self):
        return _svgp.q_from_natural(self.qstate)

    def log_likelihood(self) -> np.ndarray:
        """The ELBO over the held training data as [[value]]."""
        m, S = self._mS()
        with torch.no_grad():
            val = float(_svgp.svgp_elbo(self, m, S, self._X, self._y,
                                        self._X.shape[0]))
        return np.array([[val]])

    def _moments(self, Xnew, include_likelihood):
        m, S = self._mS()
        return _svgp.svgp_predict(self, m, S, Xnew, include_likelihood)

    def _gradient_basis(self):
        """(kernel, Z, β = Kuu⁻¹m): dμ/dx* = Σⱼ βⱼ ∇ₓk(x, Zⱼ)."""
        m, _ = self._mS()
        return self.kernel, self.Z, _svgp._mean_grad_beta(self, m)

    def _gradients(self, Xnew, batch):
        """dμ/dx* through kernel G (C = Z, w = β) on the card for an RBF;
        the variance's gradient is zero, as in the JAX package."""
        m, _ = self._mS()
        if batch is None:
            batch = grad_batch_size(Xnew.shape[0], self.Z.shape[0])
        dmu = _svgp.svgp_predict_mean_grad_batched(self, m, Xnew, batch)
        return dmu, torch.zeros_like(dmu)

    # --- persistence ------------------------------------------------------
    def _pickle_state(self) -> dict:
        state = super()._pickle_state()
        state["qstate"] = tuple(t.cpu().numpy() for t in self.qstate)
        return state

    def _restore(self, state: dict) -> None:
        self._restore_parameters(state, ("Z",))
        self.qstate = _svgp.SVGPState(*(
            torch.as_tensor(v, device=self._X.device)
            for v in state["qstate"]))
        self._seed = 0
        self.elbo_trace_ = None


_state._MODEL_CLASSES["SVGPModel"] = SVGPModel


class SVGPRegressor(_BaseGP):
    """Estimator over :class:`SVGPModel`: the streaming counterpart of
    ``SparseGaussianProcessRegressor`` for N far beyond device memory."""

    _estimator_type = "regressor"

    def __init__(self, kernels=None, kernel_options=None, Z=None,
                 num_inducing=128, normalizer=True, noise_var=1.0,
                 batch_size=256, lr=3e-3, method="optimize", device=None):
        self.kernels = kernels
        self.kernel_options = kernel_options
        self.Z = Z
        self.num_inducing = num_inducing
        self.normalizer = normalizer
        self.noise_var = noise_var
        self.batch_size = batch_size
        self.lr = lr
        self.method = method
        self.device = device

    def _get_model(self, X, y, kernel):
        if kernel is None:
            kernel = RBF(X.shape[1])
        return SVGPModel(X, y, kernel, Z=self.Z,
                         num_inducing=self.num_inducing,
                         normalizer=self.normalizer, noise_var=self.noise_var,
                         device=self.device)

    def fit(self, X, y, **opt_kws):
        opt_kws.setdefault("batch_size", self.batch_size)
        opt_kws.setdefault("lr", self.lr)
        return super().fit(X, y, **opt_kws)

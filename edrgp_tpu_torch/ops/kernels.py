"""Covariance kernels as ``nn.Module``s.

The port of :mod:`edrgp_tpu.ops.kernels`.  Parameters are stored
unconstrained, as the JAX package's pytree stores them, and mapped through
the softplus bijector :func:`positive` inside every evaluation, so ML-II
optimizes an unconstrained vector.  A kernel's parameter names are the JAX
pytree keys (``variance``, ``lengthscale``, …); a :class:`Sum` or
:class:`Product` holds its parts in an ``nn.ModuleList`` named ``kernels``,
so the JAX tuple entry ``[i]`` is the port's ``kernels.i`` (see
:mod:`edrgp_tpu_torch.convert`).

:func:`kernel_spec` and :func:`kernel_from_spec` describe a kernel's
structure as plain Python (no tensors), for pickles that must not hold
tensors on a device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

__all__ = ["positive", "inv_positive", "sq_dist", "Kernel", "RBF",
           "Exponential", "Matern32", "Matern52", "RatQuad", "Linear",
           "Bias", "White", "Cosine", "StdPeriodic", "Poly", "MLP", "Sum",
           "Product", "make_kernel", "KERNEL_REGISTRY", "register_kernel",
           "kernel_spec", "kernel_from_spec"]

_SOFTPLUS_CUTOFF = 30.0


def positive(raw: torch.Tensor) -> torch.Tensor:
    """Softplus bijector raw → (0, inf); linear for large raw (stable)."""
    return torch.where(raw > _SOFTPLUS_CUTOFF, raw,
                       torch.log1p(torch.exp(-raw.abs())) + raw.clamp_min(0.0))


def inv_positive(value) -> torch.Tensor:
    """Inverse softplus: value → raw such that positive(raw) == value."""
    value = torch.as_tensor(value)
    return torch.where(value > _SOFTPLUS_CUTOFF, value,
                       torch.log(torch.expm1(value.clamp_min(1e-30))))


def _safe_sqrt(r2: torch.Tensor) -> torch.Tensor:
    """sqrt with a floor, so the gradient at r² = 0 (every diagonal entry
    of K(X, X)) is finite instead of inf."""
    return torch.sqrt(r2.clamp_min(1e-36))


def sq_dist(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances ‖aᵢ−bⱼ‖² via the matmul trick, clamped at
    0 as in the JAX package (so the two agree to rounding); [.., M, Q] and
    [.., N, Q] give [.., M, N] for any leading batch dimensions."""
    a2 = (A * A).sum(-1)[..., :, None]
    b2 = (B * B).sum(-1)[..., None, :]
    return (a2 + b2 - 2.0 * (A @ B.mT)).clamp_min(0.0)


def _raw(value, n: Optional[int] = None) -> nn.Parameter:
    """An unconstrained float64 parameter for a constrained default value,
    broadcast to ``[n]`` when ``n`` is given (a scalar otherwise)."""
    v = torch.as_tensor(value, dtype=torch.float64)
    if n is not None:
        v = v.broadcast_to((n,)).clone()
    return nn.Parameter(inv_positive(v))


class Kernel(nn.Module):
    """Base class: a kernel module holds its unconstrained parameters and
    evaluates ``K(X1, X2)`` and ``Kdiag(X)``.

    ``_structure()`` names the constructor arguments that fix the shapes of
    the parameters (ARD flags, the order of a polynomial); with
    ``input_dim``, ``active_dims`` and ``name`` they rebuild the kernel
    (:func:`kernel_from_spec`), and the parameters' values come from a
    ``state_dict``.
    """

    def __init__(self, input_dim: int,
                 active_dims: Optional[Sequence[int]] = None,
                 name: Optional[str] = None):
        super().__init__()
        self.input_dim = int(input_dim)
        self.active_dims = (None if active_dims is None
                            else tuple(int(d) for d in active_dims))
        self.name = name or type(self).__name__

    def _structure(self) -> dict:
        return {}

    @property
    def _n_active(self) -> int:
        return (len(self.active_dims) if self.active_dims is not None
                else self.input_dim)

    def _slice(self, X: torch.Tensor) -> torch.Tensor:
        if self.active_dims is None:
            return X
        return X[..., list(self.active_dims)]

    def K(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        """``K(X1, X2)``, so that ``torch.func.functional_call`` evaluates
        the kernel at parameters it is given."""
        return self.K(X1, X2)

    def Kdiag(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __add__(self, other: "Kernel") -> "Sum":
        parts = []
        for k in (self, other):
            parts.extend(k.kernels if isinstance(k, Sum) else [k])
        return Sum(parts)

    def __mul__(self, other: "Kernel") -> "Product":
        parts = []
        for k in (self, other):
            parts.extend(k.kernels if isinstance(k, Product) else [k])
        return Product(parts)


class _Stationary(Kernel):
    """Kernels of the scaled distance r = ‖(x−x′)/ℓ‖, with a per-dimension
    (``ARD=True``) or a single lengthscale."""

    def __init__(self, input_dim, variance=1.0, lengthscale=1.0, ARD=False,
                 active_dims=None, name=None):
        super().__init__(input_dim, active_dims, name)
        self.ARD = bool(ARD)
        self.variance = _raw(float(variance))
        self.lengthscale = _raw(lengthscale,
                                self._n_active if self.ARD else 1)

    def _structure(self):
        return {"ARD": self.ARD}

    def _r2(self, X1, X2) -> torch.Tensor:
        ls = positive(self.lengthscale)
        return sq_dist(self._slice(X1) / ls, self._slice(X2) / ls)

    def _from_r2(self, variance, r2):
        raise NotImplementedError

    def K(self, X1, X2):
        return self._from_r2(positive(self.variance), self._r2(X1, X2))

    def Kdiag(self, X):
        return positive(self.variance).expand(X.shape[0])


class RBF(_Stationary):
    """k(x,x′) = σ² exp(−r²/2).  GPy.kern.RBF equivalent."""

    def _from_r2(self, v, r2):
        return v * torch.exp(-0.5 * r2)


class Exponential(_Stationary):
    """Matérn-1/2: σ² exp(−r)."""

    def _from_r2(self, v, r2):
        return v * torch.exp(-_safe_sqrt(r2))


class Matern32(_Stationary):
    def _from_r2(self, v, r2):
        r = _safe_sqrt(r2) * math.sqrt(3.0)
        return v * (1.0 + r) * torch.exp(-r)


class Matern52(_Stationary):
    def _from_r2(self, v, r2):
        r = _safe_sqrt(r2) * math.sqrt(5.0)
        return v * (1.0 + r + r * r / 3.0) * torch.exp(-r)


class RatQuad(_Stationary):
    """σ² (1 + r²/2)^(−α), with learnable power α (GPy.kern.RatQuad)."""

    def __init__(self, input_dim, variance=1.0, lengthscale=1.0, power=2.0,
                 ARD=False, active_dims=None, name=None):
        super().__init__(input_dim, variance, lengthscale, ARD, active_dims,
                         name)
        self.power = _raw(float(power))

    def K(self, X1, X2):
        a = positive(self.power)
        return positive(self.variance) * torch.exp(
            -a * torch.log1p(0.5 * self._r2(X1, X2)))


class Cosine(_Stationary):
    """σ² cos(r)."""

    def _from_r2(self, v, r2):
        return v * torch.cos(_safe_sqrt(r2))


class StdPeriodic(Kernel):
    """σ² exp(−2 Σ_d sin²(π(x_d−x′_d)/p_d)/ℓ_d²)  (GPy.kern.StdPeriodic)."""

    def __init__(self, input_dim, variance=1.0, period=1.0, lengthscale=1.0,
                 ARD1=False, ARD2=False, active_dims=None, name=None):
        super().__init__(input_dim, active_dims, name)
        self.ARD1, self.ARD2 = bool(ARD1), bool(ARD2)
        self.variance = _raw(float(variance))
        self.period = _raw(period, self._n_active if self.ARD1 else 1)
        self.lengthscale = _raw(lengthscale,
                                self._n_active if self.ARD2 else 1)

    def _structure(self):
        return {"ARD1": self.ARD1, "ARD2": self.ARD2}

    def K(self, X1, X2):
        p, ls = positive(self.period), positive(self.lengthscale)
        diff = self._slice(X1)[:, None, :] - self._slice(X2)[None, :, :]
        s = torch.sin(math.pi * diff / p) / ls
        return positive(self.variance) * torch.exp(-2.0 * (s * s).sum(-1))

    def Kdiag(self, X):
        return positive(self.variance).expand(X.shape[0])


class Linear(Kernel):
    """k(x,x′) = Σ_d σ_d² x_d x′_d (per-dim variances when ARD)."""

    def __init__(self, input_dim, variances=1.0, ARD=False, active_dims=None,
                 name=None):
        super().__init__(input_dim, active_dims, name)
        self.ARD = bool(ARD)
        self.variances = _raw(variances, self._n_active if self.ARD else 1)

    def _structure(self):
        return {"ARD": self.ARD}

    def K(self, X1, X2):
        v = positive(self.variances)
        return (self._slice(X1) * v) @ self._slice(X2).T

    def Kdiag(self, X):
        X = self._slice(X)
        return (X * X * positive(self.variances)).sum(-1)


class Bias(Kernel):
    """Constant kernel σ²."""

    def __init__(self, input_dim, variance=1.0, active_dims=None, name=None):
        super().__init__(input_dim, active_dims, name)
        self.variance = _raw(float(variance))

    def K(self, X1, X2):
        return positive(self.variance).expand(X1.shape[0], X2.shape[0])

    def Kdiag(self, X):
        return positive(self.variance).expand(X.shape[0])


class White(Kernel):
    """White noise: σ² I on matching sets, 0 cross-covariance (GPy
    semantics).  The sets match only when ``X1 is X2``: a different set of
    the same shape gets zeros."""

    def __init__(self, input_dim, variance=1.0, active_dims=None, name=None):
        super().__init__(input_dim, active_dims, name)
        self.variance = _raw(float(variance))

    def K(self, X1, X2):
        if X1 is X2:
            eye = torch.eye(X1.shape[0], dtype=X1.dtype, device=X1.device)
            return positive(self.variance) * eye
        return X1.new_zeros((X1.shape[0], X2.shape[0]))

    def Kdiag(self, X):
        return positive(self.variance).expand(X.shape[0])


class Poly(Kernel):
    """σ² (w·(x·x′) + b)^order  (GPy.kern.Poly: scale weight + bias)."""

    def __init__(self, input_dim, variance=1.0, scale=1.0, bias=1.0, order=3,
                 active_dims=None, name=None):
        super().__init__(input_dim, active_dims, name)
        self.order = int(order)
        self.variance = _raw(float(variance))
        self.scale = _raw(float(scale))
        self.bias = _raw(float(bias))

    def _structure(self):
        return {"order": self.order}

    def K(self, X1, X2):
        s, b = positive(self.scale), positive(self.bias)
        dot = self._slice(X1) @ self._slice(X2).T
        return positive(self.variance) * (s * dot + b) ** self.order

    def Kdiag(self, X):
        s, b = positive(self.scale), positive(self.bias)
        X = self._slice(X)
        return positive(self.variance) * (s * (X * X).sum(-1) + b) ** self.order


class MLP(Kernel):
    """Arcsine (neural-network) kernel, GPy.kern.MLP."""

    def __init__(self, input_dim, variance=1.0, weight_variance=1.0,
                 bias_variance=1.0, ARD=False, active_dims=None, name=None):
        super().__init__(input_dim, active_dims, name)
        self.ARD = bool(ARD)
        self.variance = _raw(float(variance))
        self.weight_variance = _raw(weight_variance,
                                    self._n_active if self.ARD else 1)
        self.bias_variance = _raw(float(bias_variance))

    def _structure(self):
        return {"ARD": self.ARD}

    def K(self, X1, X2):
        w, b = positive(self.weight_variance), positive(self.bias_variance)
        X1, X2 = self._slice(X1), self._slice(X2)
        prod = (X1 * w) @ X2.T + b
        d1 = (X1 * X1 * w).sum(-1) + b
        d2 = (X2 * X2 * w).sum(-1) + b
        denom = torch.sqrt((1.0 + 2.0 * d1)[:, None]
                           * (1.0 + 2.0 * d2)[None, :])
        t = (2.0 * prod / denom).clamp(-1.0, 1.0)
        return positive(self.variance) * (2.0 / math.pi) * torch.arcsin(t)

    def Kdiag(self, X):
        w, b = positive(self.weight_variance), positive(self.bias_variance)
        X = self._slice(X)
        d = (X * X * w).sum(-1) + b
        t = (2.0 * d / (1.0 + 2.0 * d)).clamp(-1.0, 1.0)
        return positive(self.variance) * (2.0 / math.pi) * torch.arcsin(t)


class _Combination(Kernel):
    """A kernel made of parts, held as ``kernels.0``, ``kernels.1``, …"""

    def __init__(self, kernels: Sequence[Kernel]):
        kernels = list(kernels)
        super().__init__(kernels[0].input_dim, None, type(self).__name__)
        self.kernels = nn.ModuleList(kernels)


class Sum(_Combination):
    """Sum of kernels (the reference's ``np.sum([kern(**opt) ...])``)."""

    def K(self, X1, X2):
        return sum(k.K(X1, X2) for k in self.kernels)

    def Kdiag(self, X):
        return sum(k.Kdiag(X) for k in self.kernels)


class Product(_Combination):
    """Product of kernels (GPy's ``*`` composition)."""

    def K(self, X1, X2):
        return math.prod(k.K(X1, X2) for k in self.kernels)

    def Kdiag(self, X):
        return math.prod(k.Kdiag(X) for k in self.kernels)


KERNEL_REGISTRY = {
    "RBF": RBF,
    "ExpQuad": RBF,  # GPy alias
    "Exponential": Exponential,
    "Matern12": Exponential,
    "OU": Exponential,
    "Matern32": Matern32,
    "Matern52": Matern52,
    "RatQuad": RatQuad,
    "Linear": Linear,
    "Bias": Bias,
    "White": White,
    "Cosine": Cosine,
    "StdPeriodic": StdPeriodic,
    "PeriodicExponential": StdPeriodic,
    "Poly": Poly,
    "MLP": MLP,
}


def register_kernel(name: str, cls) -> None:
    KERNEL_REGISTRY[name] = cls


def make_kernel(kernels, kernel_options, input_dim: int) -> Kernel:
    """Kernel name(s) + options → Kernel, as ``edrgp_tpu.ops.kernels.
    make_kernel`` does.

    * ``None`` → default RBF.
    * a Kernel instance → passthrough.
    * a name or a list of names → registry lookup, options merged with
      ``input_dim``; several are summed.
    """
    if kernels is None:
        return RBF(input_dim)
    if isinstance(kernels, Kernel):
        return kernels
    if isinstance(kernels, str):
        kernels = [kernels]
    if isinstance(kernel_options, dict):
        kernel_options = [kernel_options]
    if kernel_options is None:
        kernel_options = [{}] * len(kernels)
    if len(kernel_options) != len(kernels):
        raise ValueError(
            "kernel_options must have the same length as kernels "
            f"({len(kernel_options)} != {len(kernels)})")
    parts = []
    for name, opts in zip(kernels, kernel_options):
        if name not in KERNEL_REGISTRY:
            raise ValueError(
                f"Unknown kernel {name!r}; known: {sorted(KERNEL_REGISTRY)}")
        opts = dict(opts)
        opts["input_dim"] = input_dim
        parts.append(KERNEL_REGISTRY[name](**opts))
    return parts[0] if len(parts) == 1 else Sum(parts)


def kernel_spec(kernel: Kernel) -> dict:
    """A kernel's structure as plain Python: its class name and the
    constructor arguments that fix its parameters' shapes; the parts of a
    :class:`Sum` or :class:`Product` nest."""
    if isinstance(kernel, _Combination):
        return {"class": type(kernel).__name__,
                "parts": [kernel_spec(k) for k in kernel.kernels]}
    return {"class": type(kernel).__name__,
            "args": {"input_dim": kernel.input_dim,
                     "active_dims": kernel.active_dims, "name": kernel.name,
                     **kernel._structure()}}


def kernel_from_spec(spec: dict) -> Kernel:
    """The kernel :func:`kernel_spec` describes, with default parameter
    values (load a ``state_dict`` for the fitted ones)."""
    classes = {cls.__name__: cls
               for cls in (*KERNEL_REGISTRY.values(), Sum, Product)}
    cls = classes.get(spec["class"])
    if cls is None:
        raise ValueError(f"Unknown kernel class {spec['class']!r}; "
                         f"known: {sorted(classes)}")
    if "parts" in spec:
        return cls([kernel_from_spec(p) for p in spec["parts"]])
    return cls(**spec["args"])

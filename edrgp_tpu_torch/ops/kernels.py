"""Covariance kernels as ``nn.Module``s (main-path subset: RBF).

The port of :mod:`edrgp_tpu.ops.kernels`.  Parameters are stored
unconstrained, as the JAX package's pytree stores them, and mapped through
the softplus bijector :func:`positive` inside every evaluation, so ML-II
optimizes an unconstrained vector.  A kernel's parameter names are the JAX
pytree keys (``variance``, ``lengthscale``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

__all__ = ["positive", "inv_positive", "sq_dist", "Kernel", "RBF",
           "make_kernel", "KERNEL_REGISTRY"]

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


def sq_dist(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances ‖aᵢ−bⱼ‖² via the matmul trick, clamped at
    0 as in the JAX package (so the two agree to rounding)."""
    a2 = (A * A).sum(-1)[:, None]
    b2 = (B * B).sum(-1)[None, :]
    return (a2 + b2 - 2.0 * (A @ B.T)).clamp_min(0.0)


class Kernel(nn.Module):
    """Base class: a kernel module holds its unconstrained parameters and
    evaluates ``K(X1, X2)`` and ``Kdiag(X)``."""

    def __init__(self, input_dim: int,
                 active_dims: Optional[Sequence[int]] = None,
                 name: Optional[str] = None):
        super().__init__()
        self.input_dim = int(input_dim)
        self.active_dims = (None if active_dims is None
                            else tuple(int(d) for d in active_dims))
        self.name = name or type(self).__name__

    def _slice(self, X: torch.Tensor) -> torch.Tensor:
        if self.active_dims is None:
            return X
        return X[..., list(self.active_dims)]

    def K(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def Kdiag(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class _Stationary(Kernel):
    """Kernels of the scaled distance r = ‖(x−x′)/ℓ‖, with a per-dimension
    (``ARD=True``) or a single lengthscale."""

    def __init__(self, input_dim, variance=1.0, lengthscale=1.0, ARD=False,
                 active_dims=None, name=None):
        super().__init__(input_dim, active_dims, name)
        self.ARD = bool(ARD)
        n_ls = self._n_active if self.ARD else 1
        ls = torch.as_tensor(lengthscale, dtype=torch.float64)
        self.variance = nn.Parameter(
            inv_positive(torch.tensor(float(variance), dtype=torch.float64)))
        self.lengthscale = nn.Parameter(
            inv_positive(ls.broadcast_to((n_ls,)).clone()))

    @property
    def _n_active(self) -> int:
        return (len(self.active_dims) if self.active_dims is not None
                else self.input_dim)

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


KERNEL_REGISTRY = {"RBF": RBF}


def make_kernel(kernels, kernel_options, input_dim: int) -> Kernel:
    """Kernel name(s) + options → Kernel, as ``edrgp_tpu.ops.kernels.
    make_kernel`` does; the port knows only ``"RBF"`` so far.

    * ``None`` → default RBF.
    * a Kernel instance → passthrough.
    * a name or a one-element list of names → registry lookup, options
      merged with ``input_dim``.
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
    if len(kernels) != 1:
        raise NotImplementedError("sums of kernels are not ported yet")
    name, opts = kernels[0], dict(kernel_options[0])
    if name not in KERNEL_REGISTRY:
        raise ValueError(
            f"Unknown kernel {name!r}; known: {sorted(KERNEL_REGISTRY)}")
    opts["input_dim"] = input_dim
    return KERNEL_REGISTRY[name](**opts)

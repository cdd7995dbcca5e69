"""Titsias sparse GP regression (collapsed variational bound).

The port of :mod:`edrgp_tpu.ops.sgpr`.  The functions take ``gp``: a module
holding ``kernel``, the unconstrained ``raw_noise`` and the inducing inputs
``Z`` [M, Q], such as :class:`~edrgp_tpu_torch.models.state.SGPRModel`.
y is expected already normalized.  The N×N kernel matrix is never formed.

The bound's Kuf and Kuu need gradients in the kernel's parameters and in
Z, so they are built by ``kernel.K`` under autograd, as the JAX package
builds them outside any Pallas kernel.  Prediction serves K(Z, X*) through
kernel K (:func:`~edrgp_tpu_torch.ops.exact._cross_K`) and dμ/dx* through
kernel G (:func:`~edrgp_tpu_torch.ops.exact.grad_rows` with C = Z, w = β)
when the kernel is a plain RBF in float32 on the card.
"""

from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from .exact import (_cross_K, grad_batch_size, grad_rows, map_batched,
                    noise_variance)
from .linalg import safe_cholesky, tri_solve

__all__ = ["elbo", "sgpr_posterior", "predict", "predict_mean_grad",
           "predict_mean_grad_batched", "predict_var_grad"]

_LOG2PI = math.log(2.0 * math.pi)


def _common(gp, X, y):
    """Shared factorizations: L=chol(Kuu), A=L⁻¹Kuf/σ, LB=chol(I+AAᵀ), c.

    The forward's parts run under ``torch.profiler`` labels
    (``sgpr.kernel``, ``sgpr.cholesky``, ``sgpr.trsm``, ``sgpr.AAT``), so a
    trace splits the bound by part; outside a profiler they cost a few µs.
    """
    Z = gp.Z
    sigma2 = noise_variance(gp)
    sigma = torch.sqrt(sigma2)
    with record_function("sgpr.kernel"):
        Kuu = gp.kernel.K(Z, Z)
        Kuf = gp.kernel.K(Z, X)                                   # [M, N]
    with record_function("sgpr.cholesky"):
        L = safe_cholesky(Kuu)
    with record_function("sgpr.trsm"):
        A = tri_solve(L, Kuf, lower=True) / sigma                 # [M, N]
    with record_function("sgpr.AAT"):
        B = A @ A.T + torch.eye(Z.shape[0], dtype=A.dtype, device=A.device)
    with record_function("sgpr.cholesky"):
        LB = safe_cholesky(B)
    Ay = A @ y[:, None] / sigma                                   # [M, 1]
    c = tri_solve(LB, Ay, lower=True)                             # [M, 1]
    return L, A, LB, c, sigma2


def elbo(gp, X, y) -> torch.Tensor:
    """Titsias collapsed lower bound on log p(y) (scalar, to MAXIMIZE)."""
    n = X.shape[0]
    L, A, LB, c, sigma2 = _common(gp, X, y)
    kdiag = gp.kernel.Kdiag(X)
    return (-0.5 * n * _LOG2PI
            - torch.log(LB.diagonal()).sum()
            - 0.5 * n * torch.log(sigma2)
            - 0.5 * (y @ y) / sigma2
            + 0.5 * (c * c).sum()
            - 0.5 * kdiag.sum() / sigma2        # -1/(2σ²) tr(Kff)
            + 0.5 * (A * A).sum())              # +1/(2σ²) tr(Qff)


@torch.no_grad()
def sgpr_posterior(gp, X, y):
    """Posterior cache for prediction: (L, LB, β) with μ(x*) = k(x*,Z) β."""
    L, _, LB, c, _ = _common(gp, X, y)
    tmp = tri_solve(LB, c, lower=True, trans=True)                # LB⁻ᵀ c
    beta = tri_solve(L, tmp, lower=True, trans=True)[:, 0]        # L⁻ᵀ LB⁻ᵀ c
    return L, LB, beta


@torch.no_grad()
def predict(gp, cache, Xnew, include_likelihood: bool = True):
    """Sparse posterior mean [S] and variance [S] at Xnew (GPy predict
    semantics: the likelihood noise is added to the variance by default)."""
    L, LB, beta = cache
    Kus = _cross_K(gp.kernel, gp.Z, Xnew)                         # [M, S]
    mean = Kus.T @ beta
    tmp1 = tri_solve(L, Kus, lower=True)                          # L⁻¹ Kus
    tmp2 = tri_solve(LB, tmp1, lower=True)                        # LB⁻¹ L⁻¹ Kus
    kss = gp.kernel.Kdiag(Xnew)
    var = kss - (tmp1 * tmp1).sum(0) + (tmp2 * tmp2).sum(0)
    var = var.clamp_min(1e-15)
    if include_likelihood:
        var = var + noise_variance(gp)
    return mean, var


def _var_grad(kernel, Z, L, LB, Xnew):
    """One backward of the summed variance: each row's variance depends
    only on its own input row, so the sum's gradient gives every row."""
    with torch.enable_grad():
        x = Xnew.detach().requires_grad_(True)
        t1 = tri_solve(L, kernel.K(Z.detach(), x), lower=True)
        t2 = tri_solve(LB, t1, lower=True)
        var = kernel.Kdiag(x) - (t1 * t1).sum(0) + (t2 * t2).sum(0)
        (g,) = torch.autograd.grad(var.sum(), x)
    return g


def predict_var_grad(gp, cache, Xnew, batch: int | None = None):
    """d var/dx* for the sparse posterior: [S, Q] (GPy sparse
    ``predictive_gradients(X)[1]``), in ``batch``-row chunks so that one
    [M, batch] block is live at a time (None bounds it to 2²⁶ entries)."""
    L, LB, _ = cache
    Z = gp.Z
    if batch is None:
        batch = grad_batch_size(Xnew.shape[0], Z.shape[0])
    return map_batched(lambda c: _var_grad(gp.kernel, Z, L, LB, c), Xnew,
                       batch)


def predict_mean_grad(gp, beta, Xnew, batch: int | None = None):
    """dμ/dx* for the sparse posterior: [S, Q] (same contract as exact);
    the generic path runs in ``batch``-row chunks (None bounds the
    [batch, M] block to 2²⁶ entries)."""
    if batch is None:
        batch = grad_batch_size(Xnew.shape[0], gp.Z.shape[0])
    return grad_rows(gp.kernel, gp.Z, beta, Xnew, batch)


def predict_mean_grad_batched(gp, beta, Xnew, batch: int = 8192):
    """dμ/dx* for the sparse posterior in ``batch``-row chunks, each through
    :func:`predict_mean_grad`'s route (kernel G on the card for a plain
    RBF), so that one chunk's working set is live at a time."""
    return map_batched(
        lambda c: grad_rows(gp.kernel, gp.Z, beta, c, batch), Xnew, batch)

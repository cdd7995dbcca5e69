"""Sparse GP regression with uncertain (Gaussian) inputs.

The port of :mod:`edrgp_tpu.ops.uncertain`: each training input is a
Gaussian x_n ~ N(mu_n, diag(S_n)) with fixed moments, and the Titsias bound
is evaluated with the kernel expectations ("psi statistics", Titsias &
Lawrence 2010) in place of the Kuf products:

    psi0      = sum_n E[k(x_n, x_n)]
    Psi1[n,m] = E[k(x_n, z_m)]
    Psi2[m,k] = sum_n E[k(x_n, z_m) k(x_n, z_k)]

Closed forms exist for the RBF (ARD) kernel; other kernels raise.  The
functions take ``gp`` as :mod:`edrgp_tpu_torch.ops.sgpr` does.

Psi2's terms are [N, M, M]: 2.6e10 of them at N=100,000, M=512.  The JAX
package forms them at once; here the sum over n runs over chunks of rows
whose [rows, M, M] terms hold about 2²⁶ entries
(:func:`~edrgp_tpu_torch.ops.exact.grad_batch_size`'s budget), each
chunk's terms recomputed in the backward instead of kept
(``torch.utils.checkpoint``), so the live memory stays at one chunk's in
both directions.  It is the same sum, so the same function.

The bound and the posterior are evaluated in float64 whatever the model's
working type (:func:`_common` casts its inputs; the bound and the cache come
back in the working type, and gradients reach float32 parameters through
the casts).  In float32, L⁻¹Psi2L⁻ᵀ amplifies the rounding of Kuu and Psi2
until B = I + L⁻¹Psi2L⁻ᵀ/σ² loses about half of its smallest eigenvalue
(which is at least 1): at N=3,000, M=128 the float32 bound of either
package can stand far from the float64 one, and a float32 fit climbs that
error (ROADMAP Queue 3).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .exact import grad_batch_size, noise_variance
from .kernels import RBF, Kernel, positive
from .linalg import safe_cholesky, tri_solve

__all__ = ["psi_statistics", "elbo", "posterior"]

_LOG2PI = math.log(2.0 * math.pi)


def _check_kernel(kernel: Kernel) -> None:
    if not isinstance(kernel, RBF):
        raise NotImplementedError(
            f"X_variance (uncertain inputs) requires an RBF kernel with "
            f"closed-form psi statistics; got {type(kernel).__name__}")


def _psi2_sum(mu, S, l2, Z):
    """Σ_n exp(logw2_n − a_n + 2b_nmk − c_nmk) over the rows of one chunk
    (the JAX package's terms, ``edrgp_tpu/ops/uncertain.py:72-85``)."""
    D2 = 2.0 * S + l2[None, :]                                    # [n, Q]
    logw2 = -0.5 * torch.log1p(2.0 * S / l2[None, :]).sum(1)      # [n]
    zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])                  # [M, M, Q]
    a = (mu * mu / D2).sum(1)                                     # [n]
    b = torch.einsum("nq,mkq->nmk", mu / D2, zbar)                # [n, M, M]
    c = torch.einsum("nq,mkq->nmk", 1.0 / D2, zbar * zbar)        # [n, M, M]
    expo = logw2[:, None, None] - a[:, None, None] + 2.0 * b - c
    return torch.exp(expo).sum(0)


def psi_statistics(kernel: Kernel, mu, S, Z, chunk: int | None = None):
    """(psi0, Psi1 [N,M], Psi2 [M,M]) for x_n ~ N(mu_n, diag(S_n)).

    Closed-form for RBF/ARD; ``NotImplementedError`` otherwise (matching
    GPy, where psi statistics exist only for a few kernels).  Psi2 is
    summed over ``chunk`` rows at a time (None: about 2²⁶ terms a chunk).
    """
    _check_kernel(kernel)
    mu, S, Z = kernel._slice(mu), kernel._slice(S), kernel._slice(Z)
    v = positive(kernel.variance)
    ls = positive(kernel.lengthscale)
    l2 = (ls * ls).expand(mu.shape[1])
    n = mu.shape[0]

    # psi0: E[k(x,x)] = sigma_f^2 for RBF regardless of input noise.
    psi0 = n * v

    # Psi1[n,m] = v * prod_d (l2/(S+l2))^1/2 * exp(-1/2 (mu-z)^2/(S+l2))
    D1 = S + l2[None, :]                                          # [N, Q]
    logw1 = -0.5 * torch.log1p(S / l2[None, :]).sum(1)            # [N]
    quad1 = ((mu * mu / D1).sum(1)[:, None]
             - 2.0 * (mu / D1) @ Z.T
             + (1.0 / D1) @ (Z * Z).T)                            # [N, M]
    Psi1 = v * torch.exp(logw1[:, None] - 0.5 * quad1)

    # Psi2[m,k] = sum_n v^2 * prod_d (l2/(2S+l2))^1/2
    #             * exp(-(z_m-z_k)^2/(4 l2) - (mu - zbar_mk)^2/(2S+l2))
    zl = Z / torch.sqrt(4.0 * l2)[None, :]
    zz = (zl * zl).sum(1)
    dist = zz[:, None] + zz[None, :] - 2.0 * zl @ zl.T            # [M, M]
    if chunk is None:
        chunk = grad_batch_size(n, Z.shape[0] ** 2)
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (mu, S, l2, Z))
    total = 0.0
    for start in range(0, n, chunk):
        part = (mu[start:start + chunk], S[start:start + chunk], l2, Z)
        total = total + (checkpoint(_psi2_sum, *part, use_reentrant=False)
                         if keep else _psi2_sum(*part))
    Psi2 = (v * v) * torch.exp(-dist) * total
    return psi0, Psi1, Psi2


def _common(gp, X, y, X_variance):
    """Factorizations shared by bound and posterior.

    L = chol(Kuu); B = I + L⁻¹ Psi2 L⁻ᵀ/σ²; c = LB⁻¹ L⁻¹ Psi1ᵀy/σ².
    With X_variance → 0 this reduces exactly to the certain-input SGPR
    factorization (Psi1 → Kfu, Psi2 → Kuf Kfu).
    """
    X, y, X_variance = (t.to(torch.float64) for t in (X, y, X_variance))
    Z = gp.Z.to(torch.float64)
    sigma2 = noise_variance(gp).to(torch.float64)
    psi0, Psi1, Psi2 = psi_statistics(gp.kernel, X, X_variance, Z)
    L = safe_cholesky(gp.kernel.K(Z, Z))
    LiP2 = tri_solve(L, Psi2, lower=True)                         # L⁻¹ Psi2
    A2 = tri_solve(L, LiP2.T, lower=True).T / sigma2              # L⁻¹Psi2L⁻ᵀ/σ²
    A2 = 0.5 * (A2 + A2.T)
    B = A2 + torch.eye(Z.shape[0], dtype=A2.dtype, device=A2.device)
    LB = safe_cholesky(B)
    Py = tri_solve(L, Psi1.T @ y[:, None], lower=True) / sigma2
    c = tri_solve(LB, Py, lower=True)                             # [M, 1]
    return L, LB, c, A2, psi0, sigma2


def elbo(gp, X, y, X_variance) -> torch.Tensor:
    """Collapsed uncertain-input lower bound on log p(y) (to MAXIMIZE)."""
    n = X.shape[0]
    L, LB, c, A2, psi0, sigma2 = _common(gp, X, y, X_variance)
    y64 = y.to(torch.float64)
    bound = (-0.5 * n * (_LOG2PI + torch.log(sigma2))
             - torch.log(LB.diagonal()).sum()
             - 0.5 * (y64 @ y64) / sigma2
             + 0.5 * (c * c).sum()
             - 0.5 * psi0 / sigma2
             + 0.5 * torch.trace(A2))
    return bound.to(X.dtype)


@torch.no_grad()
def posterior(gp, X, y, X_variance):
    """Posterior cache (L, LB, β) for :mod:`~edrgp_tpu_torch.ops.sgpr`'s
    ``predict`` and gradients at deterministic test inputs:
    μ(x*) = k(x*, Z) β."""
    L, LB, c, _, _, _ = _common(gp, X, y, X_variance)
    tmp = tri_solve(LB, c, lower=True, trans=True)
    beta = tri_solve(L, tmp, lower=True, trans=True)[:, 0]
    return tuple(t.to(X.dtype) for t in (L, LB, beta))

"""Variational GP classification (binary; probit or logit link).

The port of :mod:`edrgp_tpu.ops.vgp`.  The non-Gaussian likelihood is
handled with a whitened Gaussian variational posterior optimized jointly
with the kernel hyperparameters:

Full model:   q(f) = N(L_K m̃, L_K S̃ S̃ᵀ L_Kᵀ)   (whitened, f = L_K ε)
Sparse model: q(u) whitened over M inducing points, f|u collapsed.

ELBO = Σᵢ E_q[log g(yᵢ fᵢ)] − KL(q‖p), with the expectation computed by
20-point Gauss–Hermite quadrature.

The functions take ``gp``: a module holding ``kernel`` and the variational
parameters ``m`` [n] and ``tril`` [n(n+1)/2] (and the inducing inputs ``Z``
[M, Q] for the sparse model), such as
:class:`~edrgp_tpu_torch.models.cls_state.VGPClassificationModel`.  The
bounds build their kernel matrices by ``kernel.K`` under autograd, as the
JAX package builds them outside any Pallas kernel; the predictions serve
their cross-kernel through kernel K
(:func:`~edrgp_tpu_torch.ops.exact._cross_K`).  The predictions' K(C, C)
stays on ``kernel.K``: its Cholesky has no nugget, and built as the bound
builds it, it is the matrix the fit factored, at the same jitter.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .exact import _cross_K
from .linalg import safe_cholesky, tri_solve

__all__ = ["vgp_elbo", "vgp_predict_latent", "svgp_cls_elbo",
           "svgp_cls_predict_latent", "probit", "canonical_likelihood",
           "bernoulli_predict_proba", "init_variational_params",
           "mean_weights"]

_GH_POINTS = 20
# Probabilists' Gauss–Hermite nodes and weights, normalized to sum to 1.
_GH_X, _gh_w = np.polynomial.hermite_e.hermegauss(_GH_POINTS)
_GH_W = _gh_w / math.sqrt(2 * math.pi)


def _gh(like: torch.Tensor):
    return (torch.as_tensor(_GH_X, dtype=like.dtype, device=like.device),
            torch.as_tensor(_GH_W, dtype=like.dtype, device=like.device))


def probit(z):
    return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))


def _log_probit(z):
    """Numerically stable log Φ(z)."""
    return torch.special.log_ndtr(z)


def _log_sigmoid(z):
    """Numerically stable log σ(z) = −softplus(−z)."""
    return -torch.logaddexp(torch.zeros_like(z), -z)


# Bernoulli link functions, keyed by canonical name: ``loglik(y·f)`` is the
# per-point log-likelihood of a ±1 label given latent f.
_LOG_LIKS = {"probit": _log_probit, "logit": _log_sigmoid}

_LIK_ALIASES = {
    "probit": "probit", "bernoulli": "probit", "bernoulli_probit": "probit",
    "logit": "logit", "logistic": "logit", "bernoulli_logit": "logit",
}


def canonical_likelihood(name) -> str:
    """Normalize a user-facing likelihood spec to 'probit' / 'logit'."""
    if name is None:
        return "probit"
    key = str(name).lower()
    if key not in _LIK_ALIASES:
        raise ValueError(
            f"unknown likelihood {name!r}; expected one of "
            f"{sorted(_LIK_ALIASES)} (or None for the Bernoulli-probit "
            "default)")
    return _LIK_ALIASES[key]


def _expected_log_lik(y_sign, mu, var, lik: str = "probit"):
    """Σᵢ E_{N(f;μᵢ,σᵢ²)}[log g(yᵢ f)] by Gauss–Hermite quadrature."""
    gx, gw = _gh(mu)
    sd = torch.sqrt(var.clamp_min(1e-12))
    f = mu[:, None] + sd[:, None] * gx[None, :]          # [N, 20] nodes
    ll = _LOG_LIKS[lik](y_sign[:, None] * f)
    return (ll @ gw).sum()


@torch.no_grad()
def bernoulli_predict_proba(mean, var, lik: str = "probit"):
    """P(y=1 | x*) from the latent Gaussian marginal N(mean, var).

    Probit: the exact integral Φ(μ/√(1+σ²)).  Logit: Gauss–Hermite
    quadrature of E[σ(f)]."""
    if lik == "probit":
        return probit(mean / torch.sqrt(1.0 + var))
    gx, gw = _gh(mean)
    sd = torch.sqrt(var.clamp_min(1e-12))
    f = mean[:, None] + sd[:, None] * gx[None, :]
    return torch.sigmoid(f) @ gw


def _unpack_tril(flat, n: int):
    """Flat vector → lower-triangular matrix with a softplus-positive
    diagonal.  ``flat`` is in row-major ``tril_indices`` order, the JAX
    package's, so a JAX ``tril`` vector maps entry for entry."""
    rows, cols = torch.tril_indices(n, n, device=flat.device)
    L = flat.new_zeros((n, n)).index_put((rows, cols), flat)
    diag = L.diagonal()
    pos = torch.logaddexp(diag, torch.zeros_like(diag))    # softplus
    return L - torch.diag(diag) + torch.diag(pos)


def init_variational_params(n: int, dtype, device=None):
    """Whitened q: m̃ = 0, S̃ = I (raw ``tril`` with inv-softplus(1) on the
    diagonal, which sits at positions k(k+3)/2 in row-major order)."""
    tril = np.zeros(n * (n + 1) // 2)
    tril[[k * (k + 1) // 2 + k for k in range(n)]] = math.log(math.e - 1.0)
    return (torch.zeros(n, dtype=dtype, device=device),
            torch.as_tensor(tril, dtype=dtype, device=device))


def _kl_whitened(m, S):
    """KL(N(m, SSᵀ) ‖ N(0, I)) for lower-triangular S."""
    diag = S.diagonal()
    return 0.5 * ((S * S).sum() + m @ m - S.shape[0]
                  - 2.0 * torch.log(diag.abs() + 1e-30).sum())


def vgp_elbo(gp, X, y_sign, lik: str = "probit") -> torch.Tensor:
    """Full (non-sparse) whitened VGP classification ELBO."""
    n = X.shape[0]
    LK = safe_cholesky(gp.kernel.K(X, X))
    S = _unpack_tril(gp.tril, n)
    mu = LK @ gp.m
    A = LK @ S                   # marginal variances of q(f): rows of L_K S
    var = (A * A).sum(1)
    return _expected_log_lik(y_sign, mu, var, lik) - _kl_whitened(gp.m, S)


def _whitened_moments(gp, LK, C, Xnew, m):
    """Latent mean/var at Xnew for a whitened q over the points C."""
    Ks = _cross_K(gp.kernel, C, Xnew)                    # [n, S]
    A = tri_solve(LK, Ks, lower=True)                     # L⁻¹ Ks
    mean = A.T @ m
    SA = _unpack_tril(gp.tril, C.shape[0]).T @ A
    var = gp.kernel.Kdiag(Xnew) - (A * A).sum(0) + (SA * SA).sum(0)
    return mean, var.clamp_min(1e-12)


@torch.no_grad()
def vgp_predict_latent(gp, X, Xnew):
    """Predictive latent mean/var at Xnew under the whitened q."""
    LK = safe_cholesky(gp.kernel.K(X, X))
    return _whitened_moments(gp, LK, X, Xnew, gp.m)


def svgp_cls_elbo(gp, X, y_sign, lik: str = "probit") -> torch.Tensor:
    """Sparse whitened VGP classification ELBO over ``gp.Z``."""
    Z = gp.Z
    LK = safe_cholesky(gp.kernel.K(Z, Z))
    A = tri_solve(LK, gp.kernel.K(Z, X), lower=True)     # [M, N] = L⁻¹Kuf
    S = _unpack_tril(gp.tril, Z.shape[0])
    mu = A.T @ gp.m
    SA = S.T @ A
    var = gp.kernel.Kdiag(X) - (A * A).sum(0) + (SA * SA).sum(0)
    return (_expected_log_lik(y_sign, mu, var.clamp_min(1e-12), lik)
            - _kl_whitened(gp.m, S))


@torch.no_grad()
def svgp_cls_predict_latent(gp, Xnew):
    LK = safe_cholesky(gp.kernel.K(gp.Z, gp.Z))
    return _whitened_moments(gp, LK, gp.Z, Xnew, gp.m)


@torch.no_grad()
def mean_weights(gp, C):
    """w = L⁻ᵀm with L = chol(K(C, C)): the latent mean at x* is
    k(x*, C)·w, the weighted kernel sum that kernel G differentiates."""
    LK = safe_cholesky(gp.kernel.K(C, C))
    return tri_solve(LK, gp.m[:, None], lower=True, trans=True)[:, 0]

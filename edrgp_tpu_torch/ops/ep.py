"""Expectation Propagation for binary probit GP classification.

The port of :mod:`edrgp_tpu.ops.ep`: damped parallel EP (every site updated
at once from the current posterior marginals, damping 0.5), so one EP
iteration is one Cholesky of B = I + S̃^½ K S̃^½ and one triangular solve.
The JAX package runs the loop as one ``lax.while_loop``; here it is a
Python loop whose convergence check reads one scalar back to the host per
iteration, with the same tolerance (1e-5 in float32, 1e-10 in float64),
iteration limit, damping and zero start, so both packages reach the same
fixed point.

Hyperparameter gradients do not differentiate the loop: the sites are
constants of :func:`ep_energy`, whose site-local terms are computed from a
detached K, so autograd of the energy gives GPML eq. 5.27, the exact total
derivative at an EP fixed point.  Each ML-II objective evaluation
re-converges EP (:func:`ep_neg_energy_objective`).

The site loop's K(X, X) is built once per evaluation without gradients,
through kernel K (:func:`~edrgp_tpu_torch.ops.exact._cross_K`), and so is
the prediction cache's; the energy keeps autograd through ``kernel.K``;
predictions take K(X, X*) through kernel K.  The functions take ``gp``: a module holding ``kernel``.

  Σ = K − K S̃^½ B⁻¹ S̃^½ K,   μ = Σ ν̃,   w = ν̃ / √τ̃,
  log Z_EP = Σᵢ log Φ(zᵢ) − ½ log|B| − ½ wᵀB⁻¹w
           + Σᵢ [ ½ log(1 + τ̃ᵢ σ₋ᵢ²) + (ν̃ᵢ − τ̃ᵢ μ₋ᵢ)² / (2 τ̃ᵢ (1+τ̃ᵢσ₋ᵢ²)) ].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .exact import _cross_K
from .linalg import safe_cholesky, tri_solve

__all__ = ["EPState", "ep_site_loop", "ep_fit", "ep_energy",
           "ep_neg_energy_objective", "ep_posterior_cache",
           "ep_predict_latent"]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class EPState(NamedTuple):
    nu: torch.Tensor      # site natural means ν̃ [N]
    tau: torch.Tensor     # site natural precisions τ̃ [N] (≥ 0)
    iters: int            # EP iterations executed
    delta: float          # final max site change


def _site_tiny(dtype) -> float:
    return 1e-12 if dtype == torch.float64 else 1e-8


def _default_tol(dtype) -> float:
    return 1e-10 if dtype == torch.float64 else 1e-5


def _b_cholesky(K, srt):
    """L = chol(I + S̃^½ K S̃^½)."""
    B = (srt[:, None] * K) * srt[None, :]
    B = B + torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    return safe_cholesky(B)


def _posterior_marginals(K, nu, tau):
    """Diag/mean of Σ = K − K S̃^½ B⁻¹ S̃^½ K and μ = Σ ν̃, and L."""
    srt = torch.sqrt(tau)
    L = _b_cholesky(K, srt)
    V = tri_solve(L, srt[:, None] * K, lower=True)        # L⁻¹S̃^½K
    sigma2 = K.diagonal() - (V * V).sum(0)
    mu = K @ nu - V.T @ (V @ nu)
    return mu, sigma2.clamp_min(_site_tiny(K.dtype)), L


def _probit_moments(y_sign, mu_cav, var_cav):
    """Tilted moments for the probit likelihood (GPML eqs. 3.58), with
    N(z)/Φ(z) formed in log space so the far tail stays finite."""
    denom = torch.sqrt(1.0 + var_cav)
    z = y_sign * mu_cav / denom
    ratio = torch.exp(-0.5 * z * z - _LOG_SQRT_2PI
                      - torch.special.log_ndtr(z))
    mu_hat = mu_cav + y_sign * var_cav * ratio / denom
    var_hat = var_cav - var_cav ** 2 * ratio * (z + ratio) / (1.0 + var_cav)
    return mu_hat, var_hat.clamp_min(_site_tiny(mu_cav.dtype))


def _cavity(mu, sigma2, nu, tau, tiny):
    tau_cav = (1.0 / sigma2 - tau).clamp_min(tiny)
    nu_cav = mu / sigma2 - nu
    return nu_cav / tau_cav, 1.0 / tau_cav


def _site_update(marginals, y_sign, nu, tau, d, tiny):
    """One damped parallel EP update from posterior marginals (μ, σ²)."""
    mu, sigma2 = marginals
    mu_cav, var_cav = _cavity(mu, sigma2, nu, tau, tiny)
    mu_hat, var_hat = _probit_moments(y_sign, mu_cav, var_cav)
    tau_new = (1.0 / var_hat - 1.0 / var_cav).clamp_min(0.0)
    nu_new = mu_hat / var_hat - mu_cav / var_cav
    nu_next = (1.0 - d) * nu + d * nu_new
    tau_next = (1.0 - d) * tau + d * tau_new
    delta = torch.maximum((nu_next - nu).abs().max(),
                          (tau_next - tau).abs().max())
    return nu_next, tau_next, delta


@torch.no_grad()
def run_sites(marginals_fn, y_sign, n, dtype, device, *, damping, tol,
              max_iters) -> EPState:
    """Damped parallel EP from zero sites until the largest site change is
    at most ``tol`` or ``max_iters`` iterations ran; ``marginals_fn(nu,
    tau)`` gives the posterior marginals (μ, σ²) of the sites."""
    tiny = _site_tiny(dtype)
    if tol is None:
        tol = _default_tol(dtype)
    nu = torch.zeros(n, dtype=dtype, device=device)
    tau = torch.zeros(n, dtype=dtype, device=device)
    it, delta = 0, math.inf
    while it < max_iters and delta > tol:
        nu, tau, d = _site_update(marginals_fn(nu, tau), y_sign, nu, tau,
                                  damping, tiny)
        delta = float(d)                       # the iteration's host read
        it += 1
    return EPState(nu, tau, it, delta)


def ep_site_loop(K, y_sign, *, damping: float = 0.5,
                 tol: float | None = None, max_iters: int = 100) -> EPState:
    """Run damped parallel EP to convergence at fixed K (no gradients)."""
    K = K.detach()
    return run_sites(lambda nu, tau: _posterior_marginals(K, nu, tau)[:2],
                     y_sign, K.shape[0], K.dtype, K.device, damping=damping,
                     tol=tol, max_iters=max_iters)


@torch.no_grad()
def _site_K(gp, X):
    """K(X, X) for the site loop: kernel K for a plain RBF, no gradients."""
    return _cross_K(gp.kernel, X, X)


def ep_fit(gp, X, y_sign, damping: float = 0.5,
           max_iters: int = 100) -> EPState:
    """Converged EP sites for the model's current hyperparameters."""
    return ep_site_loop(_site_K(gp, X), y_sign, damping=damping,
                        max_iters=max_iters)


def ep_energy(gp, X, y_sign, nu, tau) -> torch.Tensor:
    """EP log marginal likelihood log Z_EP (GPML eq. 3.65) at fixed sites.

    Differentiable in the kernel's parameters; the gradient is GPML eq.
    5.27 (exact at an EP fixed point) because every site-local term is
    computed without gradients and only log|B| and wᵀB⁻¹w carry them.
    """
    K = gp.kernel.K(X, X)
    tiny = _site_tiny(K.dtype)
    nu = nu.detach()
    tau = tau.detach().clamp_min(tiny)
    srt = torch.sqrt(tau)
    L = _b_cholesky(K, srt)
    v = tri_solve(L, (nu / srt)[:, None], lower=True)[:, 0]
    core = -torch.log(L.diagonal()).sum() - 0.5 * (v @ v)
    with torch.no_grad():
        mu, sigma2, _ = _posterior_marginals(K.detach(), nu, tau)
        mu_cav, var_cav = _cavity(mu, sigma2, nu, tau, tiny)
        z = y_sign * mu_cav / torch.sqrt(1.0 + var_cav)
        one_p = 1.0 + tau * var_cav
        local = (torch.special.log_ndtr(z).sum()
                 + 0.5 * torch.log(one_p).sum()
                 + 0.5 * ((nu - tau * mu_cav) ** 2 / (tau * one_p)).sum())
    return core + local


def ep_neg_energy_objective(gp, X, y_sign):
    """−log Z_EP(θ) with EP re-converged inside each evaluation: a closure
    for L-BFGS, the EP-within-ML-II alternation GPy runs."""
    def objective():
        state = ep_site_loop(_site_K(gp, X), y_sign)
        return -ep_energy(gp, X, y_sign, state.nu, state.tau)
    return objective


@torch.no_grad()
def ep_posterior_cache(gp, X, nu, tau):
    """Prediction cache (GPML eqs. 3.60-3.61): (alpha, L, srt) with
    μ* = k*ᵀ·alpha and σ*² = k** − ‖L⁻¹(srt∘k*)‖²."""
    K = _site_K(gp, X)
    tau = tau.clamp_min(_site_tiny(K.dtype))
    srt = torch.sqrt(tau)
    L = _b_cholesky(K, srt)
    # (K + S̃⁻¹)⁻¹ μ̃ = S̃^½ B⁻¹ w with w = ν̃/√τ̃
    w = (nu / srt)[:, None]
    alpha = srt * tri_solve(L, tri_solve(L, w, lower=True), lower=True,
                            trans=True)[:, 0]
    return alpha, L, srt


@torch.no_grad()
def ep_predict_latent(gp, X, cache, Xnew):
    """Latent posterior mean/var at Xnew under the EP approximation."""
    alpha, L, srt = cache
    Ks = _cross_K(gp.kernel, X, Xnew)                     # [N, S]
    mean = Ks.T @ alpha
    V = tri_solve(L, srt[:, None] * Ks, lower=True)
    var = gp.kernel.Kdiag(Xnew) - (V * V).sum(0)
    return mean, var.clamp_min(_site_tiny(mean.dtype))

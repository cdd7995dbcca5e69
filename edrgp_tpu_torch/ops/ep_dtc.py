"""EP-DTC: Expectation Propagation on the DTC (projected-process) prior.

The port of :mod:`edrgp_tpu.ops.ep_dtc`.  Whitened inducing variables
u ~ N(0, I_M); the latent at the data is the projection f = P u with
P = K_nm L_m⁻ᵀ (L_m = chol(K_mm)).  Probit sites act on the N projections,
so the posterior over u stays M-dimensional:

    Λ = I_M + Pᵀ S̃ P,   b = Pᵀ ν̃,   u | data ~ N(Λ⁻¹ b, Λ⁻¹)

and every EP sweep costs O(N M²) plus one M×M Cholesky, with the same
damped parallel scheme, tolerance and iteration limit as
:mod:`edrgp_tpu_torch.ops.ep` (a Python loop here).

The evidence is kept in its stationary arrangement

    log Z_EP = log Z_gauss(θ; sites) + Σᵢ [ log Ẑᵢ − log Gᵢ ],

so the hyperparameter gradient with every site and cavity term computed
without gradients is the exact total derivative at an EP fixed point.
The site loop's and the prediction cache's projections are built without
gradients, their K_nm through kernel K
(:func:`~edrgp_tpu_torch.ops.exact._cross_K`); the energy's through
``kernel.K`` under autograd.  The functions take ``gp``: a module
holding ``kernel`` and the inducing inputs ``Z`` [M, Q].
"""

from __future__ import annotations

import torch

from .ep import EPState, _cavity, _site_tiny, run_sites
from .exact import _cross_K
from .linalg import safe_cholesky, tri_solve

__all__ = ["ep_dtc_site_loop", "ep_dtc_fit", "ep_dtc_energy",
           "ep_dtc_neg_energy_objective", "ep_dtc_posterior_cache",
           "ep_dtc_predict_latent"]


def _projection(gp, X, cross=None):
    """P = K_nm L_m⁻ᵀ ([N, M]) and L_m; ``cross`` builds K_mn (default
    ``kernel.K``)."""
    Z = gp.Z
    Lm = safe_cholesky(gp.kernel.K(Z, Z))
    Kmn = (cross or gp.kernel.K)(Z, X)                    # [M, N]
    return tri_solve(Lm, Kmn, lower=True).T, Lm


@torch.no_grad()
def _site_projection(gp, X):
    """(P, L_m) for the site loop and the cache: no gradients, K_mn through
    kernel K."""
    return _projection(gp, X, lambda A, B: _cross_K(gp.kernel, A, B))


def _lam_cholesky(P, tau):
    M = P.shape[1]
    Lam = P.T @ (tau[:, None] * P)
    Lam = Lam + torch.eye(M, dtype=P.dtype, device=P.device)
    return safe_cholesky(Lam)


def _u_mean(LL, b):
    return tri_solve(LL, tri_solve(LL, b[:, None], lower=True), lower=True,
                     trans=True)[:, 0]


def _dtc_marginals(P, nu, tau):
    """Posterior marginals (μ, σ², L_Λ, b) of f = P u given the sites."""
    LL = _lam_cholesky(P, tau)
    b = P.T @ nu
    mu = P @ _u_mean(LL, b)
    W = tri_solve(LL, P.T, lower=True)                    # [M, N]
    sigma2 = (W * W).sum(0)
    return mu, sigma2.clamp_min(_site_tiny(P.dtype)), LL, b


def ep_dtc_site_loop(P, y_sign, *, damping: float = 0.5,
                     tol: float | None = None,
                     max_iters: int = 100) -> EPState:
    """Damped parallel EP to convergence at fixed projection P."""
    P = P.detach()
    return run_sites(lambda nu, tau: _dtc_marginals(P, nu, tau)[:2],
                     y_sign, P.shape[0], P.dtype, P.device, damping=damping,
                     tol=tol, max_iters=max_iters)


def ep_dtc_fit(gp, X, y_sign, damping: float = 0.5,
               max_iters: int = 100) -> EPState:
    """Converged EP-DTC sites for the model's current parameters."""
    return ep_dtc_site_loop(_site_projection(gp, X)[0], y_sign,
                            damping=damping, max_iters=max_iters)


def ep_dtc_energy(gp, X, y_sign, nu, tau) -> torch.Tensor:
    """EP-DTC log marginal likelihood at fixed sites (differentiable in the
    kernel's parameters and the inducing inputs ``Z``)."""
    P, _ = _projection(gp, X)
    tiny = _site_tiny(P.dtype)
    nu, tau = nu.detach(), tau.detach()
    LL = _lam_cholesky(P, tau)
    v = tri_solve(LL, (P.T @ nu)[:, None], lower=True)[:, 0]
    core = -torch.log(LL.diagonal()).sum() + 0.5 * (v @ v)
    with torch.no_grad():
        mu, sigma2, _, _ = _dtc_marginals(P.detach(), nu, tau)
        mu_cav, var_cav = _cavity(mu, sigma2, nu, tau, tiny)
        z = y_sign * mu_cav / torch.sqrt(1.0 + var_cav)
        prec_cav = 1.0 / var_cav
        # log Gᵢ = −½log(1+τ̃σ²_cav) + (μ_cav/σ²_cav+ν̃)²/(2(1/σ²_cav+τ̃))
        #          − μ_cav²/(2σ²_cav)
        log_g = (-0.5 * torch.log1p(tau * var_cav)
                 + (mu_cav * prec_cav + nu) ** 2 / (2.0 * (prec_cav + tau))
                 - mu_cav ** 2 * prec_cav / 2.0)
        local = (torch.special.log_ndtr(z) - log_g).sum()
    return core + local


def ep_dtc_neg_energy_objective(gp, X, y_sign):
    """−log Z_EP-DTC(θ, Z) with EP re-converged inside each evaluation: a
    closure for L-BFGS."""
    def objective():
        state = ep_dtc_site_loop(_site_projection(gp, X)[0], y_sign)
        return -ep_dtc_energy(gp, X, y_sign, state.nu, state.tau)
    return objective


@torch.no_grad()
def ep_dtc_posterior_cache(gp, X, nu, tau):
    """(u_mean, L_Λ, L_m): the whitened posterior over the inducing
    values."""
    P, Lm = _site_projection(gp, X)
    _, _, LL, b = _dtc_marginals(P, nu, tau)
    return _u_mean(LL, b), LL, Lm


@torch.no_grad()
def ep_dtc_predict_latent(gp, cache, Xnew):
    """Latent posterior mean/var at Xnew under the DTC approximation:
    μ* = p*ᵀ Λ⁻¹ b,  σ*² = k** − ‖p*‖² + ‖L_Λ⁻¹ p*‖²."""
    u_mean, LL, Lm = cache
    Pstar = tri_solve(Lm, _cross_K(gp.kernel, gp.Z, Xnew), lower=True)
    mean = Pstar.T @ u_mean
    W = tri_solve(LL, Pstar, lower=True)
    var = (gp.kernel.Kdiag(Xnew) - (Pstar * Pstar).sum(0)
           + (W * W).sum(0))
    return mean, var.clamp_min(_site_tiny(mean.dtype))


@torch.no_grad()
def mean_weights(cache):
    """w = L_m⁻ᵀ·u_mean: the latent mean at x* is k(x*, Z)·w."""
    u_mean, _, Lm = cache
    return tri_solve(Lm, u_mean[:, None], lower=True, trans=True)[:, 0]

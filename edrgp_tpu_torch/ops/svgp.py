"""Minibatch stochastic variational GP regression (SVGP) with natural
gradients.

The port of :mod:`edrgp_tpu.ops.svgp` (Hensman et al. 2013 SVI):

  * q(u) = N(m, S) over M inducing outputs, held in its natural parameters
    θ₁ = S⁻¹m, θ₂ = −½S⁻¹, so the variational update is a convex
    combination: one natural-gradient step with ρ=1 on the full batch is
    the exact optimum.
  * Hyperparameters (kernel, noise, Z) take Adam steps on the minibatch
    ELBO with q held fixed: m and S enter :func:`svgp_elbo` as constants.

The functions take ``gp``: a module holding ``kernel``, the unconstrained
``raw_noise`` and the inducing inputs ``Z`` [M, Q], such as
:class:`~edrgp_tpu_torch.models.svgp.SVGPModel`; y is expected already
normalized.  The ELBO's Kub needs gradients in the kernel's parameters and
in Z, so it is built by ``kernel.K`` under autograd, as the JAX package
builds it outside any Pallas kernel; the ELBO, its backward and the
natural-gradient step are cuBLAS/cuSOLVER and elementwise PyTorch.
Prediction serves K(Z, X*) through kernel K
(:func:`~edrgp_tpu_torch.ops.exact._cross_K`) and dμ/dx* through kernel G
(:func:`~edrgp_tpu_torch.ops.exact.grad_rows` with C = Z, w = β = Kuu⁻¹m)
when the kernel is a plain RBF in float32 on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .exact import _cross_K, grad_batch_size, grad_rows, noise_variance
from .linalg import safe_cholesky, tri_solve

__all__ = ["SVGPState", "init_svgp_state", "q_from_natural", "svgp_elbo",
           "elbo_terms", "natural_gradient_update", "natural_gradient_stats",
           "natural_gradient_step", "svgp_predict",
           "svgp_predict_mean_grad", "svgp_predict_mean_grad_batched"]

_LOG2PI = math.log(2.0 * math.pi)


class SVGPState(NamedTuple):
    """Variational posterior in natural parameters."""
    theta1: torch.Tensor  # [M]    = S⁻¹ m
    theta2: torch.Tensor  # [M, M] = −½ S⁻¹ (symmetric negative definite)


def init_svgp_state(M: int, dtype=torch.float64, device=None) -> SVGPState:
    """q(u) = N(0, I): θ₁ = 0, θ₂ = −½I."""
    return SVGPState(
        theta1=torch.zeros(M, dtype=dtype, device=device),
        theta2=-0.5 * torch.eye(M, dtype=dtype, device=device))


def _eye_like(A: torch.Tensor) -> torch.Tensor:
    return torch.eye(A.shape[0], dtype=A.dtype, device=A.device)


@torch.no_grad()
def q_from_natural(state: SVGPState):
    """(m, S) from natural params.  S = −½ θ₂⁻¹ via Cholesky of −θ₂; both
    are constants of the hyperparameter step (no graph)."""
    neg2 = -(state.theta2 + state.theta2.T)  # = S⁻¹, symmetrized
    L = safe_cholesky(neg2)
    Linv = tri_solve(L, _eye_like(L), lower=True)
    S = Linv.T @ Linv                         # (S⁻¹)⁻¹
    m = S @ state.theta1
    return m, S


def _latent_moments(gp, m, S, Xb, Kub=None):
    """Posterior moments of f at a minibatch: μ [B], var [B] + Kuu chol.
    ``Kub`` [M, B] is built by ``kernel.K`` unless given."""
    Z = gp.Z
    Luu = safe_cholesky(gp.kernel.K(Z, Z))
    if Kub is None:
        Kub = gp.kernel.K(Z, Xb)                                  # [M, B]
    A = tri_solve(Luu, Kub, lower=True)                           # Luu⁻¹ Kub
    Lm = tri_solve(Luu, m[:, None], lower=True)[:, 0]             # Luu⁻¹ m
    mu = A.T @ Lm
    P = tri_solve(Luu, S, lower=True)                             # Luu⁻¹ S
    P = tri_solve(Luu, P.T, lower=True)                           # Luu⁻¹SLuu⁻ᵀ
    kdiag = gp.kernel.Kdiag(Xb)
    var = kdiag - (A * A).sum(0) + (A * (P @ A)).sum(0)
    return mu, var.clamp_min(1e-12), Luu


def _kl(m, S, Luu):
    """KL(N(m,S) ‖ N(0,Kuu)) given chol(Kuu)."""
    M = m.shape[0]
    Lim = tri_solve(Luu, m[:, None], lower=True)[:, 0]
    LiS = tri_solve(Luu, S, lower=True)
    LiSLi = tri_solve(Luu, LiS.T, lower=True)
    logdet_Kuu = 2.0 * torch.log(Luu.diagonal()).sum()
    logdet_S = 2.0 * torch.log(safe_cholesky(S).diagonal()).sum()
    # the diagonal's sum, not torch.trace: trace's backward reads its
    # gradient to the host (index_fill_ with a tensor value)
    return 0.5 * (LiSLi.diagonal().sum() + Lim @ Lim - M + logdet_Kuu
                  - logdet_S)


def svgp_elbo(gp, m, S, Xb, yb, n_total) -> torch.Tensor:
    """Minibatch estimate of the SVGP evidence lower bound (scalar)."""
    sigma2 = noise_variance(gp)
    mu, var, Luu = _latent_moments(gp, m, S, Xb)
    B = Xb.shape[0]
    quad = (yb - mu) ** 2 + var
    exp_ll = -0.5 * (B * (_LOG2PI + torch.log(sigma2)) + quad.sum() / sigma2)
    return (n_total / B) * exp_ll - _kl(m, S, Luu)


def elbo_terms(gp, m, S, Xb, yb):
    """Per-shard sufficient statistics of the expected log-likelihood:
    (count, Σ quad), additive across data shards, so a sum of these plus one
    local KL reconstitutes the global ELBO."""
    mu, var, _ = _latent_moments(gp, m, S, Xb)
    quad = ((yb - mu) ** 2 + var).sum()
    return torch.tensor(Xb.shape[0], dtype=mu.dtype, device=mu.device), quad


@torch.no_grad()
def natural_gradient_stats(gp, Xb, yb):
    """(Kuu⁻¹, t₁ = Kuu⁻¹Kub·y_b, t₂ = Kuu⁻¹Kub·KbuKuu⁻¹) of a minibatch:
    t₁ and t₂ are sums over the batch's rows, so a batch split over ranks
    sums them (:func:`edrgp_tpu_torch.parallel.make_sharded_svgp_step`).
    Kuu⁻¹ is formed explicitly, as the JAX package forms it."""
    Z = gp.Z
    Luu = safe_cholesky(gp.kernel.K(Z, Z))
    A = tri_solve(Luu, gp.kernel.K(Z, Xb), lower=True)            # [M, B]
    A = tri_solve(Luu, A, lower=True, trans=True)                 # Kuu⁻¹ Kub
    Minv = tri_solve(Luu, _eye_like(Luu), lower=True)
    return Minv.T @ Minv, A @ yb, A @ A.T


@torch.no_grad()
def natural_gradient_step(gp, state: SVGPState, Kuu_inv, t1, t2, scale,
                          rho) -> SVGPState:
    """θ ← (1−ρ)θ + ρθ̂ from the batch statistics of
    :func:`natural_gradient_stats`, ``scale`` = N/B."""
    sigma2 = noise_variance(gp)
    t1_hat = (scale / sigma2) * t1
    t2_hat = -0.5 * (Kuu_inv + (scale / sigma2) * t2)
    return SVGPState(
        theta1=(1.0 - rho) * state.theta1 + rho * t1_hat,
        theta2=(1.0 - rho) * state.theta2 + rho * t2_hat)


def natural_gradient_update(gp, state: SVGPState, Xb, yb, n_total,
                            rho) -> SVGPState:
    """One stochastic natural-gradient step on q(u) (Hensman 2013, eq. 12).

    With a Gaussian likelihood the expected natural parameters of the
    optimum are closed-form on the batch:
      θ̂₁ = (N/B)/σ² · Kuu⁻¹ Kub y_b
      θ̂₂ = −½ (Kuu⁻¹ + (N/B)/σ² · Kuu⁻¹ Kub Kbu Kuu⁻¹)
    and the step is θ ← (1−ρ)θ + ρθ̂ (stays in the valid cone).
    """
    Kuu_inv, t1, t2 = natural_gradient_stats(gp, Xb, yb)
    return natural_gradient_step(gp, state, Kuu_inv, t1, t2,
                                 n_total / Xb.shape[0], rho)


@torch.no_grad()
def svgp_predict(gp, m, S, Xnew, include_likelihood: bool = True):
    """Posterior mean/variance at Xnew under q(u)=N(m,S); K(Z, X*) through
    kernel K when it serves the kernel."""
    Kus = _cross_K(gp.kernel, gp.Z, Xnew)
    mu, var, _ = _latent_moments(gp, m, S, Xnew, Kub=Kus)
    if include_likelihood:
        var = var + noise_variance(gp)
    return mu, var


@torch.no_grad()
def _mean_grad_beta(gp, m):
    """β = Kuu⁻¹ m, the test-point-independent weights of dμ/dx*."""
    Luu = safe_cholesky(gp.kernel.K(gp.Z, gp.Z))
    beta = tri_solve(Luu, m[:, None], lower=True)
    return tri_solve(Luu, beta, lower=True, trans=True)[:, 0]


def svgp_predict_mean_grad(gp, m, Xnew):
    """dμ/dx*: [S, Q].  μ(x*) = k(x*,Z) Kuu⁻¹ m, the exact and SGPR
    pattern; the generic path bounds its [rows, M] block to 2²⁶ entries."""
    return svgp_predict_mean_grad_batched(
        gp, m, Xnew, grad_batch_size(Xnew.shape[0], gp.Z.shape[0]))


def svgp_predict_mean_grad_batched(gp, m, Xnew, batch: int = 8192):
    """dμ/dx*, the generic path in ``batch``-row chunks (β is computed once);
    on the card one G launch over every row for a float32 RBF."""
    return grad_rows(gp.kernel, gp.Z, _mean_grad_beta(gp, m), Xnew, batch)

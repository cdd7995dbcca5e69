"""Plain reference of the stochastic variational GP a configuration fits
(``"reference": "svgp"``), written from Hensman, Fusi & Lawrence, "Gaussian
Processes for Big Data" (UAI 2013, arXiv:1309.6835), in float64.

q(u) = N(m, S) over the M inducing outputs u = f(Z) is held in its natural
parameters θ₁ = S⁻¹m, θ₂ = −½S⁻¹.  With Kuu = k(Z, Z), Kub = k(Z, X_b) and
A = Kuu⁻¹Kub, the minibatch evidence lower bound of B rows out of N is

    ELBO = (N/B) Σᵢ E_q[log N(yᵢ | fᵢ, σₙ²)] − KL(q(u) ‖ N(0, Kuu)),
    E_q[log N(yᵢ | fᵢ, σₙ²)] = −½ log 2πσₙ² − ((yᵢ − μᵢ)² + vᵢ) / 2σₙ²,
    μ = Aᵀm,  vᵢ = kᵢᵢ − (KbuKuu⁻¹Kub)ᵢᵢ + (AᵀSA)ᵢᵢ,
    KL = ½(tr(Kuu⁻¹S) + mᵀKuu⁻¹m − M + log|Kuu| − log|S|),

with m and S constants of the hyperparameters' gradient (taken by
autograd).  The natural-gradient step of q(u) at step size ρ is closed-form
for a Gaussian likelihood (the paper's eq. 12):

    θ̂₁ = (N/B) σₙ⁻² A y_b,  θ̂₂ = −½(Kuu⁻¹ + (N/B) σₙ⁻² A Aᵀ),
    θ ← (1 − ρ)θ + ρθ̂.

The hyperparameters take one Adam step on ∂(−ELBO) (Kingma & Ba 2015,
arXiv:1412.6980, Algorithm 1) from the optimizer's moments before it:

    m ← β₁m + (1 − β₁)g,  v ← β₂v + (1 − β₂)g²,  t ← t + 1,
    p ← p − lr·(m / (1 − β₁ᵗ)) / (√(v / (1 − β₂ᵗ)) + ε).

The prediction at x* is μ* = k*u Kuu⁻¹ m, v* = k** − k*u Kuu⁻¹ku* +
k*u Kuu⁻¹ S Kuu⁻¹ ku* (+ σₙ² with the likelihood), and dμ*/dx* =
Σⱼ βⱼ ∇ₓk(x*, Zⱼ) with β = Kuu⁻¹m (``gp.mean_grad`` with C = Z, w = β).

The kernel, the softplus map of the unconstrained parameters, the jitter
ladder and :class:`gp.Precision` (the control: float32 with TF32 matmuls)
are ``gp.py``'s.  Parameters arrive as {name: array} under the fitted
model's names (``kernel.variance``, ``kernel.lengthscale``, ``raw_noise``,
``Z``).  A factor of Kuu takes the ``jitter`` it is given; with ``climb``
it climbs the ladder from there, as the control's own float32 factor
needs.  It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .gp import FLOAT64, LOG2PI, Precision, cholesky, hyper, rbf, softplus

# Full float32 products on the card wherever the reference runs in float32;
# the control turns TF32 on for its own block only.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _tri(L, B, trans: bool = False):
    """L⁻¹B for lower L (L⁻ᵀB with ``trans``)."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, B, upper=True)
    return torch.linalg.solve_triangular(L, B, upper=False)


def q_moments(theta1, theta2, prec: Precision = FLOAT64,
              climb: bool = False):
    """(m, S, log|S|) of q(u) from its natural parameters (constants):
    S⁻¹ = −2θ₂ (symmetrized) is factored, S = L⁻ᵀL⁻¹, m = Sθ₁."""
    theta1, theta2 = theta1.detach(), theta2.detach()
    L, _ = cholesky(-(theta2 + theta2.mT), 0.0, climb)
    Li = _tri(L, torch.eye(L.shape[0], dtype=L.dtype, device=L.device))
    S = prec.mm(Li.mT, Li)
    return (prec.mm(S, theta1[:, None])[:, 0], S,
            -2.0 * torch.log(L.diagonal()).sum())


def kuu(params, prec: Precision = FLOAT64):
    """Kuu = k(Z, Z) (no jitter)."""
    var, ls, _ = hyper(params, prec, params["Z"].device)
    return rbf(params["Z"], params["Z"], ls, var, prec)


def elbo(params, theta1, theta2, Xb, yb, n_total, jitter: float = 0.0,
         prec: Precision = FLOAT64, climb: bool = False):
    """The minibatch ELBO (scalar, on the graph of ``params``)."""
    var, ls, noise = hyper(params, prec, Xb.device)
    Z = params["Z"]
    m, S, logdet_S = q_moments(theta1, theta2, prec, climb)
    L, _ = cholesky(kuu(params, prec), jitter, climb)
    A = _tri(L, rbf(Z, Xb, ls, var, prec))              # Luu⁻¹Kub
    Lm = _tri(L, m[:, None])[:, 0]                      # Luu⁻¹m
    LSL = _tri(L, _tri(L, S).mT)                        # Luu⁻¹SLuu⁻ᵀ
    mu = prec.mm(A.mT, Lm[:, None])[:, 0]
    v = var - (A * A).sum(0) + (A * prec.mm(LSL, A)).sum(0)
    B = Xb.shape[0]
    exp_ll = -0.5 * (B * (LOG2PI + torch.log(noise))
                     + ((yb - mu) ** 2 + v).sum() / noise)
    kl = 0.5 * (torch.trace(LSL) + Lm @ Lm - Z.shape[0]
                + 2.0 * torch.log(L.diagonal()).sum() - logdet_S)
    return (n_total / B) * exp_ll - kl


@torch.no_grad()
def natural_step(params, theta1, theta2, Xb, yb, n_total, rho,
                 jitter: float = 0.0, prec: Precision = FLOAT64,
                 climb: bool = False):
    """(θ₁, θ₂) after one natural-gradient step of size ρ on the batch, at
    the hyperparameters ``params``."""
    var, ls, noise = hyper(params, prec, Xb.device)
    Z = params["Z"]
    L, _ = cholesky(kuu(params, prec), jitter, climb)
    Li = _tri(L, torch.eye(L.shape[0], dtype=L.dtype, device=L.device))
    Kinv = prec.mm(Li.mT, Li)
    A = _tri(L, _tri(L, rbf(Z, Xb, ls, var, prec)), trans=True)  # Kuu⁻¹Kub
    scale = (n_total / Xb.shape[0]) / noise
    t1 = scale * prec.mm(A, yb[:, None])[:, 0]
    t2 = -0.5 * (Kinv + scale * prec.mm(A, A.mT))
    return (1.0 - rho) * theta1 + rho * t1, (1.0 - rho) * theta2 + rho * t2


@torch.no_grad()
def adam_step(grads, moments, lr: float, betas, eps: float):
    """{name: (Δp, m, v, t)} of one Adam step: the change of each
    parameter, its moments and step count after it.  ``grads`` are
    {name: ∂(−ELBO)}; ``moments`` {name: (m, v, t)} before the step (zeros
    and t = 0 before the first)."""
    b1, b2 = betas
    out = {}
    for name, g in grads.items():
        m, v, t = moments[name]
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        t = t + 1
        step = (lr / (1.0 - b1 ** t)) * m / (
            torch.sqrt(v / (1.0 - b2 ** t)) + eps)
        out[name] = (-step, m, v, t)
    return out


@torch.no_grad()
def predict(params, theta1, theta2, Xs, jitter: float = 0.0,
            prec: Precision = FLOAT64, climb: bool = False,
            likelihood: bool = True):
    """(μ*, v*) at the rows Xs on the model's (normalized) scale."""
    var, ls, noise = hyper(params, prec, Xs.device)
    m, S, _ = q_moments(theta1, theta2, prec, climb)
    L, _ = cholesky(kuu(params, prec), jitter, climb)
    A = _tri(L, rbf(params["Z"], Xs, ls, var, prec))    # Luu⁻¹Kus
    Lm = _tri(L, m[:, None])[:, 0]
    LSL = _tri(L, _tri(L, S).mT)
    mu = prec.mm(A.mT, Lm[:, None])[:, 0]
    v = var - (A * A).sum(0) + (A * prec.mm(LSL, A)).sum(0)
    return mu, v + noise if likelihood else v


@torch.no_grad()
def beta(params, theta1, theta2, jitter: float = 0.0,
         prec: Precision = FLOAT64, climb: bool = False):
    """β = Kuu⁻¹m, the weights of μ(x) = Σⱼ βⱼ k(x, Zⱼ)."""
    m, _, _ = q_moments(theta1, theta2, prec, climb)
    L, _ = cholesky(kuu(params, prec), jitter, climb)
    return _tri(L, _tri(L, m[:, None]), trans=True)[:, 0]


def mean_diag(raw) -> float:
    """Mean diagonal of Kuu (σ²), which scales the ladder's rungs."""
    return float(softplus(torch.as_tensor(np.asarray(
        raw["kernel.variance"], dtype=np.float64))))


def rmse(mean: np.ndarray, f: np.ndarray) -> float:
    """Root mean square of the mean's error against the noise-free f."""
    return math.sqrt(float(np.mean((np.asarray(mean, np.float64)
                                    - np.asarray(f, np.float64)) ** 2)))

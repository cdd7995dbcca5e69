"""Exact GP regression math: NLML, posterior prediction, predictive gradients.

The port of :mod:`edrgp_tpu.ops.exact`.  Where the JAX functions take
``(kernel, params)``, these take ``gp``: a module holding ``kernel`` (a
:class:`~edrgp_tpu_torch.ops.kernels.Kernel`) and the unconstrained
``raw_noise``, such as :class:`~edrgp_tpu_torch.models.state.ExactGPModel`.
y is expected already normalized.

A plain full-dimension RBF kernel runs through the three kernels of
:mod:`edrgp_tpu_torch.ops.cuda.rbf` (float32 on the card; on the CPU their
plain versions, in any dtype).  Any other kernel, or float64 on the card,
takes the generic autograd path, as ``edrgp_tpu/ops/exact.py:257`` does.

:func:`nlml_chains` and :func:`posterior_chains` take a batch of flat
hyperparameter vectors θ [C, D] (the samplers' chains, the Bayesian
regressor's posterior samples), laid out as ``jax.flatten_util.ravel_pytree``
lays out the JAX package's ``{"kernel": …, "raw_noise": …}``
(:func:`theta_layout`), so one sample vector means the same hyperparameters
in both packages.
"""

from __future__ import annotations

import math

import torch
from torch.func import functional_call

from .cuda.rbf import rbf_grad_mu, rbf_kernel_matrix, rbf_nlml_adjoint
from .kernels import RBF, Kernel, positive
from .linalg import (cho_solve, jitter_ladder, logdet_and_quad,
                     safe_cholesky, tri_solve)

__all__ = [
    "nlml", "posterior", "predict", "predict_full_cov", "posterior_samples_f",
    "predict_mean_grad", "predict_var_grad",
    "predict_mean_grad_batched", "predict_var_grad_batched", "map_batched",
    "grad_batch_size", "weighted_kernel_grad", "grad_rows",
    "noise_variance", "noisy_K", "RBFKy", "theta_layout", "flatten_theta",
    "unflatten_theta", "nlml_chains", "posterior_chains",
]

_LOG2PI = math.log(2.0 * math.pi)


def noise_variance(gp) -> torch.Tensor:
    return positive(gp.raw_noise)


def _fused(kernel: Kernel, X: torch.Tensor) -> bool:
    """Whether the RBF kernels serve this kernel and input: a plain
    full-dimension RBF, in float32 on the card or any dtype on the CPU."""
    return (type(kernel) is RBF and kernel.active_dims is None
            and (X.device.type == "cpu" or X.dtype == torch.float32))


def _scaled_rbf(kernel: RBF, Q: int):
    """(ℓ broadcast to [Q], σ²) in constrained space.  The broadcast happens
    here, outside any autograd.Function, so an isotropic ℓ's cotangent is
    summed by autograd."""
    return (positive(kernel.lengthscale).expand(Q),
            positive(kernel.variance))


class RBFKy(torch.autograd.Function):
    """Ky = σ²·exp(−½‖(xᵢ−xⱼ)/ℓ‖²) + diag(σₙ²) with the fused kernel
    adjoint; the noise is a scalar σₙ² or one variance per row [N] (the
    heteroscedastic NLML).  With ℓ [C, Q], σ² [C] and σₙ² [C] it builds a
    chain batch [C, N, N] on the shared X, the counterpart of ``jax.vmap``
    over chains: K and A then launch once per chain.

    The port of ``_rbf_ky_fused`` (``edrgp_tpu/ops/exact.py:64``).  The
    forward builds K with :func:`rbf_kernel_matrix`; the backward turns the
    cotangent W of Ky into (P, r) = ((W∘K)·Xs, (W∘K)·1) with
    :func:`rbf_nlml_adjoint` and then into the parameter gradients by closed
    forms, reduced per chain.  VALID ONLY FOR A SYMMETRIC W, which
    :func:`~edrgp_tpu_torch.ops.linalg.logdet_and_quad` guarantees; keep
    this private to the NLML path.
    """

    @staticmethod
    def forward(ctx, ls, var, noise, X):
        Xs = X / ls[..., None, :]
        Ky = rbf_kernel_matrix(Xs, Xs, var)
        Ky.diagonal(dim1=-2, dim2=-1).add_(
            noise if ls.ndim == 1 else noise[:, None])
        ctx.save_for_backward(ls, var, noise, X)
        return Ky

    @staticmethod
    def backward(ctx, W):
        ls, var, noise, X = ctx.saved_tensors
        chains = ls.ndim == 2
        P, r = rbf_nlml_adjoint(X.expand(*ls.shape[:-1], *X.shape)
                                if chains else X, W, ls, var)
        Xs = X / ls[..., None, :]
        dvar = r.sum(-1) / var
        # symmetric W: Σᵢⱼ Aᵢⱼ (xsᵢ − xsⱼ)² = 2Σᵢ rᵢ xsᵢ² − 2Σᵢ xsᵢ Pᵢ
        dls = 2.0 * (r[..., None] * Xs * Xs - Xs * P).sum(-2) / ls
        dnoise = W.diagonal(dim1=-2, dim2=-1)
        if noise.ndim == 0 or chains:
            dnoise = dnoise.sum(-1)
        dX = None
        if ctx.needs_input_grad[3]:
            dX = 2.0 * (P - Xs * r[:, None]) / ls
        return dls, dvar, dnoise, dX


def _Ky_generic(gp, X):
    K = gp.kernel.K(X, X)
    eye = torch.eye(X.shape[0], dtype=K.dtype, device=K.device)
    return K + noise_variance(gp) * eye


def noisy_K(kernel: Kernel, X, noise):
    """K(X, X) + diag(noise) for a scalar noise or one per row [N]: through
    :class:`RBFKy` when the RBF kernels serve it, else by autograd through
    ``kernel.K``.  Only for the NLML path (see :class:`RBFKy`)."""
    if _fused(kernel, X):
        ls, var = _scaled_rbf(kernel, X.shape[1])
        return RBFKy.apply(ls, var, noise, X)
    return kernel.K(X, X) + torch.diag(noise.expand(X.shape[0]))


def _Ky(gp, X):
    """K(X, X) + σₙ²I (see :func:`noisy_K`)."""
    return noisy_K(gp.kernel, X, noise_variance(gp))


def _cross_K(kernel: Kernel, X1, X2):
    if _fused(kernel, X1):
        ls, var = _scaled_rbf(kernel, X1.shape[1])
        return rbf_kernel_matrix(X1 / ls, X2 / ls, var)
    return kernel.K(X1, X2)


def nlml(gp, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Negative log marginal likelihood; y shape [N].

    Reverse mode goes through :func:`logdet_and_quad`'s trace-form adjoint
    and, for the RBF kernel, :class:`RBFKy`'s fused backward.
    """
    n = X.shape[0]
    logdet, quad = logdet_and_quad(_Ky(gp, X), y)
    return 0.5 * (n * _LOG2PI + logdet + quad)


@torch.no_grad()
def posterior(gp, X, y):
    """Posterior cache (L, α): L = chol(K + σ²I), α = (K+σ²I)⁻¹ y."""
    L = safe_cholesky(_Ky(gp, X))
    alpha = cho_solve(L, y[:, None])[:, 0]
    return L, alpha


@torch.no_grad()
def predict(gp, X, cache, Xnew, include_likelihood: bool = True):
    """Posterior mean [M] and variance [M] at Xnew; the likelihood noise is
    added to the variance by default (GPy's ``predict``)."""
    L, alpha = cache
    Ks = _cross_K(gp.kernel, X, Xnew)                  # [N, M]
    mean = Ks.T @ alpha
    v = tri_solve(L, Ks, lower=True)
    kss = gp.kernel.Kdiag(Xnew)
    var = (kss - (v * v).sum(0)).clamp_min(1e-15)
    if include_likelihood:
        var = var + noise_variance(gp)
    return mean, var


@torch.no_grad()
def predict_full_cov(gp, X, cache, Xnew):
    """Posterior mean [M] and FULL covariance [M, M] at Xnew (latent, no
    noise); the cross-kernels through kernel K when it serves the
    kernel."""
    L, alpha = cache
    Ks = _cross_K(gp.kernel, X, Xnew)
    mean = Ks.T @ alpha
    v = tri_solve(L, Ks, lower=True)
    cov = _cross_K(gp.kernel, Xnew, Xnew) - v.T @ v
    return mean, cov


@torch.no_grad()
def posterior_samples_f(gp, X, cache, Xnew, size: int = 10,
                        generator: torch.Generator | None = None):
    """``size`` joint samples of the latent function at Xnew: [size, M],
    mean + z·Lcᵀ with z ~ N(0, I) drawn from ``generator`` and Lc the
    covariance's Cholesky factor (the jitter ladder's)."""
    mean, cov = predict_full_cov(gp, X, cache, Xnew)
    Lc = safe_cholesky(cov)
    z = torch.randn((size, Xnew.shape[0]), generator=generator,
                    dtype=mean.dtype, device=mean.device)
    return mean[None, :] + z @ Lc.T


def map_batched(fn, Xnew: torch.Tensor, batch: int):
    """Apply a row-batched ``fn([b, Q]) -> [b, ...]`` over Xnew in chunks of
    ``batch`` rows, so one [batch, N] block is live at a time."""
    if Xnew.shape[0] <= batch:
        return fn(Xnew)
    return torch.cat([fn(c) for c in Xnew.split(batch)])


def grad_batch_size(M: int, N: int, budget_elems: int = 1 << 26) -> int:
    """Chunk size bounding the [batch, N] block to ~``budget_elems``
    (256 MiB at f32), quantized to a power of two."""
    if M * max(N, 1) <= budget_elems:
        return M
    b = max(budget_elems // max(N, 1), 256)
    return 1 << (b.bit_length() - 1)


def weighted_kernel_grad(kernel: Kernel, C, w, Xnew):
    """∇ₓ Σᵢ wᵢ k(x, cᵢ) at each row of Xnew, by autograd; each output row
    depends only on its own input row, so one backward of the sum gives all
    rows at once."""
    with torch.enable_grad():
        x = Xnew.detach().requires_grad_(True)
        s = (kernel.K(x, C) @ w.detach()).sum()
        (g,) = torch.autograd.grad(s, x)
    return g


def grad_rows(kernel: Kernel, C, w, Xrows, batch: int):
    """Weighted kernel gradient at Xrows: :func:`rbf_grad_mu` when the RBF
    kernels serve the kernel, else ``batch``-row-chunked autograd."""
    if _fused(kernel, Xrows) and C.dtype == Xrows.dtype:
        with torch.no_grad():
            ls, var = _scaled_rbf(kernel, Xrows.shape[1])
            return rbf_grad_mu(Xrows, C, w, ls, var)
    return map_batched(lambda c: weighted_kernel_grad(kernel, C, w, c),
                       Xrows, batch)


def predict_mean_grad(gp, X, alpha, Xnew):
    """dμ/dx* at each test point: [M, Q] (GPy
    ``predictive_gradients(X)[0][:, :, 0]``)."""
    batch = grad_batch_size(Xnew.shape[0], X.shape[0])
    return grad_rows(gp.kernel, X, alpha, Xnew, batch)


def predict_mean_grad_batched(gp, X, alpha, Xnew, batch: int = 4096):
    """dμ/dx* with the generic path chunked in ``batch`` rows."""
    return grad_rows(gp.kernel, X, alpha, Xnew, batch)


def _var_grad(kernel: Kernel, X, L, Xnew):
    with torch.enable_grad():
        x = Xnew.detach().requires_grad_(True)
        v = tri_solve(L, kernel.K(X, x), lower=True)       # [N, b]
        var = kernel.Kdiag(x) - (v * v).sum(0)
        (g,) = torch.autograd.grad(var.sum(), x)
    return g


def predict_var_grad(gp, X, cache, Xnew):
    """d var/dx* at each test point: [M, Q] (GPy predictive_gradients[1])."""
    return _var_grad(gp.kernel, X, cache[0], Xnew)


def predict_var_grad_batched(gp, X, cache, Xnew, batch: int = 4096):
    """d var/dx* in ``batch``-row chunks (see :func:`map_batched`)."""
    L = cache[0]
    return map_batched(lambda c: _var_grad(gp.kernel, X, L, c), Xnew, batch)


# ---------------------------------------------------------------------------
# A batch of flat hyperparameter vectors θ [C, D]: the samplers' chains
# ---------------------------------------------------------------------------

def _path_key(name: str):
    """Sort key of a dotted parameter path: the parts of a sum or product
    (``kernels.0``, ``kernels.1``, …) in order, names alphabetically."""
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in name.split("."))


def theta_layout(kernel: Kernel) -> list:
    """[(name, shape)] of the kernel's parameters in the order of θ:
    ``jax.flatten_util.ravel_pytree`` of ``{"kernel": …, "raw_noise": …}``
    sorts dict keys and keeps a tuple's order, so the kernel's parameters
    come first (for an RBF: lengthscale, then variance) and ``raw_noise``
    is θ's last entry."""
    return sorted(((n, p.shape) for n, p in kernel.named_parameters()),
                  key=lambda item: _path_key(item[0]))


def flatten_theta(kernel: Kernel, raw_noise) -> torch.Tensor:
    """θ [D] of the kernel's current parameters and an unconstrained noise
    (:func:`theta_layout`'s order)."""
    params = dict(kernel.named_parameters())
    parts = [params[n].detach().reshape(-1) for n, _ in theta_layout(kernel)]
    raw_noise = torch.as_tensor(raw_noise, dtype=parts[0].dtype,
                                device=parts[0].device)
    return torch.cat(parts + [raw_noise.detach().reshape(1)])


def unflatten_theta(kernel: Kernel, theta: torch.Tensor):
    """({name: [C, *shape]}, raw_noise [C]) from θ [C, D]."""
    out, at = {}, 0
    for name, shape in theta_layout(kernel):
        n = shape.numel()
        out[name] = theta[:, at:at + n].reshape(theta.shape[0], *shape)
        at += n
    if at + 1 != theta.shape[1]:
        raise ValueError(f"theta has {theta.shape[1]} entries per chain; "
                         f"the kernel and the noise take {at + 1}")
    return out, theta[:, at]


def _Ky_chains(kernel: Kernel, theta: torch.Tensor, X: torch.Tensor):
    """K(X, X) + σₙ²I for every chain of θ [C, D] → [C, N, N]: through
    :class:`RBFKy` (K per chain) when the RBF kernels serve the kernel,
    else each chain's ``kernel.K`` at its own parameters."""
    if _fused(kernel, X):      # every parameter of an RBF is positive
        params, noise = unflatten_theta(kernel, positive(theta))
        ls = params["lengthscale"].expand(theta.shape[0], X.shape[1])
        return RBFKy.apply(ls, params["variance"], noise, X)
    params, raw_noise = unflatten_theta(kernel, theta)
    noise = positive(raw_noise)
    K = torch.stack([
        functional_call(kernel, {k: v[c] for k, v in params.items()},
                        (X, X)) for c in range(theta.shape[0])])
    eye = torch.eye(X.shape[0], dtype=K.dtype, device=K.device)
    return K + noise[:, None, None] * eye


def nlml_chains(kernel: Kernel, theta: torch.Tensor, X: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """NLML [C] of each chain's θ [C, D] on the shared (X, y): the
    counterpart of ``jax.vmap(lambda q: exact.nlml(kernel, unravel(q), X,
    y))`` (``edrgp_tpu/models/bayesian.py:71-76``).  Differentiable in θ;
    each chain factors its own matrix on its own jitter ladder, and a
    chain whose matrix fails every rung gives NaN in its own entry only."""
    n = X.shape[0]
    logdet, quad = logdet_and_quad(_Ky_chains(kernel, theta, X), y)
    return 0.5 * (n * _LOG2PI + logdet + quad)


@torch.no_grad()
def posterior_chains(kernel: Kernel, theta: torch.Tensor, X, y):
    """Posterior caches (L [C, N, N], α [C, N]) of every θ of a batch: one
    batched Cholesky."""
    L = jitter_ladder(_Ky_chains(kernel, theta, X))[1]
    alpha = cho_solve(L, y.expand(L.shape[:-1])[..., None])[..., 0]
    return L, alpha

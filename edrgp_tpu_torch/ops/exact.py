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
"""

from __future__ import annotations

import math

import torch

from .cuda.rbf import rbf_grad_mu, rbf_kernel_matrix, rbf_nlml_adjoint
from .kernels import RBF, Kernel, positive
from .linalg import cho_solve, logdet_and_quad, safe_cholesky, tri_solve

__all__ = [
    "nlml", "posterior", "predict", "predict_mean_grad", "predict_var_grad",
    "predict_mean_grad_batched", "predict_var_grad_batched", "map_batched",
    "grad_batch_size", "weighted_kernel_grad", "grad_rows",
    "noise_variance", "noisy_K", "RBFKy",
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
    heteroscedastic NLML).

    The port of ``_rbf_ky_fused`` (``edrgp_tpu/ops/exact.py:64``).  The
    forward builds K with :func:`rbf_kernel_matrix`; the backward turns the
    cotangent W of Ky into (P, r) = ((W∘K)·Xs, (W∘K)·1) with
    :func:`rbf_nlml_adjoint` and then into the parameter gradients by closed
    forms.  VALID ONLY FOR A SYMMETRIC W, which
    :func:`~edrgp_tpu_torch.ops.linalg.logdet_and_quad` guarantees; keep
    this private to the NLML path.
    """

    @staticmethod
    def forward(ctx, ls, var, noise, X):
        Xs = X / ls
        Ky = rbf_kernel_matrix(Xs, Xs, var)
        Ky.diagonal().add_(noise)
        ctx.save_for_backward(ls, var, noise, X)
        return Ky

    @staticmethod
    def backward(ctx, W):
        ls, var, noise, X = ctx.saved_tensors
        P, r = rbf_nlml_adjoint(X, W, ls, var)
        Xs = X / ls
        dvar = r.sum() / var
        # symmetric W: Σᵢⱼ Aᵢⱼ (xsᵢ − xsⱼ)² = 2Σᵢ rᵢ xsᵢ² − 2Σᵢ xsᵢ Pᵢ
        dls = 2.0 * (r[:, None] * Xs * Xs - Xs * P).sum(0) / ls
        dnoise = W.diagonal()
        if noise.ndim == 0:
            dnoise = dnoise.sum()
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

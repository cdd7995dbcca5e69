"""Cholesky-centric linear algebra with escalating jitter.

The port of the parts of :mod:`edrgp_tpu.ops.linalg` the exact and sparse
GPs need.  The factorizations go to ``torch.linalg`` (cuSOLVER on the card,
LAPACK on the CPU); the hand-blocked TPU recursions of the JAX package have
no counterpart here.  Failure of a factorization is read from
``torch.linalg.cholesky_ex``'s ``info``.
"""

from __future__ import annotations

import torch

from ..config import MAX_JITTER_TRIES, base_jitter

__all__ = ["safe_cholesky", "cholesky_once", "tri_solve", "cho_solve",
           "logdet_from_chol", "logdet_and_quad", "jitter_ladder",
           "add_jitter"]


def jitter_ladder(A: torch.Tensor, jitter0: float | None = None):
    """(jitter, L): the first jitter of the ladder 0, j0, 10·j0, … (times
    max(mean diag, 1)) for which chol(A + jitter·I) succeeds, and that
    factor.  After ``MAX_JITTER_TRIES`` failed escalations jitter is None
    and L is all NaN, as the JAX package's failed factor is, so an
    objective built on it is non-finite.

    A batch [C, N, N] climbs the ladder per matrix, as ``jax.vmap`` of the
    JAX package's ladder does: only the matrices that failed escalate, each
    scaled by its own mean diagonal, and jitter is a [C] tensor, NaN (and
    that matrix's factor all NaN) where every escalation failed.  One
    matrix's failure never touches another's factor, and nothing raises."""
    if A.ndim > 2:
        return _jitter_ladder_batched(A, jitter0)
    if jitter0 is None:
        jitter0 = base_jitter(A.dtype)
    A = A.detach()
    L, info = torch.linalg.cholesky_ex(A)
    if int(info) == 0:
        return 0.0, L
    diag_mean = max(float(A.diagonal().mean()), 1.0)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    for k in range(1, MAX_JITTER_TRIES + 1):
        jitter = jitter0 * 10.0 ** (k - 1) * diag_mean
        L, info = torch.linalg.cholesky_ex(A + jitter * eye)
        if int(info) == 0:
            return jitter, L
    return None, torch.full_like(A, float("nan"))


def _jitter_ladder_batched(A: torch.Tensor, jitter0: float | None):
    """:func:`jitter_ladder` of a batch [C, N, N]: one host read per rung."""
    if jitter0 is None:
        jitter0 = base_jitter(A.dtype)
    A = A.detach()
    L, info = torch.linalg.cholesky_ex(A)
    jitter = torch.zeros(A.shape[:-2], dtype=A.dtype, device=A.device)
    failed = info != 0
    if not bool(failed.any()):
        return jitter, L
    diag_mean = A.diagonal(dim1=-2, dim2=-1).mean(-1).clamp_min(1.0)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    for k in range(1, MAX_JITTER_TRIES + 1):
        idx = failed.nonzero(as_tuple=True)
        jit = jitter0 * 10.0 ** (k - 1) * diag_mean[idx]
        L_k, info_k = torch.linalg.cholesky_ex(
            A[idx] + jit[:, None, None] * eye)
        ok = info_k == 0
        L[idx] = torch.where(ok[:, None, None], L_k, L[idx])
        jitter[idx] = torch.where(ok, jit, jitter[idx])
        failed[idx] = ~ok
        if not bool(failed.any()):
            return jitter, L
    L[failed] = float("nan")
    jitter[failed] = float("nan")
    return jitter, L


def cholesky_once(A: torch.Tensor, jitter0: float | None = None):
    """Value-only escalating-jitter Cholesky: one factorization per attempt.
    Not differentiable (the input is detached); use :func:`safe_cholesky`
    where a gradient must flow through the factor."""
    return jitter_ladder(A, jitter0)[1]


def safe_cholesky(A: torch.Tensor, jitter0: float | None = None):
    """Lower Cholesky of a PSD matrix with the jitter ladder of
    :func:`jitter_ladder`; differentiable in A when A requires grad (the
    factor is then recomputed once, with the chosen jitter, on the graph).
    When every escalation fails the factor is all NaN on the graph too, so
    the objective built on it is non-finite, as the JAX package's is, and
    L-BFGS backs off instead of the factorization raising."""
    jitter, L = jitter_ladder(A, jitter0)
    if not A.requires_grad or not torch.is_grad_enabled():
        return L
    if jitter is None:
        return L + 0.0 * A
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.cholesky(A + jitter * eye)


def add_jitter(A: torch.Tensor, jitter) -> torch.Tensor:
    """A + jitter·I over the last two axes of A [..., n, n]; ``jitter`` is
    a float or a tensor that broadcasts against [n, n] (0-d, or
    [..., 1, 1] for one jitter a matrix)."""
    n = A.shape[-1]
    return A + jitter * torch.eye(n, dtype=A.dtype, device=A.device)


def tri_solve(L: torch.Tensor, B: torch.Tensor, *, lower: bool = True,
              trans: bool = False) -> torch.Tensor:
    """Solve L X = B for triangular L (Lᵀ X = B with ``trans``)."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, B, upper=lower)
    return torch.linalg.solve_triangular(L, B, upper=not lower)


def cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) X = B given the lower Cholesky factor L."""
    return torch.cholesky_solve(B, L)


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """log|L Lᵀ| of a lower factor [N, N], or of each of a batch [C, N, N]."""
    return 2.0 * torch.log(L.diagonal(dim1=-2, dim2=-1)).sum(-1)


class LogdetAndQuad(torch.autograd.Function):
    """(log|Ky|, yᵀKy⁻¹y) with the trace-form adjoint.

    ∂log|K|/∂K = K⁻¹ and ∂(yᵀK⁻¹y)/∂K = −ααᵀ with α = K⁻¹y, so the
    backward never differentiates through the factorization.  The cotangent
    of K is symmetrized: the fused RBF adjoint downstream
    (:class:`edrgp_tpu_torch.ops.exact.RBFKy`) is valid only for a symmetric
    one.  A batch Ky [C, N, N] against one y [N] gives [C] of each, every
    matrix on its own jitter ladder; there the forward forms L⁻¹ by one
    batched triangular solve and takes α and, in the backward, K⁻¹ = L⁻ᵀL⁻¹
    from it by batched products (``chip_smoke.py``'s nuts_gp profile of 16
    chains at N=1,024 on an H100: ``torch.cholesky_inverse`` took 7.8 ms
    of the 12.9 ms of device time, the solve and products take 1.9 of
    4.6).  The batch reads the factorization's
    status once, after the whole forward is queued, and climbs the ladder
    only when a matrix failed, so the host does not wait for the card
    between the factorization and the solves.
    """

    @staticmethod
    def forward(ctx, Ky, y):
        if Ky.ndim == 2:
            L = cholesky_once(Ky)
            alpha = cho_solve(L, y[:, None])[:, 0]
            ctx.save_for_backward(L, alpha)
            return logdet_from_chol(L), y @ alpha
        # the ladder's first rung; its status is read once the rest is queued
        L, info = torch.linalg.cholesky_ex(Ky.detach())
        out = _solve_chains(L, y)
        if bool((info != 0).any()):
            out = _solve_chains(cholesky_once(Ky), y)
        Linv, alpha, logdet, quad = out
        ctx.save_for_backward(Linv, alpha)
        return logdet, quad

    @staticmethod
    def backward(ctx, g_logdet, g_quad):
        L, alpha = ctx.saved_tensors          # a batch saves L⁻¹, not L
        dK = dy = None
        if L.ndim == 2:
            if ctx.needs_input_grad[0]:
                dK = -g_quad * torch.outer(alpha, alpha)
                dK = dK + g_logdet * torch.cholesky_inverse(L)
                dK = 0.5 * (dK + dK.mT)
            if ctx.needs_input_grad[1]:
                dy = 2.0 * g_quad * alpha
            return dK, dy
        if ctx.needs_input_grad[0]:
            dK = -g_quad[:, None, None] * (alpha[:, :, None]
                                           * alpha[:, None, :])
            dK = dK + g_logdet[:, None, None] * (L.mT @ L)
            dK = 0.5 * (dK + dK.mT)
        if ctx.needs_input_grad[1]:
            dy = (2.0 * g_quad[:, None] * alpha).sum(0)
        return dK, dy


def _solve_chains(L: torch.Tensor, y: torch.Tensor):
    """(L⁻¹, α = K⁻¹y, log|K|, yᵀα) for a batch of lower factors [C, N, N]
    and one y [N]."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    alpha = (Linv.mT @ (Linv @ y[:, None]))[..., 0]
    return Linv, alpha, logdet_from_chol(L), (alpha * y).sum(-1)


def logdet_and_quad(Ky: torch.Tensor, y: torch.Tensor):
    """(log|Ky|, yᵀKy⁻¹y); see :class:`LogdetAndQuad`."""
    return LogdetAndQuad.apply(Ky, y)

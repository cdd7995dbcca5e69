"""Kernel-block-parallel exact GP: NLML value+grad sharded over a mesh
dimension.

The port of :mod:`edrgp_tpu.parallel.exact_sharded` onto
``torch.distributed``.  The N×N system is sharded by contiguous ROW SLABS
over one mesh dimension of p ranks: rank s owns rows [s·L, (s+1)·L),
L = N/p, and N % p ≠ 0 raises ``ValueError``.  Every stage is local work
plus explicit collectives on the dimension's process group:

  * K construction: each rank builds its [L, N] slab of K(X, X) + σₙ²I from
    its rows and the all-gathered X.  For a plain RBF the forward is the
    port's K kernel (``rbf_kernel_matrix`` takes rectangles); the backward
    turns the slab's cotangent W into (dℓ, dσ², dσₙ²) by closed forms in
    PyTorch (W∘K, its row and column sums, two skinny products), as the
    JAX package differentiates ``kernel.K`` outside any Pallas kernel.
    Kernel A serves only square matrices, so it does not serve the slab.
    Other kernels take autograd through ``kernel.K``.
  * Cholesky: right-looking blocked, one block column a step.  The owner
    factors its diagonal block and broadcasts it (a failed block becomes
    NaN on every rank, so every rank's line search rejects the step
    alike); each rank below forms its panel block by a triangular solve;
    the panels are all-gathered and each rank below updates its trailing
    columns with one gemm.
  * Solves and log-determinant: forward substitution (the owner solves,
    then broadcasts), back substitution (the partial products reduced to
    the owner, which solves and broadcasts), the diagonal logs summed over
    ranks.
  * Gradient: the trace-form adjoint dK = g_ld·K⁻¹ − g_q·ααᵀ as a
    ``torch.autograd.Function``.  The column slabs of L⁻¹ come from a
    distributed forward recursion (each step broadcasts one row slab of
    L); K⁻¹'s row slab s is Cₛᵀ·Cⱼ over j, with the column slabs rotated
    around the ring (``batch_isend_irecv``: rank r sends to r − 1, so
    after t hops rank s holds slab (s + t) mod p, the JAX package's
    ``ppermute`` direction).

The parameters are replicated and K's rows are disjoint, so each rank's
gradient is its slab's part and their sum is the gradient; it is summed in
rank order (:func:`~edrgp_tpu_torch.parallel.distributed.ordered_sum`), as
are the log-determinant's parts, and everything else replicated arrives by
broadcast: value and gradient have the same bits on every rank, so every
rank's L-BFGS takes the same steps and issues the same collectives.

Each rank's working set is O(N²/p).  A one-rank group runs every stage,
its collectives included, on one device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..ops.cuda.rbf import rbf_kernel_matrix
from ..ops.exact import _fused, _scaled_rbf, noise_variance
from .distributed import (all_gather_cat, broadcast_from, ordered_sum,
                          reduce_to, ring_shift)
from .mesh import axis_index, axis_size, shard_along

__all__ = ["make_sharded_nlml_value_and_grad", "sharded_nlml_value_and_grad",
           "make_sharded_nlml_objective", "shard_rows"]

_LOG2PI = math.log(2.0 * math.pi)


class _Axis(NamedTuple):
    """The mesh dimension a sharded function runs over."""
    group: object
    p: int          # ranks along it
    s: int          # this rank's position


def _axis(mesh, axis: str) -> _Axis:
    return _Axis(mesh.get_group(axis), axis_size(mesh, axis),
                 axis_index(mesh, axis))


def _distributed_cholesky(A_local: torch.Tensor, ax: _Axis) -> torch.Tensor:
    """Blocked right-looking Cholesky of a row-slab-sharded SPD matrix;
    returns this rank's [L, N] slab of the lower factor (the strict upper
    triangle zero).  Columns right of a rank's diagonal block are never
    updated: they are the upper triangle."""
    Lr, N = A_local.shape
    p, s = ax.p, ax.s
    A = A_local.clone()
    for k in range(p):
        ks = slice(k * Lr, (k + 1) * Lr)
        if s == k:
            L_kk, info = torch.linalg.cholesky_ex(A[:, ks])
            L_kk = torch.where(info == 0, L_kk, torch.nan)
        else:
            L_kk = A.new_empty(Lr, Lr)
        L_kk = broadcast_from(L_kk, k, ax.group)
        if s == k:
            panel = L_kk
        elif s > k:     # P_s = A[s, k] · L_kk⁻ᵀ
            panel = torch.linalg.solve_triangular(L_kk.mT, A[:, ks],
                                                  upper=True, left=False)
        else:
            panel = torch.zeros_like(L_kk)
        A[:, ks] = panel
        if k + 1 < p:
            panel_all = all_gather_cat(panel, ax.group)         # [N, L]
            if s > k:   # trailing update of the columns not yet final
                cols = slice((k + 1) * Lr, (s + 1) * Lr)
                A[:, cols] -= panel @ panel_all[cols].mT
    rows = s * Lr + torch.arange(Lr, device=A.device)
    cols = torch.arange(N, device=A.device)
    return torch.where(cols[None, :] <= rows[:, None], A, 0.0)


def _forward_substitute(L_local, y_local, ax: _Axis) -> torch.Tensor:
    """z = L⁻¹y from row slabs of L; z [N] on every rank."""
    Lr, N = L_local.shape
    z = L_local.new_zeros(N)
    for k in range(ax.p):
        ks = slice(k * Lr, (k + 1) * Lr)
        if ax.s == k:
            r = y_local - L_local[:, :k * Lr] @ z[:k * Lr]
            zk = torch.linalg.solve_triangular(L_local[:, ks], r[:, None],
                                               upper=False)[:, 0]
        else:
            zk = z.new_empty(Lr)
        z[ks] = broadcast_from(zk, k, ax.group)
    return z


def _backward_substitute(L_local, z, ax: _Axis) -> torch.Tensor:
    """α = L⁻ᵀz from row slabs of L; α [N] on every rank."""
    Lr, N = L_local.shape
    s = ax.s
    alpha = z.new_zeros(N)
    own = alpha[s * Lr:(s + 1) * Lr]          # a view: α's slab s as set
    for i in reversed(range(ax.p)):
        is_ = slice(i * Lr, (i + 1) * Lr)
        t = reduce_to(L_local[:, is_].mT @ own, i, ax.group)
        if s == i:
            ai = torch.linalg.solve_triangular(
                L_local[:, is_].mT, (z[is_] - t)[:, None], upper=True)[:, 0]
        else:
            ai = z.new_empty(Lr)
        alpha[is_] = broadcast_from(ai, i, ax.group)
    return alpha


def _distributed_tri_inv_cols(L_local, ax: _Axis) -> torch.Tensor:
    """Column slab s of L⁻¹ ([N, L]) from row slabs of L, by the forward
    recursion L⁻¹[i, s] = −L_ii⁻¹ · L[i, s:i] · L⁻¹[s:i, s]; step i
    broadcasts row slab i of L up to its diagonal block."""
    Lr, N = L_local.shape
    s = ax.s
    C = L_local.new_zeros(N, Lr)
    for i in range(ax.p):
        width = (i + 1) * Lr
        Lrow = (L_local[:, :width] if s == i
                else L_local.new_empty(Lr, width))
        Lrow = broadcast_from(Lrow, i, ax.group)
        L_ii = Lrow[:, i * Lr:]
        if i == s:
            C[i * Lr:width] = torch.linalg.solve_triangular(
                L_ii, torch.eye(Lr, dtype=C.dtype, device=C.device),
                upper=False)
        elif i > s:
            T = Lrow[:, s * Lr:i * Lr] @ C[s * Lr:i * Lr]
            C[i * Lr:width] = -torch.linalg.solve_triangular(L_ii, T,
                                                             upper=False)
    return C


def _ring_lauum_rows(C_local, ax: _Axis) -> torch.Tensor:
    """Row slab s of K⁻¹ = L⁻ᵀL⁻¹: block (s, j) = Cₛᵀ·Cⱼ, with the column
    slabs rotated around the ring, p − 1 hops of [N, L]."""
    N, Lr = C_local.shape
    p, s = ax.p, ax.s
    K_rows = C_local.new_empty(Lr, N)
    buf = C_local
    for t in range(p):
        j = (s + t) % p
        lo = max(s, j) * Lr          # rows above are zero in Cₛ or Cⱼ
        K_rows[:, j * Lr:(j + 1) * Lr] = C_local[lo:].mT @ buf[lo:]
        if t + 1 < p:
            buf = ring_shift(buf, ax.group)
    return K_rows


class _LogdetQuadSharded(torch.autograd.Function):
    """(log|Ky|, yᵀKy⁻¹y) of a row-slab-sharded Ky, both on every rank,
    with the trace-form adjoint: this rank's slab of ∂/∂Ky is
    g_ld·K⁻¹[s, :] − g_q·αₛαᵀ, distributed in both passes."""

    @staticmethod
    def forward(ctx, K_local, y_local, ax):
        Lr = K_local.shape[0]
        s = ax.s
        L_local = _distributed_cholesky(K_local.detach(), ax)
        diag = L_local[:, s * Lr:(s + 1) * Lr].diagonal()
        logdet = ordered_sum(2.0 * torch.log(diag).sum(), ax.group)
        z = _forward_substitute(L_local, y_local, ax)
        alpha = _backward_substitute(L_local, z, ax)
        quad = all_gather_cat(y_local, ax.group) @ alpha
        ctx.ax = ax
        ctx.save_for_backward(L_local, alpha)
        return logdet, quad

    @staticmethod
    def backward(ctx, g_ld, g_q):
        L_local, alpha = ctx.saved_tensors
        ax = ctx.ax
        Lr = L_local.shape[0]
        own = alpha[ax.s * Lr:(ax.s + 1) * Lr]
        K_inv_rows = _ring_lauum_rows(
            _distributed_tri_inv_cols(L_local, ax), ax)
        dK = g_ld * K_inv_rows - g_q * torch.outer(own, alpha)
        dy = 2.0 * g_q * own if ctx.needs_input_grad[1] else None
        return dK, dy, None


class _SlabRBFKy(torch.autograd.Function):
    """This rank's slab Ky[s, :] = σ²·exp(−½‖(xᵢ − xⱼ)/ℓ‖²) + σₙ² on its
    own diagonal block (columns ``col0``…``col0 + L``), for rows X_local
    [L, Q] against X_full [N, Q].

    The forward is kernel K.  The backward, from the slab's cotangent W,
    with M = W∘K, r = M·1, c = Mᵀ·1 and the scaled inputs A = X_local/ℓ,
    B = X_full/ℓ:
    dσ² = ΣM/σ², dℓ_q = (Σᵢrᵢa²ᵢq + Σⱼcⱼb²ⱼq − 2Σᵢaᵢq(M·B)ᵢq)/ℓ_q, dσₙ² the
    trace of W's diagonal block.  X takes no gradient.
    """

    @staticmethod
    def forward(ctx, ls, var, noise, X_local, X_full, col0):
        Lr = X_local.shape[0]
        K = rbf_kernel_matrix(X_local / ls, X_full / ls, var)
        Ky = K.clone()
        Ky[:, col0:col0 + Lr].diagonal().add_(noise)
        ctx.col0 = col0
        ctx.save_for_backward(ls, var, X_local, X_full, K)
        return Ky

    @staticmethod
    def backward(ctx, W):
        ls, var, X_local, X_full, K = ctx.saved_tensors
        col0, Lr = ctx.col0, X_local.shape[0]
        A, B = X_local / ls, X_full / ls
        M = W * K
        r, c = M.sum(1), M.sum(0)
        dvar = r.sum() / var
        dls = (r @ (A * A) + c @ (B * B) - 2.0 * (A * (M @ B)).sum(0)) / ls
        dnoise = W[:, col0:col0 + Lr].diagonal().sum()
        return dls, dvar, dnoise, None, None, None


def _slab_Ky(gp, X_local, X_full, col0: int) -> torch.Tensor:
    """K(X_local, X_full) + σₙ² on the slab's own diagonal block: through
    :class:`_SlabRBFKy` when the RBF kernels serve the kernel, else by
    autograd through ``kernel.K``."""
    noise = noise_variance(gp)
    if _fused(gp.kernel, X_local):
        ls, var = _scaled_rbf(gp.kernel, X_local.shape[1])
        return _SlabRBFKy.apply(ls, var, noise, X_local, X_full, col0)
    K = gp.kernel.K(X_local, X_full)
    rows = torch.arange(X_local.shape[0], device=K.device)
    return K.index_put((rows, col0 + rows), noise.expand(rows.shape[0]),
                       accumulate=True)


def make_sharded_nlml_value_and_grad(gp, mesh, axis: str = "data"
                                     ) -> Callable:
    """``fn(X_local, y_local) -> (nlml, grads)`` over ``mesh``'s dimension
    ``axis``, for ``gp`` (a module holding ``kernel`` and ``raw_noise``,
    such as :class:`~edrgp_tpu_torch.models.state.ExactGPModel`), with X
    [N, Q] and y [N] sharded by rows along ``axis`` (:func:`shard_rows`).

    ``nlml`` is the full NLML and ``grads`` maps each of ``gp``'s parameter
    names to its full gradient, the same bits on every rank.  Every rank
    of the dimension must call ``fn`` together.
    """
    ax = _axis(mesh, axis)
    names, params = zip(*gp.named_parameters())

    def fn(X_local, y_local):
        Lr = X_local.shape[0]
        N = Lr * ax.p
        X_full = all_gather_cat(X_local, ax.group)
        with torch.enable_grad():
            K_local = _slab_Ky(gp, X_local, X_full, ax.s * Lr)
            logdet, quad = _LogdetQuadSharded.apply(K_local, y_local, ax)
            value = 0.5 * (N * _LOG2PI + logdet + quad)
            grads = torch.autograd.grad(value, params, allow_unused=True)
        flat = torch.cat([(torch.zeros_like(p) if g is None else g)
                          .reshape(-1) for p, g in zip(params, grads)])
        flat = ordered_sum(flat, ax.group)
        parts = flat.split([p.numel() for p in params])
        return value.detach(), {n: g.view_as(p) for n, p, g in
                                zip(names, params, parts)}

    return fn


class _Objective(torch.autograd.Function):
    """A value whose backward hands ``params`` the given gradients."""

    @staticmethod
    def forward(ctx, value, grads, *params):
        ctx.grads = grads
        return value.clone()

    @staticmethod
    def backward(ctx, ct):
        return (None, None, *(ct * g for g in ctx.grads))


def make_sharded_nlml_objective(gp, mesh, axis: str = "data") -> Callable:
    """Scalar NLML objective ``fun(X_local, y_local)`` whose backward gives
    ``gp``'s parameters the summed sharded gradient of
    :func:`make_sharded_nlml_value_and_grad`: what makes the sharded exact
    GP fittable by :func:`edrgp_tpu_torch.inference.lbfgs.minimize`.  X and
    y take no gradient."""
    vgfn = make_sharded_nlml_value_and_grad(gp, mesh, axis)
    params = list(gp.parameters())

    def fun(X_local, y_local):
        value, grads = vgfn(X_local, y_local)
        return _Objective.apply(value, list(grads.values()), *params)

    return fun


def shard_rows(mesh, axis: str, X, y):
    """This rank's row slabs (X [N/p, Q], y [N/p]) along ``axis``; N must be
    divisible by the axis size."""
    p = axis_size(mesh, axis)
    if X.shape[0] % p:
        raise ValueError(f"N={X.shape[0]} must be divisible by the "
                         f"'{axis}' axis size {p}")
    return shard_along(mesh, axis, X), shard_along(mesh, axis, y)


def sharded_nlml_value_and_grad(gp, mesh, X, y, axis: str = "data"):
    """One-call convenience: this rank's rows of (X, y) along ``axis`` and
    the distributed NLML value and gradient of ``gp`` (see
    :func:`make_sharded_nlml_value_and_grad`)."""
    X_local, y_local = shard_rows(mesh, axis, X, y)
    return make_sharded_nlml_value_and_grad(gp, mesh, axis)(X_local,
                                                            y_local)

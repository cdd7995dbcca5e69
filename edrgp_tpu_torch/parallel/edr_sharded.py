"""Data-parallel EDR composition: sharded gradient extraction and a
distributed Gram.

The port of :mod:`edrgp_tpu.parallel.edr_sharded`.  Every fitted GP model
here predicts dμ/dx* as ∇ₓ Σᵢ wᵢ k(x, cᵢ) for a pair (centers C, weights
w) — exact: (X, α); SGPR and SVGP: (Z, β) — given by
``model._gradient_basis()``.  The query rows are split over one mesh
dimension, padded to a multiple of its size and masked by global row index;
each rank runs :func:`edrgp_tpu_torch.ops.exact.grad_rows` on its rows, so
kernel G serves each rank's slab on the card for a plain RBF, with (C, w)
replicated (:func:`make_sharded_grad_gram`).  The [Q, Q] Gram GᵀG is
summed over the ranks, so the DR stage (an eigendecomposition of the Gram,
:meth:`edrgp_tpu_torch.utils.SVDTransformer.fit_gram`) never needs the
[N, Q] gradient matrix on one device.
``EffectiveDimensionalityReduction(gradient_mesh=...)`` routes its gradient
extraction through here.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.func import functional_call

from ..ops import exact as _exact
from .distributed import all_gather_cat, ordered_sum
from .mesh import axis_index, axis_size

__all__ = ["make_sharded_grad_gram", "model_gradient_gram",
           "supports_sharded_gradients"]


class _GradRows(nn.Module):
    """:func:`edrgp_tpu_torch.ops.exact.grad_rows` over a kernel held as a
    submodule, so that ``torch.func.functional_call`` can evaluate it at
    parameters it is given."""

    def __init__(self, kernel, chunk: int):
        super().__init__()
        self.kernel = kernel
        self.chunk = chunk

    def forward(self, C, w, X):
        return _exact.grad_rows(self.kernel, C, w, X, self.chunk)


def make_sharded_grad_gram(kernel, mesh, axis: str = "data",
                           chunk: int = 4096) -> Callable:
    """The sharded (gradients, Gram) program of a kernel:
    ``fn(kparams, C, w, X_local, n_valid) -> (G_local, gram)``.

    Each rank of ``axis`` passes its own slab X_local [L, Q] of the query
    rows, padded so that every slab has the same L, and the number of
    valid rows ``n_valid`` of the whole; rank s holds global rows
    s·L … s·L + L − 1.  ``kparams`` maps the kernel's parameter names
    (``kernel.named_parameters()``, unconstrained) to the values to
    evaluate it at, None its own.  G_local [L, Q] is ∇ₓ Σᵢ wᵢ k(x, cᵢ) at
    each row of the slab, by :func:`edrgp_tpu_torch.ops.exact.grad_rows`
    (kernel G on the card for a plain RBF), with the pad rows zeroed;
    gram [Q, Q] is Σ over the ranks of G_localᵀ G_local.  A name in
    ``kparams`` that is not one of the kernel's parameters raises a
    ValueError."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, not "
                        f"{type(mesh).__name__}")
    rows_of = _GradRows(kernel, int(chunk))
    s, group = axis_index(mesh, axis), mesh.get_group(axis)
    names = {n for n, _ in kernel.named_parameters()}

    def fn(kparams, C, w, X_local, n_valid):
        unknown = sorted(set(kparams or {}) - names)
        if unknown:
            raise ValueError(f"{type(kernel).__name__} has no parameters "
                             f"{unknown}; its parameters are "
                             f"{sorted(names)}")
        params = {f"kernel.{k}": v for k, v in (kparams or {}).items()}
        with torch.no_grad():
            G_local = functional_call(rows_of, params, (C, w, X_local))
            rows = X_local.shape[0]
            valid = min(max(int(n_valid) - s * rows, 0), rows)
            G_local[valid:] = 0.0                               # pad rows
            gram = ordered_sum(G_local.T @ G_local, group)
        return G_local, gram

    return fn


def supports_sharded_gradients(model) -> bool:
    """True when ``model`` exposes the (C, w) gradient basis and has no
    prior mean function (whose dm/dx* is added on the host and would make
    the summed Gram wrong)."""
    return (hasattr(model, "_gradient_basis")
            and getattr(model, "mean_function", None) is None)


def model_gradient_gram(model, X, mesh, axis: str = "data",
                        chunk: int | None = None):
    """Sharded predictive-gradient extraction and distributed Gram of a
    fitted model: ``(G [N, Q], gram [Q, Q])`` as float64 numpy in the
    model's original output scale (the y-normalizer's σ folded into both),
    with ``gram == G.T @ G`` up to rounding.  Every rank of ``axis`` must
    call it with the same X; N need not divide the axis size."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, not "
                        f"{type(mesh).__name__}")
    if not supports_sharded_gradients(model):
        raise TypeError(
            f"{type(model).__name__} does not support sharded gradient "
            "extraction (no _gradient_basis, or a mean_function is set)")
    kernel, C, w = model._gradient_basis()
    X = torch.as_tensor(np.asarray(X), dtype=C.dtype, device=C.device)
    N, Q = X.shape
    p, s = axis_size(mesh, axis), axis_index(mesh, axis)
    rows = -(-N // p)
    X_local = X[s * rows:(s + 1) * rows]
    X_local = torch.cat([X_local, X.new_zeros(rows - X_local.shape[0], Q)])
    if chunk is None:
        chunk = min(_exact.grad_batch_size(rows, C.shape[0]), max(rows, 1))
    fn = make_sharded_grad_gram(kernel, mesh, axis, chunk)
    G_local, gram = fn(None, C, w, X_local, N)
    G = all_gather_cat(G_local, mesh.get_group(axis))[:N]
    scale = float(model.normalizer.std) if model.normalizer.enabled else 1.0
    G = (G.cpu().numpy() * scale).astype(np.float64)
    gram = gram.cpu().numpy().astype(np.float64) * scale ** 2
    return G, gram

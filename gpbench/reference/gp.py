"""Plain reference of what every GP model a cell fits shares: the EDR's
inputs, the RBF kernel, the jitter ladder, the posterior mean and its
gradient at the training rows, and the EDR's projector.  Each model's own
objective and posterior weights are a module of their own beside this one
(``exact_gp.py``), which a configuration names under ``reference``.

Plain PyTorch in float64 (the control runs the same code in float32 with
TF32 matmuls: :class:`Precision`), written from the models' equations
(Rasmussen & Williams eq. 2.30 and 5.9) and GPy's conventions that the
fitted models follow: parameters are unconstrained and mapped through the
softplus, y is standardized, X is standardized and then projected, and a
Cholesky factor that fails takes a jitter from a ladder.  It imports
nothing of the program and takes nothing the program made but the
parameters whose objective it judges, and the EDR's projector of the fit
before.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

LOG2PI = math.log(2.0 * math.pi)

#: The jitter ladder: rung 0 adds nothing, rung k ≥ 1 adds
#: j₀·10^(k−1)·max(mean diagonal, 1) (six escalations), with j₀ 1e-6 for a
#: float32 factor and 1e-10 for a float64 one.
JITTER0 = {torch.float32: 1e-6, torch.float64: 1e-10}
JITTER_RUNGS = 7


@dataclass(frozen=True)
class Precision:
    """float64, or a lower precision for the control: float32 with every
    matmul's operands rounded to TF32's 10 mantissa bits (as the card's
    TF32 matmuls round them; on the card the TF32 switch is on as well)."""

    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = to_tf32(a), to_tf32(b)
        return a @ b


FLOAT64 = Precision()
TF32 = Precision(torch.float32, True)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def softplus(raw: torch.Tensor) -> torch.Tensor:
    """log(1 + eᶻ), linear past 30."""
    return torch.where(raw > 30.0, raw,
                       torch.log1p(torch.exp(-raw.abs())) + raw.clamp_min(0.0))


# ---------------------------------------------------------------- the data
def standardize(X: np.ndarray) -> np.ndarray:
    """Centre, and scale by the population deviation (1 where it is 0)."""
    std = X.std(axis=0)
    return (X - X.mean(axis=0)) / np.where(std == 0.0, 1.0, std)


def y_scale(y: np.ndarray) -> tuple[float, float]:
    """(mean, deviation) of y; a deviation of 0 counts as 1."""
    std = float(np.std(y))
    return float(np.mean(y)), (std if std > 0 else 1.0)


def fit_inputs(X: np.ndarray, y: np.ndarray, components):
    """(X_k, y_n, σ_y): the inputs of an EDR fit whose projector (rows of
    axes in the standardized features) is ``components`` (None: the first
    fit), and the standardized targets."""
    Xs = standardize(X)
    if components is not None:
        Xs = Xs @ np.asarray(components).T
    mean, std = y_scale(y)
    return Xs, (y - mean) / std, std


# ---------------------------------------------------------------- kernels
def sq_dist(A, B, prec: Precision = FLOAT64):
    a2 = (A * A).sum(-1)[:, None]
    b2 = (B * B).sum(-1)[None, :]
    return (a2 + b2 - 2.0 * prec.mm(A, B.T)).clamp_min(0.0)


def rbf(A, B, ls, var, prec: Precision = FLOAT64):
    return var * torch.exp(-0.5 * sq_dist(A / ls, B / ls, prec))


def hyper(params: dict, prec: Precision, device):
    """(σ², ℓ, σₙ²) from the unconstrained parameters, on the graph of
    whichever of ``params`` require grad."""
    var = softplus(params["kernel.variance"])
    ls = softplus(params["kernel.lengthscale"])
    noise = softplus(params["raw_noise"])
    return var, ls, noise


def as_params(raw: dict, prec: Precision, device, grad: bool = False):
    """Tensors of the recorded parameters in ``prec``'s dtype."""
    return {k: torch.as_tensor(np.asarray(v), dtype=prec.dtype,
                               device=device).requires_grad_(grad)
            for k, v in raw.items()}


def rung_jitter(rung: int, mean_diag: float,
                dtype: torch.dtype = torch.float32) -> float:
    if rung == 0:
        return 0.0
    return JITTER0[dtype] * 10.0 ** (rung - 1) * max(mean_diag, 1.0)


@torch.no_grad()
def first_rung(A: torch.Tensor, dtype: torch.dtype) -> int | None:
    """The rung of the ladder at which A (float64), rounded to ``dtype``,
    first factors in ``dtype``: the reference's own decision of the jitter
    a fit in that precision needs, taken without the program's answer.
    None where no rung factors."""
    A = A.to(dtype)
    mean_diag = float(A.diagonal().mean())
    eye = torch.eye(A.shape[0], dtype=dtype, device=A.device)
    for rung in range(JITTER_RUNGS):
        j = rung_jitter(rung, mean_diag, dtype)
        if int(torch.linalg.cholesky_ex(A + j * eye)[1]) == 0:
            return rung
    return None


def rungs_near(rung: int | None) -> list[int]:
    """The rungs a program in the same precision may take where the
    reference's factor takes ``rung``: that one and those next to it, for
    rounding decides a factor at the edge either way (all rungs but the
    first where the reference's factor fails on every one)."""
    if rung is None:
        return list(range(1, JITTER_RUNGS))
    return [r for r in (rung - 1, rung, rung + 1) if 0 <= r < JITTER_RUNGS]


def cholesky(A, jitter: float, climb: bool):
    """(L, jitter) of A + jitter·I; with ``climb`` the ladder is climbed
    from ``jitter`` as the control's own float32 factor needs."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    if not climb:
        return torch.linalg.cholesky(A + jitter * eye), jitter
    mean_diag = float(A.detach().diagonal().mean())
    for rung in range(JITTER_RUNGS):
        j = rung_jitter(rung, mean_diag, A.dtype)
        L, info = torch.linalg.cholesky_ex(A.detach() + j * eye)
        if int(info) == 0:
            return torch.linalg.cholesky(A + j * eye), j
    return torch.full_like(A, float("nan")), float("nan")


# ------------------------------------------------------ mean's gradient
@torch.no_grad()
def mean_grad(rows, C, w, params, prec: Precision = FLOAT64,
              block: int = 2048, terms: bool = False):
    """∂μ/∂x at each of ``rows`` for μ(x) = Σᵢ wᵢ k(x, Cᵢ): −(x Σᵢ wᵢ k(x, Cᵢ)
    − Σᵢ wᵢ k(x, Cᵢ) Cᵢ)/ℓ², in blocks of rows; with ``terms`` also the
    scale its rounding is judged on: the two sums' magnitudes
    Σᵢ |wᵢ k(x, Cᵢ)| (|x| + |Cᵢ|)/ℓ², the largest over the columns (the
    sums cancel where x lies among the Cᵢ, and exactly in x's own term)."""
    var, ls, _ = hyper(params, prec, rows.device)
    out, scale = [], []
    for r in rows.split(block):
        Kw = rbf(r, C, ls, var, prec) * w[None, :]
        out.append(-(Kw.sum(1, keepdim=True) * r - prec.mm(Kw, C)) / ls ** 2)
        if terms:
            t = Kw.abs().sum(1, keepdim=True) * r.abs() + Kw.abs() @ C.abs()
            scale.append((t / ls ** 2).amax(1, keepdim=True))
    G = torch.cat(out)
    return (G, torch.cat(scale)) if terms else G


@torch.no_grad()
def mean(rows, C, w, params, block: int = 2048):
    """μ(x) = Σᵢ wᵢ k(x, Cᵢ) at each of ``rows`` (float64), in blocks."""
    var, ls, _ = hyper(params, FLOAT64, rows.device)
    return torch.cat([rbf(r, C, ls, var) @ w for r in rows.split(block)])


# ------------------------------------------------------------- projector
def projector_gap(G: np.ndarray, components, new_components,
                  keep: int) -> float:
    """How far the program's next projector misses the gradients' leading
    ``keep`` directions: ‖U Uᵀ (I − V Vᵀ)‖_F / keep, with U those
    directions (right singular vectors of G, mapped through the projector
    the fit ran under) and V an orthonormal basis of the next projector's
    rows; 0 when V holds them."""
    _, _, Vh = np.linalg.svd(G, full_matrices=False)
    U = Vh[:keep]
    if components is not None:
        U = U @ np.asarray(components)
    U = np.linalg.qr(U.T)[0]
    Vb = np.linalg.svd(np.asarray(new_components).T,
                       full_matrices=False)[0]
    resid = U @ U.T @ (np.eye(U.shape[0]) - Vb @ Vb.T)
    return float(np.linalg.norm(resid)) / keep

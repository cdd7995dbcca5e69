"""Plain reference of the exact GP a configuration fits (``"reference":
"exact_gp"``): its negative log marginal likelihood (Rasmussen & Williams
eq. 2.30) and its posterior weights α, in float64, from the parameters the
fit recorded and the inputs :func:`gp.fit_inputs` makes.

What the fit checks ask of a model's reference, by name: ``objective``,
``mean_diag``, ``factored``, ``coef`` and ``centres``.
"""

from __future__ import annotations

import numpy as np
import torch

from .gp import (FLOAT64, LOG2PI, Precision, as_params, cholesky, hyper,
                 rbf, softplus)


def _ky(params, X, prec: Precision):
    var, ls, noise = hyper(params, prec, X.device)
    Ky = rbf(X, X, ls, var, prec)
    return Ky + noise * torch.eye(X.shape[0], dtype=Ky.dtype,
                                  device=Ky.device)


def objective(params, X, y, jitter: float = 0.0,
              prec: Precision = FLOAT64, climb: bool = False):
    """(NLML, jitter used) of the exact GP with Ky + jitter·I."""
    n = X.shape[0]
    L, jitter = cholesky(_ky(params, X, prec), jitter, climb)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    value = 0.5 * (n * LOG2PI + 2.0 * torch.log(L.diagonal()).sum()
                   + (y * alpha).sum())
    return value, jitter


def mean_diag(raw) -> float:
    """Mean diagonal of Ky, which scales the ladder's rungs."""
    return float(softplus(torch.as_tensor(np.asarray(
        raw["kernel.variance"], dtype=np.float64)))
        + softplus(torch.as_tensor(np.asarray(raw["raw_noise"],
                                              dtype=np.float64))))


@torch.no_grad()
def factored(raw, X):
    """The matrix whose factor takes the ladder's jitter: Ky (float64)."""
    return _ky(as_params(raw, FLOAT64, X.device), X, FLOAT64)


@torch.no_grad()
def coef(params, X, y, jitter: float = 0.0, prec: Precision = FLOAT64,
         climb: bool = False):
    """α = (Ky + jitter·I)⁻¹ y."""
    L, _ = cholesky(_ky(params, X, prec), jitter, climb)
    return torch.cholesky_solve(y[:, None], L)[:, 0]


def centres(params, X):
    """The rows the posterior mean sums over, μ(x) = Σᵢ αᵢ k(x, Xᵢ)."""
    return X

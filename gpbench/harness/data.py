"""The problems a cell fits: a frozen copy of the EDR recipe.

X = 2·Beta(1, τ) − 1 on [−1, 1]^Q, B = the Q factor of a normal [Q, D]
matrix, y = g(X·B) + σ·ε with the 3-D target (u₁³ + u₂)(u₁ − u₂³) + u₃
(1-D and 2-D targets as in the EDR-GP papers' synthetic data).  Drawn in
that order from one numpy ``Generator``, so the numbers match the
program's own ``datasets.get_beta_inputs`` / ``get_edr_target`` on the
same generator; kept here so that a change to the program cannot move the
yardstick.
"""

from __future__ import annotations

import math

import numpy as np

#: Seeds are whole numbers of any sign and size; a SeedSequence takes
#: non-negative ones.
_SEED_MOD = 1 << 64


def generator(seed: int, *stream: int) -> np.random.Generator:
    """The generator of stream ``stream`` of run seed ``seed``."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % _SEED_MOD, *map(int, stream)]))


def beta_inputs(rng, n: int, q: int, tau: float = 1.0) -> np.ndarray:
    return 2.0 * rng.beta(1, tau, size=(n, q)) - 1.0


def edr_target(U: np.ndarray, sigma: float | None, rng) -> np.ndarray:
    d = U.shape[1]
    if d == 1:
        u = U[:, 0]
        y = u * np.sin(math.sqrt(5.0) * u)
    elif d == 2:
        u1, u2 = U[:, 0], U[:, 1]
        y = (u1 ** 3 + u2) * (u1 - u2 ** 3)
    elif d == 3:
        u1, u2, u3 = U[:, 0], U[:, 1], U[:, 2]
        y = (u1 ** 3 + u2) * (u1 - u2 ** 3) + u3
    else:
        raise ValueError("the EDR target has 1 to 3 effective dimensions")
    if sigma is not None:
        y = y + sigma * rng.standard_normal(y.size)
    return y


def edr_problem(rng, n: int, q: int, d: int, sigma: float, tau: float = 1.0):
    """(X [n, q], y [n], B [q, d]) of the beta-input EDR recipe."""
    X = beta_inputs(rng, n, q, tau)
    B = np.linalg.qr(rng.normal(size=(q, d)))[0]
    return X, edr_target(X @ B, sigma, rng), B

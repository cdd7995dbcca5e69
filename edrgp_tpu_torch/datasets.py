"""Synthetic datasets with known effective subspaces (numpy).

The port of the generators of :mod:`edrgp_tpu.datasets`, without
scikit-learn: the same functions draw the same numbers from the same ``rng``.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.stats import special_ortho_group

from .estimator import check_array

__all__ = ["get_gaussian_inputs", "get_tanh_targets", "get_beta_inputs",
           "get_edr_target", "get_branin_targets"]


def _rng(rng):
    if rng is None:
        return np.random
    if isinstance(rng, (int, np.integer)):
        return np.random.default_rng(rng)
    return rng


def _normal(r, n):
    return np.asarray(r.standard_normal(n) if hasattr(r, "standard_normal")
                      else r.randn(n))


def get_gaussian_inputs(sample_size, eig_values, eig_vectors=None, mean=None,
                        rng=None):
    """Multivariate normal inputs with covariance Q diag(λ) Qᵀ."""
    r = _rng(rng)
    dim = len(eig_values)
    if eig_vectors is None:
        eig_vectors = special_ortho_group.rvs(dim)
    else:
        eig_vectors = check_array(eig_vectors)
        if eig_vectors.shape != (dim, dim):
            raise ValueError(f"eig_vectors shape must be ({dim},{dim})")
    cov = eig_vectors @ np.diag(eig_values) @ eig_vectors.T
    if mean is None:
        mean = np.zeros(dim)
    return r.multivariate_normal(mean, cov, sample_size)


def get_tanh_targets(X, coefs, bias=0, noise_std=0.05, rng=None):
    """y = tanh(X c + b) + ε — a 1-D ridge function of the inputs."""
    r = _rng(rng)
    coefs = np.asarray(coefs, float)
    if X.shape[1] != len(coefs):
        raise ValueError(
            f"Dimensionality of input ({X.shape[1]}) and coefs "
            f"({len(coefs)}) are mismatched")
    y = np.tanh(X @ coefs + bias)
    if noise_std:
        y = y + noise_std * _normal(r, X.shape[0])
    return y


def get_beta_inputs(sample_size, ndim, tau=1, rng=None):
    """Inputs from 2·Beta(1, τ) − 1 on [−1, 1]."""
    r = _rng(rng)
    return 2.0 * r.beta(1, tau, size=(sample_size, ndim)) - 1.0


def get_edr_target(X, sigma=None, rng=None):
    """Nonlinear targets keyed by effective dimension:

    * 1-D: g(u) = u sin(√5 u)
    * 2-D: g(u₁,u₂) = (u₁³+u₂)(u₁−u₂³)
    * 3-D: the 2-D target plus a linear u₃ term
    """
    r = _rng(rng)
    X = np.asarray(X)
    d = X.shape[1]
    if d == 1:
        u = X[:, 0]
        y = u * np.sin(math.sqrt(5.0) * u)
    elif d == 2:
        u1, u2 = X[:, 0], X[:, 1]
        y = (u1 ** 3 + u2) * (u1 - u2 ** 3)
    elif d == 3:
        u1, u2, u3 = X[:, 0], X[:, 1], X[:, 2]
        y = (u1 ** 3 + u2) * (u1 - u2 ** 3) + u3
    else:
        raise ValueError("get_edr_target supports 1-3 effective dimensions")
    y = y.ravel()
    if sigma is not None:
        y = y + sigma * _normal(r, y.size)
    return y


def get_branin_targets(X, noise_std=None, rng=None):
    """Branin function on [0,1]² (see https://www.sfu.ca/~ssurjano/branin.html)."""
    r = _rng(rng)
    X = np.asarray(X)
    a, b, c = 1.0, 5.1 / (4 * math.pi ** 2), 5 / math.pi
    rr, s, t = 6.0, 10.0, 1 / (8 * math.pi)
    x0 = 15 * X[:, 0] - 5
    x1 = 15 * X[:, 1]
    y = a * (x1 - b * x0 ** 2 + c * x0 - rr) ** 2 + s * (1 - t) * np.cos(x0) + s
    if noise_std is not None:
        y = y + noise_std * _normal(r, X.shape[0])
    return y

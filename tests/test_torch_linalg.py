"""The port's blocked Ky⁻¹ formation (edrgp_tpu_torch.ops.linalg) against
float64 inverses, the JAX package's recursions, and autograd through the
Cholesky factorization, float64 on the CPU.

The block size of the NLML's adjoint is a module constant; these tests call
the helpers with small blocks, and the NLML tests patch the constant, so
that a block multiple, a short last block and a single block all run at
small N.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrgp_tpu.ops import linalg as jlinalg
from edrgp_tpu_torch.models.state import ExactGPModel
from edrgp_tpu_torch.ops import exact, linalg
from edrgp_tpu_torch.ops.kernels import RBF

#: (N, block): N a multiple of the block, N not a multiple, N ≤ block.
SHAPES = [(96, 32), (100, 32), (20, 32)]


def _spd(n, seed=0):
    """An SPD matrix [n, n] with a condition number of ~1e4, float64."""
    rng = np.random.default_rng(seed)
    V = np.linalg.qr(rng.normal(size=(n, n)))[0]
    return (V * np.geomspace(1e-2, 1e2, n)) @ V.T


def _kinv(L, block):
    return linalg._mirror_upper(linalg._sym_square_upper(
        linalg._tri_inv(L, block), block), block)


@pytest.mark.parametrize("n,block", SHAPES)
def test_blocked_inverse_matches_float64_inv(n, block):
    K = torch.from_numpy(_spd(n))
    L = torch.linalg.cholesky(K)
    before = dict(linalg.KINV_FORMED)
    Linv = linalg._tri_inv(L, block)
    torch.testing.assert_close(Linv, torch.linalg.inv(L), rtol=1e-10,
                               atol=1e-10 * float(Linv.abs().max()))
    assert torch.equal(Linv.triu(1), torch.zeros_like(Linv))
    Kinv = _kinv(L, block)
    want = torch.linalg.inv(K)
    torch.testing.assert_close(Kinv, want, rtol=1e-9,
                               atol=1e-10 * float(want.abs().max()))
    assert torch.equal(Kinv, Kinv.mT)
    path = "blocked" if n > block else "single_block"
    other = "single_block" if n > block else "blocked"
    assert linalg.KINV_FORMED[path] == before[path] + 1
    assert linalg.KINV_FORMED[other] == before[other]


@pytest.mark.parametrize("n,block", SHAPES)
def test_blocked_inverse_matches_jax(n, block):
    L = np.linalg.cholesky(_spd(n, seed=1))
    Linv_ref = np.asarray(jlinalg.tri_inv_blocked(jnp.asarray(L), block=block))
    Kinv_ref = np.asarray(jlinalg.sym_square_from_tri_inv(
        jnp.asarray(Linv_ref), block=block))
    Lt = torch.from_numpy(L)
    np.testing.assert_allclose(linalg._tri_inv(Lt, block).numpy(), Linv_ref,
                               rtol=1e-10,
                               atol=1e-10 * np.abs(Linv_ref).max())
    np.testing.assert_allclose(_kinv(Lt, block).numpy(), Kinv_ref,
                               rtol=1e-9, atol=1e-10 * np.abs(Kinv_ref).max())


def _autograd_nlml(m, X):
    """The NLML by autograd through ``torch.linalg.cholesky``."""
    Ky = exact._Ky_generic(m, X)
    L = torch.linalg.cholesky(Ky)
    z = torch.linalg.solve_triangular(L, m._y[:, None], upper=False)[:, 0]
    return 0.5 * (X.shape[0] * math.log(2 * math.pi)
                  + 2.0 * torch.log(L.diagonal()).sum() + z @ z)


@pytest.mark.parametrize("n,block", SHAPES)
def test_nlml_gradient_matches_autograd_through_cholesky(n, block,
                                                         monkeypatch):
    monkeypatch.setattr(linalg, "KINV_BLOCK", block)

    def refused(*args, **kwargs):
        raise AssertionError("torch.cholesky_inverse called")

    monkeypatch.setattr(torch, "cholesky_inverse", refused)
    rng = np.random.default_rng(2)
    X = rng.normal(size=(n, 3))
    y = np.sin(X @ rng.normal(size=3)) + 0.1 * rng.normal(size=n)
    m = ExactGPModel(X, y, RBF(3, ARD=True), normalizer=False,
                     noise_var=0.05, device="cpu")
    out = []
    before = dict(linalg.KINV_FORMED)
    for fn in (exact.nlml, _autograd_nlml):
        m.zero_grad()
        Xt = m._X.clone().requires_grad_(True)
        v = fn(m, Xt) if fn is _autograd_nlml else fn(m, Xt, m._y)
        v.backward()
        out.append([v.detach()] + [p.grad.clone() for p in m.parameters()]
                   + [Xt.grad])
    path = "blocked" if n > block else "single_block"
    assert linalg.KINV_FORMED[path] == before[path] + 1
    for got, want in zip(*out):
        torch.testing.assert_close(got, want, rtol=1e-8,
                                   atol=1e-10 * float(want.abs().max()))


def test_deferred_status_flags_a_failed_factor_without_climbing():
    """Inside ``deferred_status`` the ladder takes rung 0 and ORs each
    failure into the flag; outside it climbs as before."""
    good = torch.eye(4, dtype=torch.float64) * 2.0
    bad = -torch.eye(4, dtype=torch.float64)
    flag = torch.zeros((), dtype=torch.bool)
    with linalg.deferred_status(flag):
        jitter, L = linalg.jitter_ladder(good)
        assert not bool(flag) and jitter == 0.0
        assert torch.equal(L, torch.linalg.cholesky(good))
        before = dict(linalg.FACTORS)
        jitter, _ = linalg.jitter_ladder(bad)
        assert bool(flag) and jitter == 0.0
        assert linalg.FACTORS["ladder"] == before["ladder"] + 1
    assert not linalg._DEFERRED
    jitter, _ = linalg.jitter_ladder(bad)         # climbs (and fails) again
    assert linalg.FACTORS["ladder"] > before["ladder"] + 2


def test_deferred_safe_cholesky_recomputes_unchecked(monkeypatch):
    """``safe_cholesky``'s factor on the graph reads no status inside
    ``deferred_status`` (``cholesky_ex``, not ``cholesky``), with the same
    factor and gradient."""
    A0 = torch.randn(6, 6, dtype=torch.float64)
    A0 = A0 @ A0.T + 6 * torch.eye(6, dtype=torch.float64)
    A = A0.clone().requires_grad_(True)
    L = linalg.safe_cholesky(A)
    L.sum().backward()
    want, grad = L.detach(), A.grad.clone()

    def refuse(*args, **kwargs):
        raise AssertionError("torch.linalg.cholesky checks its status")

    monkeypatch.setattr(torch.linalg, "cholesky", refuse)
    A = A0.clone().requires_grad_(True)
    with linalg.deferred_status(torch.zeros((), dtype=torch.bool)):
        L = linalg.safe_cholesky(A)
    L.sum().backward()
    assert torch.equal(L.detach(), want) and torch.allclose(A.grad, grad)

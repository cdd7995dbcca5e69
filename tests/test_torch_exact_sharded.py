"""The port's kernel-block-parallel exact GP (edrgp_tpu_torch.parallel.
exact_sharded, ExactGPModel.optimize_sharded) against the JAX package,
float64 on the CPU, and the exact GP's full posterior covariance and joint
samples.

The port runs in 4 gloo ranks started once for the module (see
``torch_ranks.exact_sharded``); the JAX side runs in this process, its
sharded NLML on 4 of the 8 CPU devices of ``tests/conftest.py``.  The
tolerances are ``tests/test_exact_sharded.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from edrgp_tpu.models import GaussianProcessRegressor as JGaussianProcessRegressor
from edrgp_tpu.models.state import ExactGPModel as JExactGPModel
from edrgp_tpu.ops import exact as jexact
from edrgp_tpu.ops import kernels as jk
from edrgp_tpu.ops.linalg import safe_cholesky as jsafe_cholesky
from edrgp_tpu.parallel.exact_sharded import (
    sharded_nlml_value_and_grad as jsharded_nlml_value_and_grad)
from edrgp_tpu.parallel.mesh import make_mesh as jmake_mesh
from edrgp_tpu_torch.convert import params_from_jax
from edrgp_tpu_torch.models.state import ExactGPModel
from edrgp_tpu_torch.ops import kernels as tk
from edrgp_tpu_torch.parallel import spawn

RANKS = 4
N, Q = 256, 4
KERNELS = {"RBF": lambda: jk.RBF(Q, ARD=True),
           "Matern52": lambda: jk.Matern52(Q)}


def _problem(n, q, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, q)), np.sin(rng.normal(size=n))


def _params(kernel):
    params = {"kernel": kernel.init_params(jnp.float64),
              "raw_noise": jk.inv_positive(jnp.asarray(0.1, jnp.float64))}
    return jax.tree_util.tree_map(np.asarray, params)


def _fit_problem():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(256, 3))
    y = np.sin(1.5 * X[:, 0]) + 0.5 * X[:, 1] + 0.1 * rng.normal(size=256)
    return X, y, rng.normal(size=(64, 3))


def _estimator_problem():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(128, 2))
    return X, np.tanh(X[:, 0]) + 0.05 * rng.normal(size=128)


@pytest.fixture(scope="module")
def ranks():
    X, y = _problem(N, Q)
    payload = {
        "nlml": [(name, X, y, _params(make())) for name, make in
                 KERNELS.items()],
        "indivisible": _problem(254, 2),
        "fit": _fit_problem(),
        "estimator": _estimator_problem(),
    }
    return spawn(torch_ranks.exact_sharded, RANKS, device="cpu",
                 args=(payload,))


def _flat(grads: dict, like) -> np.ndarray:
    """The port's gradient dict in the order of the JAX pytree ``like``."""
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, like))
    return np.concatenate([np.ravel(grads[k]) for k in ref])


def _jflat(tree) -> np.ndarray:
    flat = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    return np.concatenate([v.numpy().ravel() for v in flat.values()])


@pytest.mark.parametrize("name", list(KERNELS))
def test_sharded_matches_jax_single_device(ranks, name):
    """Every rank's sharded value and gradient equal JAX's single-device
    ``exact.nlml`` and its gradient."""
    X, y = _problem(N, Q)
    kernel = KERNELS[name]()
    params = jax.tree_util.tree_map(jnp.asarray, _params(kernel))
    val, grad = jax.value_and_grad(
        lambda p: jexact.nlml(kernel, p, jnp.asarray(X), jnp.asarray(y)))(
            params)
    for out in ranks:
        value, grads = out["nlml"][name]
        np.testing.assert_allclose(value, float(val), rtol=1e-10)
        np.testing.assert_allclose(_flat(grads, grad), _jflat(grad),
                                   rtol=1e-7, atol=1e-9)


def test_sharded_matches_jax_sharded(ranks):
    """The RBF case against JAX's own sharded NLML on 4 devices."""
    X, y = _problem(N, Q)
    kernel = KERNELS["RBF"]()
    params = jax.tree_util.tree_map(jnp.asarray, _params(kernel))
    mesh = jmake_mesh(("data",), devices=jax.devices()[:RANKS])
    val, grad = jsharded_nlml_value_and_grad(kernel, mesh, params,
                                             jnp.asarray(X), jnp.asarray(y))
    value, grads = ranks[0]["nlml"]["RBF"]
    np.testing.assert_allclose(value, float(val), rtol=1e-10)
    np.testing.assert_allclose(_flat(grads, grad), _jflat(grad),
                               rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("name", list(KERNELS))
def test_sharded_value_and_gradient_same_bits_on_every_rank(ranks, name):
    value, grads = ranks[0]["nlml"][name]
    for out in ranks[1:]:
        v, g = out["nlml"][name]
        assert v == value
        for k in grads:
            assert np.array_equal(g[k], grads[k])


def test_failed_factor_is_nan_on_every_rank(ranks):
    """A matrix no rank can factor gives a NaN value and gradient on every
    rank alike (so every rank's L-BFGS guard rejects the step), not a hang
    or a rank that raises alone."""
    for out in ranks:
        value, grads = out["failed_factor"]
        assert np.isnan(value)
        assert all(np.isnan(g).all() for g in grads.values())


def test_sharded_rejects_indivisible_n(ranks):
    for out in ranks:
        assert out["indivisible"] is not None
        assert "divisible" in out["indivisible"]


def test_sharded_fit_reaches_single_device_optimum(ranks):
    """``optimize_sharded`` over 4 ranks lands on the single-device
    ``optimize``'s optimum (the JAX test's bars)."""
    X, y, Xt = _fit_problem()
    single = ExactGPModel(X, y, tk.RBF(3, ARD=True), device="cpu")
    single.optimize(max_iters=200)
    fit = ranks[0]["fit"]
    np.testing.assert_allclose(fit["ll"], single.log_likelihood(),
                               rtol=1e-5)
    np.testing.assert_allclose(fit["pred"], single.predict(Xt)[0],
                               rtol=1e-3, atol=1e-4)


def test_sharded_fit_replicas_agree(ranks):
    """Every rank ends the fit with the same bits of θ (the rank checked
    ``assert_replicas_agree`` too)."""
    ref = ranks[0]["fit"]
    for out in ranks[1:]:
        assert out["fit"]["digest"] == ref["digest"]
        for k, v in ref["params"].items():
            assert np.array_equal(out["fit"]["params"][k], v)


def test_sharded_fit_via_estimator_method(ranks):
    """``GaussianProcessRegressor(method="optimize_sharded")`` fits through
    the distributed path to the JAX estimator's single-device optimum
    (log-likelihood to 1e-5)."""
    X, y = _estimator_problem()
    est = ranks[0]["estimator"]
    assert np.sqrt(np.mean((est["pred"] - y) ** 2)) < 0.2
    assert est["grads"].shape == (128, 2)
    jest = JGaussianProcessRegressor(kernel_options={"ARD": True})
    jest.fit(X, y, max_iters=150)
    np.testing.assert_allclose(est["ll"], jest.estimator_.log_likelihood(),
                               rtol=1e-5)


def _posterior_case():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(60, 3))
    y = np.sin(X[:, 0]) + 0.1 * rng.normal(size=60)
    Xnew = rng.normal(size=(25, 3))
    jm = JExactGPModel(X, y, jk.RBF(3, ARD=True))
    jm.params = {"kernel": {"variance": jnp.asarray(0.4),
                            "lengthscale": jnp.asarray([0.3, 0.9, -0.2])},
                 "raw_noise": jnp.asarray(-2.0)}
    m = ExactGPModel(X, y, tk.RBF(3, ARD=True), device="cpu")
    m.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params)))
    return jm, m, Xnew


def test_predict_full_cov_matches_jax():
    jm, m, Xnew = _posterior_case()
    mean_j, cov_j = jm.predict_full_cov(Xnew)
    mean, cov = m.predict_full_cov(Xnew)
    np.testing.assert_allclose(mean, mean_j, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(cov, cov_j, rtol=1e-10, atol=1e-12)


def test_posterior_samples_f_is_mean_plus_factor_times_draws():
    """Samples are mean + z·Lᵀ with L the Cholesky factor of JAX's
    covariance and z the generator's normal draws."""
    jm, m, Xnew = _posterior_case()
    mean_j, cov_j = jexact.predict_full_cov(
        jm.kernel, jm.params, jm._X, jm._posterior(), jnp.asarray(Xnew))
    L = np.asarray(jsafe_cholesky(cov_j))
    samples = m.posterior_samples_f(
        Xnew, size=7, generator=torch.Generator().manual_seed(5))
    z = torch.randn((7, 25), generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64).numpy()
    want = np.asarray(mean_j)[None, :] + z @ L.T
    std, mu = m.normalizer.std, m.normalizer.mean
    np.testing.assert_allclose(samples, want * std + mu, rtol=1e-10,
                               atol=1e-10)
    again = m.posterior_samples_f(Xnew, size=7, seed=3)
    assert np.array_equal(again, m.posterior_samples_f(Xnew, size=7, seed=3))

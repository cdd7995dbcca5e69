"""The port's sparse GP path (edrgp_tpu_torch.ops.sgpr, .ops.uncertain,
SGPRModel, SparseGaussianProcessRegressor), its mean functions and its
save/load, against the JAX package in float64 on the CPU.

Inputs come from numpy seeds; parameters travel from the JAX pytree into the
port with ``convert.params_from_jax``, so both packages evaluate the same
function at the same point.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import one_torch_thread  # noqa: F401 (autouse)
import edrgp_tpu
from edrgp_tpu.models import SparseGaussianProcessRegressor as JSGPR
from edrgp_tpu.models.state import ExactGPModel as JExactGPModel
from edrgp_tpu.models.state import SGPRModel as JSGPRModel
from edrgp_tpu.models.state import load_model as jload_model
from edrgp_tpu.ops import kernels as jk
from edrgp_tpu.ops import sgpr as jsgpr
from edrgp_tpu.ops import uncertain as juncertain
import edrgp_tpu_torch
from edrgp_tpu_torch.convert import params_from_jax
from edrgp_tpu_torch.models import (GaussianProcessRegressor,
                                    SparseGaussianProcessRegressor)
from edrgp_tpu_torch.models.state import ExactGPModel, SGPRModel, load_model
from edrgp_tpu_torch.ops import kernels as tk
from edrgp_tpu_torch.ops import sgpr, uncertain
from edrgp_tpu_torch.utils import _span, discrepancy


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * 1e-3 * max(np.abs(want).max(), 1))


def _problem(n, q, m, seed, ard=True):
    """(X, y, Z, JAX RBF kernel, JAX params as numpy) away from defaults."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, q))
    y = np.sin(X @ rng.normal(size=q)) + 0.1 * rng.normal(size=n)
    Z = rng.normal(size=(m, q))
    params = {"kernel": {"variance": np.array(0.4),
                         "lengthscale": rng.uniform(-0.3, 1.0,
                                                    q if ard else 1)},
              "raw_noise": np.array(-1.2), "Z": Z}
    return X, y, Z, jk.RBF(q, ARD=ard), params


def _port(X, y, params, ard=True, **kw):
    m = SGPRModel(X, y, tk.RBF(X.shape[1], ARD=ard), Z=params["Z"],
                  normalizer=False, device="cpu", **kw)
    m.load_state_dict(params_from_jax(params))
    return m


def _jp(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _grads_match(m, g_ref, rtol):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, g_ref))
    for name, p in m.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), rtol)


# ---------------------------------------------------------------------------
# SGPR: bound, posterior, prediction, gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sgpr_case():
    """N=200, Q=3, M=12 with the JAX bound, its gradient and its posterior
    computed once."""
    X, y, Z, jkern, params = _problem(200, 3, 12, seed=0)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    value, grad = jax.value_and_grad(
        lambda p: jsgpr.elbo(jkern, p, Xj, yj))(_jp(params))
    cache = jsgpr.sgpr_posterior(jkern, _jp(params), Xj, yj)
    return X, y, jkern, params, float(value), grad, cache


def test_sgpr_elbo_and_gradients_match_jax(sgpr_case):
    X, y, _, params, value, grad, _ = sgpr_case
    m = _port(X, y, params)
    e = sgpr.elbo(m, m._X, m._y)
    e.backward()
    np.testing.assert_allclose(e.item(), value, rtol=1e-10)
    _grads_match(m, grad, 1e-8)


def test_sgpr_posterior_prediction_and_gradients_match_jax(sgpr_case):
    X, y, jkern, params, _, _, jcache = sgpr_case
    m = _port(X, y, params)
    cache = sgpr.sgpr_posterior(m, m._X, m._y)
    for got, want in zip(cache, jcache):
        _close(got, want, 1e-9)
    Xs = np.random.default_rng(9).normal(size=(23, 3))
    Xst = torch.from_numpy(Xs)
    jp, Xsj = _jp(params), jnp.asarray(Xs)
    for lik in (True, False):
        mean, var = sgpr.predict(m, cache, Xst, include_likelihood=lik)
        jmean, jvar = jsgpr.predict(jkern, jp, jcache, Xsj, None, lik)
        _close(mean, jmean, 1e-9)
        _close(var, jvar, 1e-9)
    want = jsgpr.predict_mean_grad(jkern, jp, jcache[2], Xsj)
    _close(sgpr.predict_mean_grad(m, cache[2], Xst), want, 1e-9)
    _close(sgpr.predict_mean_grad(m, cache[2], Xst, batch=8), want, 1e-9)
    want = jsgpr.predict_var_grad(jkern, jp, jcache, Xsj)
    _close(sgpr.predict_var_grad(m, cache, Xst), want, 1e-9)
    _close(sgpr.predict_var_grad(m, cache, Xst, batch=8), want, 1e-9)


@pytest.mark.parametrize("batch", [8, 8192])
def test_sgpr_batched_mean_gradient_matches_jax(sgpr_case, batch):
    """``predict_mean_grad_batched`` against the JAX package's at 1e-10:
    23 rows in chunks of 8 (the last chunk ragged) and in one chunk."""
    X, y, jkern, params, _, _, jcache = sgpr_case
    m = _port(X, y, params)
    beta = sgpr.sgpr_posterior(m, m._X, m._y)[2]
    Xs = np.random.default_rng(9).normal(size=(23, 3))
    want = jsgpr.predict_mean_grad_batched(jkern, _jp(params), jcache[2],
                                           jnp.asarray(Xs), batch)
    got = sgpr.predict_mean_grad_batched(m, beta, torch.from_numpy(Xs),
                                         batch=batch)
    _close(got, want, 1e-10)


def test_sgpr_gradients_take_the_generic_path_for_other_kernels():
    """A non-RBF kernel reaches neither CUDA kernel: dμ/dx* by autograd."""
    X, y, Z, _, _ = _problem(60, 2, 6, seed=2)
    jm = JSGPRModel(X, y, jk.Matern52(2, ARD=True), Z=Z)
    m = SGPRModel(X, y, tk.Matern52(2, ARD=True), Z=Z, device="cpu")
    m.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params)))
    dmu, dvar = m.predictive_gradients(X[:9])
    jdmu, jdvar = jm.predictive_gradients(X[:9])
    _close(dmu, jdmu, 1e-9)
    _close(dvar, jdvar, 1e-9)


# ---------------------------------------------------------------------------
# Uncertain inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uncertain_case():
    X, y, Z, jkern, params = _problem(100, 2, 8, seed=1)
    S = 0.05 + 0.1 * np.random.default_rng(3).random(size=X.shape)
    return X, y, S, jkern, params


def test_psi_statistics_match_jax_in_any_chunking(uncertain_case):
    X, _, S, jkern, params = uncertain_case
    want = juncertain.psi_statistics(jkern, _jp(params)["kernel"],
                                     jnp.asarray(X), jnp.asarray(S),
                                     jnp.asarray(params["Z"]))
    m = _port(X, X[:, 0], params)
    args = (m.kernel, torch.from_numpy(X), torch.from_numpy(S), m.Z)
    with torch.no_grad():
        whole = uncertain.psi_statistics(*args, chunk=X.shape[0])
        chunked = uncertain.psi_statistics(*args, chunk=7)
    for got, ref in zip(whole, want):
        _close(got, ref, 1e-10)
    _close(chunked[2], whole[2], 1e-12)


def test_uncertain_elbo_and_gradients_match_jax(uncertain_case, monkeypatch):
    X, y, S, jkern, params = uncertain_case
    value, grad = jax.value_and_grad(
        lambda p: juncertain.elbo(jkern, p, jnp.asarray(X), jnp.asarray(y),
                                  jnp.asarray(S)))(_jp(params))
    m = _port(X, y, params, X_variance=S)
    loss = m._objective_fn()()
    loss.backward()
    np.testing.assert_allclose(-loss.item(), float(value), rtol=1e-10)
    for p in m.parameters():
        p.grad.neg_()
    _grads_match(m, grad, 1e-10)
    # the chunked bound's gradient (recomputed chunks) is the same
    grads = [p.grad.clone() for p in m.parameters()]
    m.zero_grad()
    monkeypatch.setattr(uncertain, "psi_statistics", functools.partial(
        uncertain.psi_statistics, chunk=16))
    m._objective_fn()().backward()
    for g, p in zip(grads, m.parameters()):
        _close(-p.grad, g, 1e-12)


def test_zero_input_variance_reduces_to_the_certain_bound(uncertain_case):
    X, y, _, _, params = uncertain_case
    m = _port(X, y, params)
    zero = torch.zeros_like(m._X)
    with torch.no_grad():
        np.testing.assert_allclose(
            uncertain.elbo(m, m._X, m._y, zero).item(),
            sgpr.elbo(m, m._X, m._y).item(), rtol=1e-10)
    for a, b in zip(uncertain.posterior(m, m._X, m._y, zero),
                    sgpr.sgpr_posterior(m, m._X, m._y)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-10)


@pytest.mark.parametrize("n", [1000, 3000])
def test_float32_uncertain_bound_is_the_float64_bound(n):
    """A float32 model's uncertain bound at parameters where float32
    arithmetic of L⁻¹Psi2L⁻ᵀ loses it (BASELINE config 3's data in Q=8,
    M=128 seeded inducing inputs, the lengthscales a float32 fit from 2
    reached at N=3,000): it equals the float64 model's bound, because the
    bound is evaluated in float64.  The port's float32 evaluation stood
    0.24% (n=1,000) and 2.3 times (n=3,000) away from it; the JAX
    package's float32 evaluation errs as far at such points.  Both models
    hold the same parameter values."""
    rng = np.random.default_rng(2)
    X = rng.uniform(-3, 3, size=(n, 8)).astype(np.float32)
    y = (np.sin(X[:, 0]) * np.cos(X[:, 1]) + 0.5 * np.tanh(X[:, 2])
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    lengthscale = [1.4651811, 1.8341486, 2.8932576, 33.227104, 32.870686,
                   33.0413, 32.779552, 32.416183]
    bounds, grads, state = [], [], None
    for dtype in (torch.float32, torch.float64):
        m = SGPRModel(X, y, tk.RBF(8, ARD=True, variance=0.3377,
                                   lengthscale=lengthscale),
                      num_inducing=128, seed=0, X_variance=0.01,
                      noise_var=0.0458, device="cpu", dtype=dtype)
        if state is None:
            state = m.state_dict()
        m.load_state_dict(state)         # the same (float32) values
        loss = m._objective_fn()()
        loss.backward()
        bounds.append(-loss.item())
        grads.append({k: p.grad.double() for k, p in m.named_parameters()})
        assert loss.dtype == dtype and m.kernel.lengthscale.grad.dtype == dtype
    # float32 parity: the float32 rounding of the data and of the
    # constrained parameters moves a bound of ~1e2 made of terms of ~3e4
    np.testing.assert_allclose(bounds[0], bounds[1], rtol=1e-4)
    for k, g in grads[1].items():
        _close(grads[0][k], g, 1e-3)


def test_uncertain_inputs_refuse_other_kernels():
    X = np.random.default_rng(0).normal(size=(20, 2))
    with pytest.raises(NotImplementedError, match="RBF"):
        SGPRModel(X, X[:, 0], tk.Matern32(2), X_variance=0.1, device="cpu")
    with pytest.raises(NotImplementedError, match="RBF"):
        uncertain.psi_statistics(tk.RBF(2) + tk.White(2),
                                 torch.from_numpy(X), torch.ones(20, 2),
                                 torch.from_numpy(X[:3]))


# ---------------------------------------------------------------------------
# Fits, the estimator and the EDR
# ---------------------------------------------------------------------------

def test_sparse_log_likelihood_is_close_to_exact():
    """The reference's acceptance bar (tests/test_exact_gp.py:98)."""
    rng = np.random.default_rng(101)
    n = 50
    X = np.linspace(0, 10, n)[:, None]
    Kmat = np.exp(-0.5 * (X - X.T) ** 2) + np.eye(n) * np.sqrt(0.05)
    y = rng.multivariate_normal(np.zeros(n), Kmat)
    gp = GaussianProcessRegressor(device="cpu").fit(X, y)
    sgp = SparseGaussianProcessRegressor(num_inducing=12,
                                         device="cpu").fit(X, y)
    ll = sgp.estimator_.log_likelihood()
    assert ll.shape == (1, 1)
    assert abs(gp.estimator_.log_likelihood() - ll[0][0]) < 0.5


def test_single_start_sgpr_fit_matches_jax():
    rng = np.random.default_rng(2)
    X = rng.uniform(-3, 3, size=(60, 1))
    y = np.sin(X[:, 0]) + 0.1 * rng.normal(size=60)
    jm = JSGPRModel(X, y, jk.RBF(1), num_inducing=6)
    jm.optimize()
    m = SGPRModel(X, y, tk.RBF(1), num_inducing=6, device="cpu")
    np.testing.assert_array_equal(m.Z.detach().numpy(), np.asarray(
        JSGPRModel(X, y, jk.RBF(1), num_inducing=6).params["Z"]))
    m.optimize()
    np.testing.assert_allclose(m.log_likelihood()[0][0],
                               jm.log_likelihood()[0][0], rtol=1e-5)


def test_hyperparameters_keep_z_unconstrained(sgpr_case):
    X, y, jkern, params, *_ = sgpr_case
    jm = JSGPRModel(X, y, jkern, Z=params["Z"])
    jm.params = _jp(params)
    got, want = _port(X, y, params).get_hyperparameters(), \
        jm.get_hyperparameters()
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
    np.testing.assert_array_equal(got["['Z']"], params["Z"])


def test_sparse_edr_matches_jax():
    """EDR over the sparse regressor at N=300, Q=4, planted 1-D subspace:
    the two packages find the same direction."""
    rng = np.random.default_rng(6)
    X = rng.normal(size=(300, 4))
    b = np.array([1.0, -0.5, 0.0, 0.25])
    y = np.tanh(X @ b) + 0.05 * rng.normal(size=300)
    jedr = edrgp_tpu.EffectiveDimensionalityReduction(
        JSGPR(num_inducing=20), edrgp_tpu.SVDTransformer(),
        n_components=1).fit(X, y)
    tedr = edrgp_tpu_torch.EffectiveDimensionalityReduction(
        SparseGaussianProcessRegressor(num_inducing=20, device="cpu"),
        edrgp_tpu_torch.SVDTransformer(), n_components=1).fit(X, y)
    assert discrepancy(_span(jedr.components_.T), tedr.components_.T) < 1e-3
    assert discrepancy(_span(b[:, None]), tedr.components_.T) < 0.05


# ---------------------------------------------------------------------------
# Mean functions
# ---------------------------------------------------------------------------

def mean_numpy(X):
    """A numpy-only mean function: both packages take differences."""
    X = np.asarray(X)
    return 1.0 + np.sin(X[:, 0]) + 0.5 * X[:, 1]


def mean_numpy_methods(X):
    """A numpy mean function that calls ndarray-only methods: a torch
    tensor has no ``copy`` (AttributeError), so the port must take the
    differences too."""
    X = X.copy().astype(float)
    return 1.0 + np.sin(X[:, 0]) + 0.5 * X[:, 1]


def mean_torch(X):
    X = torch.as_tensor(X)
    return 1.0 + torch.sin(X[:, 0]) + 0.5 * X[:, 1]


def mean_jax(X):
    X = jnp.asarray(X)
    return 1.0 + jnp.sin(X[:, 0]) + 0.5 * X[:, 1]


@pytest.mark.parametrize("kind", ["numpy", "numpy_methods", "autodiff"])
@pytest.mark.parametrize("sparse", [False, True])
def test_mean_function_prediction_and_gradient_match_jax(sparse, kind):
    X, y, Z, jkern, params = _problem(80, 2, 10, seed=4)
    y = y + mean_numpy(X)
    tm, jm = {"numpy": (mean_numpy, mean_numpy),
              "numpy_methods": (mean_numpy_methods, mean_numpy_methods),
              "autodiff": (mean_torch, mean_jax)}[kind]
    if sparse:
        jmodel = JSGPRModel(X, y, jkern, Z=Z, mean_function=jm)
        model = SGPRModel(X, y, tk.RBF(2, ARD=True), Z=Z, mean_function=tm,
                          device="cpu")
    else:
        del params["Z"]
        jmodel = JExactGPModel(X, y, jkern, mean_function=jm)
        model = ExactGPModel(X, y, tk.RBF(2, ARD=True), mean_function=tm,
                             device="cpu")
    jmodel.params = _jp(params)
    model.load_state_dict(params_from_jax(params))
    Xs = np.random.default_rng(5).normal(size=(17, 2)) * 3
    for got, want in zip(model.predict(Xs), jmodel.predict(Xs)):
        _close(got, want, 1e-8)
    for got, want in zip(model.predictive_gradients(Xs),
                         jmodel.predictive_gradients(Xs)):
        _close(got, want, 1e-8)


# ---------------------------------------------------------------------------
# Save / load
# ---------------------------------------------------------------------------

def _same_predictions(a, b, Xs):
    for got, want in zip(a.predict(Xs), b.predict(Xs)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(a.predictive_gradients(Xs),
                         b.predictive_gradients(Xs)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("model", ["exact", "sgpr", "sgpr_x_variance",
                                   "sum_kernel"])
def test_save_load_round_trip_is_bitwise(tmp_path, model):
    X, y, Z, _, params = _problem(50, 2, 7, seed=7)
    y = y + mean_numpy(X)
    if model == "exact":
        m = ExactGPModel(X, y, tk.RBF(2, ARD=True), mean_function=mean_numpy,
                         device="cpu", dtype=torch.float32)
    elif model == "sum_kernel":
        m = SGPRModel(X, y, tk.Matern32(2) + tk.Linear(2, ARD=True), Z=Z,
                      device="cpu")
    else:
        m = SGPRModel(X, y, tk.RBF(2, ARD=True), Z=Z,
                      mean_function=mean_torch, device="cpu",
                      X_variance=0.01 if model == "sgpr_x_variance"
                      else None)
    m.optimize(max_iters=5, num_restarts=1)
    path = str(tmp_path / "m.pickle")
    m.pickle(path)
    loaded = load_model(path, device="cpu")
    assert type(loaded) is type(m) and loaded._X.dtype == m._X.dtype
    for (n, a), (k, b) in zip(m.state_dict().items(),
                              loaded.state_dict().items()):
        assert n == k and torch.equal(a, b)
    assert loaded._objective == m._objective
    if model == "sgpr_x_variance":
        assert torch.equal(loaded._Xvar, m._Xvar)
        np.testing.assert_array_equal(loaded.log_likelihood(),
                                      m.log_likelihood())
    _same_predictions(m, loaded, X[:11] + 0.1)


def test_estimator_save_load_and_foreign_pickles(tmp_path):
    rng = np.random.default_rng(8)
    X = rng.uniform(-2, 2, size=(40, 2))
    y = np.sin(X[:, 0]) + 0.05 * rng.normal(size=40)
    est = SparseGaussianProcessRegressor(num_inducing=8, device="cpu",
                                         mean_function=mean_numpy)
    est.fit(X, y, max_iters=10)
    est.save(str(tmp_path / "sgpr"))
    back = SparseGaussianProcessRegressor(device="cpu").load(
        str(tmp_path / "sgpr"))
    assert back.n_features_ == 2
    np.testing.assert_array_equal(back.predict(X), est.predict(X))

    # neither package takes the other's pickles
    JSGPRModel(X, y, jk.RBF(2), num_inducing=8).pickle(
        str(tmp_path / "jax.pickle"))
    with pytest.raises(ValueError, match="not a model pickle"):
        load_model(str(tmp_path / "jax.pickle"), device="cpu")
    with pytest.raises(KeyError):
        jload_model(str(tmp_path / "sgpr.pickle"))


def test_unpicklable_mean_function_is_dropped_with_a_warning(tmp_path):
    X = np.random.default_rng(0).normal(size=(30, 2))
    m = ExactGPModel(X, np.sin(X[:, 0]), tk.RBF(2),
                     mean_function=lambda A: 0.5 * A[:, 0], device="cpu")
    path = str(tmp_path / "m.pickle")
    with pytest.warns(RuntimeWarning, match="not picklable"):
        m.pickle(path)
    assert load_model(path, device="cpu").mean_function is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ExactGPModel(X, X[:, 0], tk.RBF(2), mean_function=mean_numpy,
                     device="cpu").pickle(path)


def test_failed_factor_is_non_finite_on_the_graph():
    """When every jitter escalation fails, the differentiable factor is NaN
    (as the JAX package's is) instead of raising, so L-BFGS backs off."""
    from edrgp_tpu_torch.ops import linalg
    A = (-torch.eye(3, dtype=torch.float64)).requires_grad_(True)
    assert linalg.jitter_ladder(A)[0] is None
    L = linalg.safe_cholesky(A)
    assert torch.isnan(L).all()
    L.sum().backward()
    assert A.grad is not None

"""The port's exact-GP engine (edrgp_tpu_torch.ops, .inference, .models)
against the JAX package, float64 on the CPU.

Inputs come from numpy seeds; parameters travel from the JAX pytree into the
port with ``convert.params_from_jax``, so both packages evaluate the same
function at the same point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import one_torch_thread  # noqa: F401 (autouse)
from edrgp_tpu.ops import exact as jexact
from edrgp_tpu.ops import kernels as jkernels
from edrgp_tpu.ops import linalg as jlinalg
from edrgp_tpu.models.state import ExactGPModel as JExactGPModel
from edrgp_tpu_torch import config, models
from edrgp_tpu_torch.convert import params_from_jax, params_to_numpy
from edrgp_tpu_torch.inference import lbfgs
from edrgp_tpu_torch.models.state import ExactGPModel, SGPRModel, load_model
from edrgp_tpu_torch.models.svgp import SVGPModel
from edrgp_tpu_torch.ops import exact, linalg
from edrgp_tpu_torch.ops.kernels import RBF

N, Q = 97, 3


def _problem(ard, n=N, q=Q, seed=3):
    """(X, y, JAX kernel, JAX params as numpy) with non-default params."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, q))
    y = np.sin(X @ rng.normal(size=q)) + 0.1 * rng.normal(size=n)
    jk = jkernels.RBF(q, ARD=ard)
    n_ls = q if ard else 1
    params = {"kernel": {"variance": np.array(0.3),
                         "lengthscale": rng.uniform(-0.5, 1.0, n_ls)},
              "raw_noise": np.array(-1.5)}
    return X, y, jk, params


def _port(X, y, ard, params):
    """The port's model at the same (unnormalized) data and params."""
    m = ExactGPModel(X, y, RBF(X.shape[1], ARD=ard), normalizer=False,
                     device="cpu")
    m.load_state_dict(params_from_jax(params))
    return m


def _jparams(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * 1e-3 * np.abs(want).max())


@pytest.mark.parametrize("ard", [True, False])
def test_rbf_K_matches_jax(ard):
    X, _, jk, params = _problem(ard)
    m = _port(X, X[:, 0], ard, params)
    want = jk.K(_jparams(params)["kernel"], X[:40], X)
    with torch.no_grad():
        got = m.kernel.K(torch.from_numpy(X[:40]), torch.from_numpy(X))
    _close(got, want, 1e-12)


@pytest.mark.parametrize("ard", [True, False])
def test_nlml_value_and_grads_match_jax(ard):
    X, y, jk, params = _problem(ard)
    v_ref, (g_ref, gX_ref) = jax.value_and_grad(
        lambda p, Xa: jexact.nlml(jk, p, Xa, jnp.asarray(y)),
        argnums=(0, 1))(_jparams(params), jnp.asarray(X))
    m = _port(X, y, ard, params)
    Xt = torch.from_numpy(X).requires_grad_(True)
    v = exact.nlml(m, Xt, m._y)
    v.backward()
    np.testing.assert_allclose(v.item(), float(v_ref), rtol=1e-9)
    grads = {k: p.grad for k, p in m.named_parameters()}
    for key, want in params_from_jax(jax.tree_util.tree_map(
            np.asarray, g_ref)).items():
        _close(grads[key], want, 1e-7)
    _close(Xt.grad, gX_ref, 1e-7)


@pytest.mark.parametrize("ard", [True, False])
def test_rbfky_plain_backward_passes_gradcheck(ard):
    """RBFKy's closed-form backward holds for symmetric cotangents only, so
    gradcheck runs through K + Kᵀ, whose backward symmetrizes any
    cotangent; the isotropic case broadcasts ℓ outside the Function."""
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.normal(size=(12, 2))).requires_grad_(True)
    ls = torch.tensor([0.9, 1.4] if ard else [1.1], dtype=torch.float64,
                      requires_grad=True)
    var = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    noise = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)

    def fn(ls, var, noise, X):
        Ky = exact.RBFKy.apply(ls.expand(2), var, noise, X)
        return Ky + Ky.T

    assert torch.autograd.gradcheck(fn, (ls, var, noise, X))


def test_generic_path_matches_rbfky():
    X, y, _, params = _problem(True)
    m = _port(X, y, True, params)
    out = []
    for Ky in (exact._Ky, exact._Ky_generic):
        m.zero_grad()
        v = 0.5 * sum(linalg.logdet_and_quad(Ky(m, m._X), m._y))
        v.backward()
        out.append([v.item()] + [p.grad.clone() for p in m.parameters()])
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-12)
    for a, b in zip(out[0][1:], out[1][1:]):
        _close(a, b, 1e-9)


@pytest.mark.parametrize("ard", [True, False])
def test_posterior_predict_and_gradients_match_jax(ard):
    X, y, jk, params = _problem(ard)
    Xnew = np.random.default_rng(9).normal(size=(31, Q))
    jp = _jparams(params)
    L_ref, a_ref = jexact.posterior(jk, jp, X, y)
    mean_ref, var_ref = jexact.predict(jk, jp, X, (L_ref, a_ref), Xnew)
    dmu_ref = jexact.predict_mean_grad(jk, jp, X, a_ref, Xnew)
    dvar_ref = jexact.predict_var_grad(jk, jp, X, (L_ref, a_ref), Xnew)

    m = _port(X, y, ard, params)
    Xn = torch.from_numpy(Xnew)
    L, alpha = exact.posterior(m, m._X, m._y)
    mean, var = exact.predict(m, m._X, (L, alpha), Xn)
    dmu = exact.predict_mean_grad(m, m._X, alpha, Xn)
    dvar = exact.predict_var_grad(m, m._X, (L, alpha), Xn)
    for got, want in [(L, L_ref), (alpha, a_ref), (mean, mean_ref),
                      (var, var_ref), (dmu, dmu_ref), (dvar, dvar_ref)]:
        _close(got, want, 1e-8)
    # the batched forms agree with the one-shot ones
    _close(exact.predict_mean_grad_batched(m, m._X, alpha, Xn, 8), dmu, 1e-12)
    _close(exact.predict_var_grad_batched(m, m._X, (L, alpha), Xn, 8), dvar,
           1e-12)
    _close(exact.weighted_kernel_grad(m.kernel, m._X, alpha, Xn), dmu, 1e-8)


def test_jitter_ladder_matches_jax_on_indefinite_matrix():
    rng = np.random.default_rng(4)
    V = np.linalg.qr(rng.normal(size=(8, 8)))[0]
    A = V @ np.diag([2.0, 1.5, 1.0, 0.8, 0.5, 0.3, 0.1, -5e-9]) @ V.T
    L_ref = np.asarray(jlinalg.safe_cholesky(jnp.asarray(A)))
    jitter, L = linalg.jitter_ladder(torch.from_numpy(A))
    assert jitter == pytest.approx(1e-8)            # 0, 1e-10, 1e-9 fail
    # the last pivot, sqrt(1e-8 − 5e-9), carries the cancellation: 1e-7
    for got in (L, linalg.safe_cholesky(torch.from_numpy(A)),
                linalg.cholesky_once(torch.from_numpy(A))):
        _close(got, L_ref, 1e-7)
    hopeless = -np.eye(3)
    assert torch.isnan(linalg.cholesky_once(torch.from_numpy(hopeless))).all()


@pytest.mark.parametrize("jitter", ["float", "scalar_tensor",
                                    "per_matrix"])
def test_add_jitter_matches_jax_bit_for_bit(jitter):
    """A + jitter·I on a batch [3, 5, 5] equals the JAX package's bit for
    bit, for a float, a 0-d tensor and one jitter per matrix [3, 1, 1]."""
    rng = np.random.default_rng(6)
    A = rng.normal(size=(3, 5, 5))
    j = {"float": 1e-6, "scalar_tensor": np.array(3.7e-5),
         "per_matrix": rng.uniform(1e-8, 1e-4, size=(3, 1, 1))}[jitter]
    want = np.asarray(jlinalg.add_jitter(jnp.asarray(A), j if jitter ==
                                         "float" else jnp.asarray(j)))
    got = linalg.add_jitter(torch.from_numpy(A), j if jitter == "float"
                            else torch.from_numpy(np.asarray(j)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(linalg.add_jitter(torch.from_numpy(A[0]), 1e-6)
                          .numpy(), np.asarray(jlinalg.add_jitter(
                              jnp.asarray(A[0]), 1e-6)))


def test_single_start_fit_matches_jax():
    rng = np.random.default_rng(2)
    X = rng.uniform(-3, 3, size=(50, 1))
    y = np.sin(X[:, 0]) + 0.1 * rng.normal(size=50)
    jm = JExactGPModel(X, y, jkernels.RBF(1))
    jm.optimize()
    m = ExactGPModel(X, y, RBF(1), device="cpu")
    m.optimize()
    np.testing.assert_allclose(-m.log_likelihood(), -jm.log_likelihood(),
                               rtol=1e-6)


def test_params_round_trip():
    _, _, _, params = _problem(True)
    m = ExactGPModel(np.zeros((4, Q)), np.arange(4.0), RBF(Q, ARD=True),
                     device="cpu")
    m.load_state_dict(params_from_jax(params))
    assert sorted(m.state_dict()) == ["kernel.lengthscale", "kernel.variance",
                                      "raw_noise"]
    back = params_to_numpy(m)
    for key in ("variance", "lengthscale"):
        np.testing.assert_array_equal(back["kernel"][key],
                                      params["kernel"][key])
    np.testing.assert_array_equal(back["raw_noise"], params["raw_noise"])


def test_lbfgs_returns_best_finite_iterate():
    """The objective turns NaN after two evaluations: the guard hands the
    optimizer 1e30 instead, and minimize returns the best finite iterate,
    not the last one."""
    x = torch.tensor([3.0, -2.0], dtype=torch.float64, requires_grad=True)
    calls = []

    def fun():
        calls.append(1)
        v = ((x - 1.0) ** 2).sum()
        return v if len(calls) <= 2 else v * torch.nan

    res = lbfgs.minimize(fun, [x], max_iters=50, tol=1e-8)
    assert len(calls) > 2
    assert np.isfinite(res.value) and res.value < 13.0
    assert float(((x.detach() - 1.0) ** 2).sum()) == pytest.approx(res.value)
    # a clean quadratic converges to the l2 gradient tolerance
    y = torch.tensor([3.0, -2.0], dtype=torch.float64, requires_grad=True)
    res = lbfgs.minimize(lambda: ((y - 1.0) ** 2).sum(), [y], tol=1e-8)
    assert res.grad_norm < 1e-8 and res.value < 1e-16


def test_restarts_are_seeded_and_keep_the_best():
    rng = np.random.default_rng(6)
    X = rng.normal(size=(40, 2))
    y = np.cos(X[:, 0]) + 0.1 * rng.normal(size=40)
    vals = []
    for _ in range(2):
        m = ExactGPModel(X, y, RBF(2, ARD=True), device="cpu",
                         dtype=torch.float32)
        m.optimize(max_iters=50)            # float32: 5 restarts by default
        vals.append(m._objective)
        assert np.isclose(m._objective, -m.log_likelihood(), rtol=1e-5)
    assert vals[0] == vals[1]


def test_device_resolution_and_matmul_precision():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    for device in ("cuda", None):         # None means the card too
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            config.resolve_device(device)
    assert config.resolve_device("cpu").type == "cpu"
    assert config.default_dtype("cpu") == torch.float64
    assert config.default_dtype("cuda") == torch.float32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            config.check_matmul_precision()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("entry", [
    "ExactGPModel", "SGPRModel", "SVGPModel", "GaussianProcessRegressor",
    "SparseGaussianProcessRegressor", "SVGPRegressor", "load_model"])
def test_entry_points_without_a_device_refuse_the_cpu(tmp_path, entry):
    """No device means the card: without CUDA each entry point raises
    instead of running on the CPU, which it does only when asked."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    X = np.random.default_rng(0).normal(size=(12, 2))
    y = X[:, 0]
    path = str(tmp_path / "m.pickle")
    ExactGPModel(X, y, RBF(2), device="cpu").pickle(path)
    calls = {
        "ExactGPModel": lambda: ExactGPModel(X, y, RBF(2)),
        "SGPRModel": lambda: SGPRModel(X, y, RBF(2), num_inducing=4),
        "SVGPModel": lambda: SVGPModel(X, y, RBF(2), num_inducing=4),
        "load_model": lambda: load_model(path),
    }
    call = calls.get(entry, lambda: getattr(models, entry)().fit(X, y))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()

"""The port's SVGP path (edrgp_tpu_torch.ops.svgp, SVGPModel, SVGPRegressor)
against the JAX package in float64 on the CPU.

Inputs come from numpy seeds; parameters and the variational state travel
from the JAX pytrees into the port with ``convert.params_from_jax``, so both
packages evaluate the same function at the same point.  The streaming loop
is fed the same numpy batches in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_ranks import one_torch_thread  # noqa: F401 (autouse)
from edrgp_tpu import EffectiveDimensionalityReduction as JEDR
from edrgp_tpu import SVDTransformer as JSVD
from edrgp_tpu.data import MMapDataset as JMMapDataset
from edrgp_tpu.data import write_dataset as jwrite_dataset
from edrgp_tpu.models.svgp import SVGPModel as JSVGPModel
from edrgp_tpu.models.svgp import SVGPRegressor as JSVGPRegressor
from edrgp_tpu.ops import kernels as jk
from edrgp_tpu.ops import svgp as jsvgp
from edrgp_tpu_torch import EffectiveDimensionalityReduction, SVDTransformer
from edrgp_tpu_torch.convert import params_from_jax
from edrgp_tpu_torch.data import MMapDataset
from edrgp_tpu_torch.models import SVGPRegressor
from edrgp_tpu_torch.models.state import SGPRModel, load_model
from edrgp_tpu_torch.models.svgp import SVGPModel
from edrgp_tpu_torch.ops import kernels as tk
from edrgp_tpu_torch.ops import sgpr, svgp
from edrgp_tpu_torch.utils import discrepancy

KERNELS = {"RBF": (jk.RBF, tk.RBF), "Matern32": (jk.Matern32, tk.Matern32)}


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * 1e-3 * max(np.abs(want).max(), 1))


def _jp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _state(jstate):
    return svgp.SVGPState(**params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate)))


def _port(name, X, y, params, **kw):
    m = SVGPModel(X, y, KERNELS[name][1](X.shape[1], ARD=True),
                  Z=params["Z"], normalizer=False, device="cpu", **kw)
    m.load_state_dict(params_from_jax(params))
    return m


@pytest.fixture(scope="module")
def case():
    """N=60, Q=3, M=8 away from every default: kernel parameters, noise, Z,
    and a valid q(u) (θ₂ = −½(CCᵀ/M + I)); a minibatch of 20 rows."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 3))
    y = np.sin(X @ rng.normal(size=3)) + 0.1 * rng.normal(size=60)
    params = {"kernel": {"variance": np.array(0.4),
                         "lengthscale": rng.uniform(-0.3, 1.0, 3)},
              "raw_noise": np.array(-1.2), "Z": rng.normal(size=(8, 3))}
    C = rng.normal(size=(8, 8))
    state = jsvgp.SVGPState(theta1=jnp.asarray(rng.normal(size=8)),
                            theta2=jnp.asarray(-0.5 * (C @ C.T / 8
                                                       + np.eye(8))))
    return X, y, params, state, rng.choice(60, 20, replace=False)


def test_q_from_natural_matches_jax(case):
    state = case[3]
    for got, want in zip(svgp.q_from_natural(_state(state)),
                         jsvgp.q_from_natural(state)):
        _close(got, want, 1e-10)


@pytest.mark.parametrize("name", KERNELS)
def test_elbo_value_and_gradients_match_jax(case, name):
    X, y, params, state, idx = case
    jkern = KERNELS[name][0](3, ARD=True)
    m, S = jsvgp.q_from_natural(state)
    value, grad = jax.value_and_grad(
        lambda p: jsvgp.svgp_elbo(jkern, p, m, S, jnp.asarray(X[idx]),
                                  jnp.asarray(y[idx]), 60.0))(_jp(params))
    gp = _port(name, X, y, params)
    tm, tS = svgp.q_from_natural(_state(state))
    e = svgp.svgp_elbo(gp, tm, tS, gp._X[idx], gp._y[idx], 60.0)
    e.backward()
    np.testing.assert_allclose(e.item(), float(value), rtol=1e-10)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, grad))
    for key, p in gp.named_parameters():
        _close(p.grad.numpy(), want[key].numpy(), 1e-8)


def test_elbo_terms_and_kl_match_jax(case):
    X, y, params, state, idx = case
    jkern = jk.RBF(3, ARD=True)
    m, S = jsvgp.q_from_natural(state)
    count, quad = jsvgp.elbo_terms(jkern, _jp(params), m, S,
                                   jnp.asarray(X[idx]), jnp.asarray(y[idx]))
    gp = _port("RBF", X, y, params)
    tm, tS = svgp.q_from_natural(_state(state))
    with torch.no_grad():
        tcount, tquad = svgp.elbo_terms(gp, tm, tS, gp._X[idx], gp._y[idx])
        Luu = torch.linalg.cholesky(gp.kernel.K(gp.Z, gp.Z))
        kl = svgp._kl(tm, tS, Luu)
    assert float(tcount) == float(count) == 20.0
    np.testing.assert_allclose(float(tquad), float(quad), rtol=1e-10)
    jLuu = jnp.linalg.cholesky(jkern.K(_jp(params)["kernel"],
                                       jnp.asarray(params["Z"]),
                                       jnp.asarray(params["Z"])))
    np.testing.assert_allclose(float(kl), float(jsvgp._kl(m, S, jLuu)),
                               rtol=1e-10)


@pytest.mark.parametrize("name", KERNELS)
def test_natural_gradient_update_matches_jax(case, name):
    X, y, params, state, idx = case
    want = jsvgp.natural_gradient_update(
        KERNELS[name][0](3, ARD=True), _jp(params), state,
        jnp.asarray(X[idx]), jnp.asarray(y[idx]), 60.0, 0.3)
    gp = _port(name, X, y, params)
    got = svgp.natural_gradient_update(gp, _state(state), gp._X[idx],
                                       gp._y[idx], 60.0, 0.3)
    for g, w in zip(got, want):
        _close(g, w, 1e-8)


@pytest.mark.parametrize("name", KERNELS)
def test_predict_and_mean_gradients_match_jax(case, name):
    X, y, params, state, _ = case
    jkern = KERNELS[name][0](3, ARD=True)
    Xs = np.random.default_rng(9).normal(size=(23, 3))
    m, S = jsvgp.q_from_natural(state)
    gp = _port(name, X, y, params)
    tm, tS = svgp.q_from_natural(_state(state))
    Xst = torch.from_numpy(Xs)
    for lik in (True, False):
        mean, var = svgp.svgp_predict(gp, tm, tS, Xst, lik)
        jmean, jvar = jsvgp.svgp_predict(jkern, _jp(params), m, S,
                                         jnp.asarray(Xs), lik)
        _close(mean, jmean, 1e-9)
        _close(var, jvar, 1e-9)
    want = jsvgp.svgp_predict_mean_grad(jkern, _jp(params), m,
                                        jnp.asarray(Xs))
    _close(svgp.svgp_predict_mean_grad(gp, tm, Xst), want, 1e-9)
    _close(svgp.svgp_predict_mean_grad_batched(gp, tm, Xst, 8), want, 1e-9)
    want = jsvgp.svgp_predict_mean_grad_batched(jkern, _jp(params), m,
                                                jnp.asarray(Xs), 8)
    _close(svgp.svgp_predict_mean_grad_batched(gp, tm, Xst, 8), want, 1e-9)


def test_full_batch_natural_gradient_step_is_the_titsias_optimum():
    """With ρ=1 on the full batch one step lands on the optimal q(u): a
    second step is a fixed point, and the uncollapsed ELBO there equals the
    collapsed Titsias bound of the port's SGPR at the same parameters."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 3, size=(300, 2))
    y = np.sin(X[:, 0]) * np.cos(X[:, 1]) + 0.1 * rng.normal(size=300)
    gp = SVGPModel(X, y, tk.RBF(2), Z=X[:20], normalizer=False,
                   noise_var=0.1, device="cpu")
    Xt, yt = gp._X, gp._y
    q1 = svgp.natural_gradient_update(gp, gp.qstate, Xt, yt, 300, 1.0)
    q2 = svgp.natural_gradient_update(gp, q1, Xt, yt, 300, 1.0)
    (m1, S1), (m2, _) = svgp.q_from_natural(q1), svgp.q_from_natural(q2)
    with torch.no_grad():
        elbo1 = svgp.svgp_elbo(gp, m1, S1, Xt, yt, 300).item()
        ref = SGPRModel(X, y, tk.RBF(2), Z=X[:20], normalizer=False,
                        noise_var=0.1, device="cpu")
        titsias = sgpr.elbo(ref, ref._X, ref._y).item()
    _close(m2, m1, 1e-6)
    np.testing.assert_allclose(elbo1, titsias, rtol=1e-6)


@pytest.fixture(scope="module")
def stream_case():
    """The JAX package's and the port's ``optimize_stream`` on the same 20
    numpy batches (N=400, Q=3, M=16, B=32, ``scan_chunk=4``)."""
    rng = np.random.default_rng(4)
    X = rng.uniform(-2, 2, size=(400, 3))
    y = np.sin(X[:, 0]) + 0.5 * X[:, 1] + 0.1 * rng.normal(size=400)
    batches = [(X[i], y[i]) for i in
               (rng.integers(0, 400, 32) for _ in range(20))]
    jm = JSVGPModel(X, y, jk.RBF(3, ARD=True), num_inducing=16, seed=3)
    jm.optimize_stream(iter(batches), n_total=400, steps=20, lr=1e-2,
                       scan_chunk=4)
    tm = SVGPModel(X, y, tk.RBF(3, ARD=True), num_inducing=16, seed=3,
                   device="cpu")
    tm.optimize_stream(iter(batches), n_total=400, steps=20, lr=1e-2,
                       scan_chunk=4)
    return jm, tm, X


def test_streaming_loop_matches_jax(stream_case):
    """20 steps of Adam on the hyperparameters and natural-gradient steps on
    q(u): parameters, θ₁, θ₂ and the last minibatch ELBO agree; so Adam's
    update is optax's."""
    jm, tm, _ = stream_case
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params))
    for key, value in tm.state_dict().items():
        _close(value.numpy(), want[key].numpy(), 1e-8)
    for got, ref in zip(tm.qstate, jm.qstate):
        _close(got, ref, 1e-8)
    np.testing.assert_allclose(tm._objective, jm._objective, rtol=1e-8)


def test_fitted_model_surface_matches_jax(stream_case):
    """log_likelihood, predict, predictive_gradients (dvar zero) and
    _gradient_basis of the streamed models agree."""
    jm, tm, X = stream_case
    np.testing.assert_allclose(tm.log_likelihood(), jm.log_likelihood(),
                               rtol=1e-8)
    Xs = X[:37] + 0.1
    for got, want in zip(tm.predict(Xs), jm.predict(Xs)):
        _close(got, want, 1e-8)
    dmu, dvar = tm.predictive_gradients(Xs)
    jdmu, jdvar = jm.predictive_gradients(Xs)
    _close(dmu, jdmu, 1e-8)
    assert dmu.shape == (37, 3, 1) and not dvar.any() and not jdvar.any()
    _close(tm._gradient_basis()[2], jm._gradient_basis()[3], 1e-8)


def test_adam_defaults_are_optax_defaults():
    """torch.optim.Adam's defaults (β₁ 0.9, β₂ 0.999, ε 1e-8 outside the
    square root, bias correction) give optax.adam's updates."""
    opt_defaults = torch.optim.Adam([torch.zeros(1)]).defaults
    assert opt_defaults["betas"] == (0.9, 0.999)
    assert opt_defaults["eps"] == 1e-8 and not opt_defaults["amsgrad"]
    rng = np.random.default_rng(1)
    grads = rng.normal(size=(5, 4))
    p = torch.zeros(4, dtype=torch.float64, requires_grad=True)
    opt = torch.optim.Adam([p], lr=0.01)
    jopt = optax.adam(0.01)
    jp = jnp.zeros(4)
    jstate = jopt.init(jp)
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, jstate = jopt.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
    _close(p.detach().numpy(), np.asarray(jp), 1e-12)


def test_from_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(5000, 3)).astype(np.float32)
    y = (X[:, 0] + 0.1 * rng.normal(size=5000)).astype(np.float32)
    path = str(tmp_path / "d.edrg")
    jwrite_dataset(path, X, y)
    jds, ds = JMMapDataset(path), MMapDataset(path)
    try:
        jm = JSVGPModel.from_dataset(jds, jk.RBF(3), num_inducing=32, seed=2)
        tm = SVGPModel.from_dataset(ds, tk.RBF(3), num_inducing=32, seed=2,
                                    device="cpu")
    finally:
        jds.close()
        ds.close()
    np.testing.assert_array_equal(tm.Z.detach().numpy(),
                                  np.asarray(jm.params["Z"]))
    assert (tm.normalizer.mean, tm.normalizer.std) == \
        (jm.normalizer.mean, jm.normalizer.std)
    np.testing.assert_array_equal(tm._X.numpy(), np.asarray(jm._X))


def test_pickle_round_trip(tmp_path, stream_case):
    _, tm, X = stream_case
    path = str(tmp_path / "svgp.pickle")
    tm.pickle(path)
    loaded = load_model(path, device="cpu")
    assert type(loaded) is SVGPModel
    for got, want in zip(loaded.predict(X[:9]), tm.predict(X[:9])):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(loaded.qstate, tm.qstate):
        assert torch.equal(got, want)
    est = SVGPRegressor(num_inducing=8, device="cpu").fit(X, X[:, 0],
                                                          max_iters=5)
    est.save(str(tmp_path / "est"))
    again = SVGPRegressor(device="cpu").load(str(tmp_path / "est"))
    np.testing.assert_array_equal(again.predict(X[:9]), est.predict(X[:9]))
    np.testing.assert_array_equal(again.predict_gradient(X[:9]),
                                  est.predict_gradient(X[:9]))


def test_regressor_fit_is_seeded_and_has_a_rising_trace():
    X = np.random.default_rng(6).uniform(-3, 3, size=(300, 2))
    y = np.sin(X[:, 0])
    fits = [SVGPRegressor(num_inducing=16, batch_size=64, lr=1e-2,
                          device="cpu").fit(X, y, max_iters=60)
            for _ in range(2)]
    trace = fits[0].estimator_.elbo_trace_
    assert trace.shape == (60,) and trace[-10:].mean() > trace[:10].mean()
    np.testing.assert_array_equal(trace, fits[1].estimator_.elbo_trace_)
    assert fits[0].estimator_._objective == -trace[-1]
    # optimize_restarts is one optimize
    m = fits[0].estimator_
    m.optimize_restarts(num_restarts=3, max_iters=2, batch_size=8)
    assert m.elbo_trace_.shape == (2,)


def _planted(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    B = np.linalg.qr(rng.normal(size=(4, 2)))[0]
    Xb = X @ B
    y = np.sin(Xb[:, 0]) + 0.5 * np.tanh(Xb[:, 1]) + 0.05 * rng.normal(
        size=n)
    return X, y, B


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_svgp_edr_recovers_a_planted_subspace(package):
    """EffectiveDimensionalityReduction over SVGPRegressor at N=500 finds
    a planted 2-D subspace in both packages (their minibatch streams
    differ, so each is held to the bar, not to the other)."""
    X, y, B = _planted(500, 7)
    if package == "jax":
        edr = JEDR(JSVGPRegressor(num_inducing=32, batch_size=128, lr=1e-2),
                   JSVD(), n_components=2)
    else:
        edr = EffectiveDimensionalityReduction(
            SVGPRegressor(num_inducing=32, batch_size=128, lr=1e-2,
                          device="cpu"), SVDTransformer(), n_components=2)
    edr.fit(X, y, max_iters=300)
    assert discrepancy(B, edr.components_.T) < 0.1

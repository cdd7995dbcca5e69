"""The port's GP classification (edrgp_tpu_torch.ops.vgp, .ops.ep,
.ops.ep_dtc, models.cls_state, models.classification) against the JAX
package in float64 on the CPU.

Inputs come from numpy seeds; parameters travel from the JAX pytree into the
port with ``convert.params_from_jax``, so both packages evaluate the same
function at the same point.  dμ/dx* of every model goes through the port's
``grad_rows`` (kernel G's plain version on the CPU) and is held against the
JAX package's autodiff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrgp_tpu import EffectiveDimensionalityReduction as JEDR
from edrgp_tpu import SVDTransformer as JSVD
from edrgp_tpu.models import GaussianProcessClassifier as JGPC
from edrgp_tpu.models import SparseGaussianProcessClassifier as JSGPC
from edrgp_tpu.models import cls_state as jcs
from edrgp_tpu.models.state import load_model as jload_model
from edrgp_tpu.ops import ep as jep
from edrgp_tpu.ops import ep_dtc as jdtc
from edrgp_tpu.ops import kernels as jk
from edrgp_tpu.ops import vgp as jvgp
from edrgp_tpu_torch import EffectiveDimensionalityReduction, SVDTransformer
from edrgp_tpu_torch import estimator, models
from edrgp_tpu_torch.convert import params_from_jax
from edrgp_tpu_torch.models import (GaussianProcessClassifier,
                                    SparseGaussianProcessClassifier)
from edrgp_tpu_torch.models import cls_state as tcs
from edrgp_tpu_torch.models.state import load_model
from edrgp_tpu_torch.ops import ep, ep_dtc, vgp
from edrgp_tpu_torch.ops import kernels as tk
from edrgp_tpu_torch.utils import discrepancy

MODELS = ["VGPClassificationModel", "SparseVGPClassificationModel",
          "EPClassificationModel", "SparseEPClassificationModel"]


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * 1e-3 * max(np.abs(want).max(), 1))


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _data(n=30, q=3, seed=0):
    """X [n, q], 0/1 labels with flips, and 9 test rows."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, q))
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.4 * rng.normal(size=n) > 0).astype(int)
    return X, y, rng.normal(size=(9, q))


def _pair(name, X, y, seed=1, M=6, lik=None):
    """(JAX model, port model) of class ``name`` at the same non-default
    parameters (ℓ, σ², and for VI a moved m and tril)."""
    rng = np.random.default_rng(seed)
    q = X.shape[1]
    kw = {"num_inducing": M} if "Sparse" in name else {}
    if name == "SparseVGPClassificationModel":
        kw["likelihood"] = lik
    jm = getattr(jcs, name)(X, y, jk.RBF(q, ARD=True), **kw)
    p = jax.tree_util.tree_map(np.asarray, jm.params)
    p["kernel"] = {"variance": np.array(0.6),
                   "lengthscale": rng.uniform(-0.2, 1.0, q)}
    if "m" in p:
        p["m"] = 0.4 * rng.normal(size=p["m"].shape)
        p["tril"] = p["tril"] + 0.1 * rng.normal(size=p["tril"].shape)
    jm.params = jax.tree_util.tree_map(jnp.asarray, p)
    tm = getattr(tcs, name)(X, y, tk.RBF(q, ARD=True), device="cpu", **kw)
    tm.load_state_dict(params_from_jax(p))
    return jm, tm, p


def _grads_match(tm, g_ref, rtol):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, g_ref))
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), rtol)


# ---------------------------------------------------------------------------
# ops/vgp.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lik", ["probit", "logit"])
def test_links_and_quadrature_match_jax(lik):
    rng = np.random.default_rng(2)
    mu, var = rng.normal(size=50) * 3, rng.uniform(0.01, 4.0, 50)
    ys = np.where(rng.normal(size=50) > 0, 1.0, -1.0)
    _close(vgp._expected_log_lik(_t(ys), _t(mu), _t(var), lik).item(),
           jvgp._expected_log_lik(jnp.asarray(ys), jnp.asarray(mu),
                                  jnp.asarray(var), lik), 1e-12)
    _close(vgp.bernoulli_predict_proba(_t(mu), _t(var), lik).numpy(),
           jvgp.bernoulli_predict_proba(jnp.asarray(mu), jnp.asarray(var),
                                        lik), 1e-12)
    z = np.linspace(-40, 40, 81)
    _close(vgp.probit(_t(z)).numpy(), jvgp.probit(jnp.asarray(z)), 1e-12)
    for dtype in (torch.float32, torch.float64):
        ll = vgp._LOG_LIKS[lik](torch.as_tensor(z, dtype=dtype))
        assert torch.isfinite(ll).all()


def test_likelihood_names_match_jax():
    for name in [None, "probit", "Bernoulli", "bernoulli_probit", "logit",
                 "LOGISTIC", "bernoulli_logit"]:
        assert vgp.canonical_likelihood(name) == \
            jvgp.canonical_likelihood(name)
    for mod in (vgp, jvgp):
        with pytest.raises(ValueError, match="unknown likelihood 'poisson'"):
            mod.canonical_likelihood("poisson")


@pytest.mark.parametrize("n", [1, 5, 12])
def test_tril_unpack_init_and_kl_match_jax(n):
    rng = np.random.default_rng(n)
    m0, tril0 = vgp.init_variational_params(n, torch.float64)
    jinit = jvgp.init_variational_params(n, jnp.float64)
    np.testing.assert_array_equal(tril0.numpy(), np.asarray(jinit["tril"]))
    np.testing.assert_array_equal(m0.numpy(), np.asarray(jinit["m"]))
    flat = rng.normal(size=n * (n + 1) // 2) * 3
    S = vgp._unpack_tril(_t(flat), n)
    jS = jvgp._unpack_tril(jnp.asarray(flat), n)
    _close(S.numpy(), jS, 1e-14)
    assert torch.equal(S, torch.tril(S))
    m = rng.normal(size=n)
    _close(vgp._kl_whitened(_t(m), S).item(),
           jvgp._kl_whitened(jnp.asarray(m), jS), 1e-12)


@pytest.mark.parametrize("name,lik", [
    ("VGPClassificationModel", "probit"), ("VGPClassificationModel", "logit"),
    ("SparseVGPClassificationModel", "probit"),
    ("SparseVGPClassificationModel", "logit")])
def test_vi_bound_and_gradients_match_jax(name, lik):
    X, y, Xs = _data()
    jm, tm, p = _pair(name, X, y, lik=lik)
    tm._lik = lik
    jfn = jvgp.vgp_elbo if "VGP" == name[:3] else jvgp.svgp_cls_elbo
    val, g = jax.value_and_grad(
        lambda pp: jfn(jm.kernel, pp, jm._X, jm._y, lik))(jm.params)
    tm.zero_grad()
    loss = tm._objective_fn()()
    loss.backward()
    _close(-loss.item(), val, 1e-10)
    g = jax.tree_util.tree_map(lambda v: -np.asarray(v), g)
    _grads_match(tm, g, 1e-8)


@pytest.mark.parametrize("name", ["VGPClassificationModel",
                                  "SparseVGPClassificationModel"])
def test_vi_predict_latent_matches_jax(name):
    X, y, Xs = _data()
    jm, tm, p = _pair(name, X, y)
    want = jm._latent(jnp.asarray(Xs))
    got = tm._latent(_t(Xs))
    for a, b in zip(got, want):
        _close(a.numpy(), b, 1e-10)


# ---------------------------------------------------------------------------
# ops/ep.py and ops/ep_dtc.py
# ---------------------------------------------------------------------------

def test_ep_pieces_match_jax():
    rng = np.random.default_rng(3)
    X, y, _ = _data(n=20)
    K = jk.RBF(3).K(jk.RBF(3).init_params(jnp.float64), jnp.asarray(X),
                    jnp.asarray(X))
    nu, tau = rng.normal(size=20), rng.uniform(0.0, 2.0, 20)
    want = jep._posterior_marginals(K, jnp.asarray(nu), jnp.asarray(tau))
    got = ep._posterior_marginals(_t(K), _t(nu), _t(tau))
    for a, b in zip(got, want):
        _close(a.numpy(), b, 1e-10)
    mu_cav, var_cav = rng.normal(size=20) * 5, rng.uniform(0.01, 5.0, 20)
    ys = np.where(y == 1, 1.0, -1.0)
    for a, b in zip(ep._probit_moments(_t(ys), _t(mu_cav), _t(var_cav)),
                    jep._probit_moments(jnp.asarray(ys), jnp.asarray(mu_cav),
                                        jnp.asarray(var_cav))):
        _close(a.numpy(), b, 1e-10)
    for a, b in zip(ep._cavity(_t(mu_cav), _t(var_cav), _t(nu), _t(tau),
                               1e-12),
                    jep._cavity(jnp.asarray(mu_cav), jnp.asarray(var_cav),
                                jnp.asarray(nu), jnp.asarray(tau), 1e-12)):
        _close(a.numpy(), b, 1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_probit_moments_stay_finite_in_the_far_tail(dtype):
    z = torch.tensor([-60.0, -35.0, -8.0, 0.0, 8.0, 35.0, 60.0],
                     dtype=dtype)
    ys = torch.ones_like(z)
    mu_hat, var_hat = ep._probit_moments(ys, z, torch.full_like(z, 0.5))
    assert torch.isfinite(mu_hat).all() and torch.isfinite(var_hat).all()
    assert (var_hat > 0).all()


@pytest.mark.parametrize("name", ["EPClassificationModel",
                                  "SparseEPClassificationModel"])
def test_ep_sites_energy_and_gradients_match_jax(name):
    """Sites from the zero start at the JAX package's float64 tolerance
    (1e-10), the same iteration count, then log Z and its gradient at the
    same sites to 1e-8, and the prediction cache and latent moments."""
    X, y, Xs = _data()
    jm, tm, p = _pair(name, X, y, M=8)
    sparse = name.startswith("Sparse")
    jo, to = (jdtc, ep_dtc) if sparse else (jep, ep)
    fit = "ep_dtc_fit" if sparse else "ep_fit"
    js = getattr(jo, fit)(jm.kernel, jm.params, jm._X, jm._y)
    ts = getattr(to, fit)(tm, tm._X, tm._y)
    assert ts.iters == int(js.iters) and ts.delta <= 1e-10
    _close(ts.nu.numpy(), js.nu, 1e-8)
    _close(ts.tau.numpy(), js.tau, 1e-8)
    energy = "ep_dtc_energy" if sparse else "ep_energy"
    val, g = jax.value_and_grad(lambda pp: getattr(jo, energy)(
        jm.kernel, pp, jm._X, jm._y, js.nu, js.tau))(jm.params)
    tm.zero_grad()
    e = getattr(to, energy)(tm, tm._X, tm._y, _t(js.nu), _t(js.tau))
    e.backward()
    _close(e.item(), val, 1e-10)
    _grads_match(tm, g, 1e-8)
    _close(tm.log_likelihood(), jm.log_likelihood(), 1e-8)
    for a, b in zip(tm._ep()[1], jm._ep()[1]):
        _close(a.numpy(), b, 1e-8)
    for a, b in zip(tm._latent(_t(Xs)), jm._latent(jnp.asarray(Xs))):
        _close(a.numpy(), b, 1e-8)


@pytest.mark.parametrize("name", ["EPClassificationModel",
                                  "SparseEPClassificationModel"])
def test_ep_energy_gradient_matches_finite_differences(name):
    """The stop-gradient split: the gradient of −log Z with the sites held
    equals the total derivative of the re-converged objective (GPML eq.
    5.27), checked by central differences as the JAX package's tests do."""
    X, y, _ = _data(n=12, q=2, seed=4)
    _, tm, _ = _pair(name, X, y, M=5)
    obj = tm._objective_fn()
    params = list(tm.parameters())
    tm.zero_grad()
    obj().backward()
    g = torch.cat([p.grad.reshape(-1) for p in params]).numpy()
    flat = torch.cat([p.detach().reshape(-1) for p in params])

    def f(v):
        with torch.no_grad():
            torch.nn.utils.vector_to_parameters(v, params)
            return obj().item()

    h = 1e-5
    fd = np.zeros(flat.numel())
    for i in range(flat.numel()):
        e = torch.zeros_like(flat)
        e[i] = h
        fd[i] = (f(flat + e) - f(flat - e)) / (2 * h)
    np.testing.assert_allclose(g, fd, rtol=2e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# models/cls_state.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_model_predict_and_gradients_match_jax(name):
    """predict (P(y=1), latent var), log_likelihood, and dμ/dx* by the G
    route against the JAX package's autodiff of the latent mean."""
    X, y, Xs = _data()
    jm, tm, _ = _pair(name, X, y)
    for a, b in zip(tm.predict(Xs), jm.predict(Xs)):
        _close(a, b, 1e-8)
    _close(tm.log_likelihood(), jm.log_likelihood(), 1e-8)
    want = jax.vmap(jax.grad(jm._latent_mean_one))(jnp.asarray(Xs))
    dmu, dvar = tm.predictive_gradients(Xs)
    _close(dmu[:, :, 0], want, 1e-8)
    assert dmu.shape == (9, 3, 1) and not dvar.any()
    _close(tm.predictive_gradients(Xs, batch=4)[0], dmu, 1e-12)


@pytest.mark.parametrize("name", MODELS)
def test_model_labels_and_inducing_init_match_jax(name):
    X, y, _ = _data()
    labels = np.where(y == 1, "yes", "no")
    jm, tm, _ = _pair(name, X, labels)
    np.testing.assert_array_equal(tm.classes_, jm.classes_)
    np.testing.assert_array_equal(tm._y.numpy(), np.asarray(jm._y))
    if "Z" in jm.params:
        np.testing.assert_array_equal(tm.Z.detach().numpy(), jm.params["Z"])
    with pytest.raises(ValueError, match="requires 2 classes"):
        getattr(tcs, name)(X, np.arange(30) % 3, tk.RBF(3), device="cpu")
    assert tm.noise_variance == 0.0 and tm._f32_default_restarts == 1


@pytest.mark.parametrize("name", MODELS)
def test_model_save_load_roundtrip(tmp_path, name):
    X, y, Xs = _data()
    _, tm, _ = _pair(name, X, np.where(y == 1, 7, -3), lik="logit")
    path = str(tmp_path / "m.pickle")
    tm.pickle(path)
    loaded = load_model(path, device="cpu")
    assert type(loaded) is type(tm) and loaded._lik == tm._lik
    np.testing.assert_array_equal(loaded.classes_, [-3, 7])
    for a, b in zip(loaded.predict(Xs), tm.predict(Xs)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(loaded.predictive_gradients(Xs)[0],
                                  tm.predictive_gradients(Xs)[0])
    jm = getattr(jcs, name)(X, y, jk.RBF(3))
    jm.pickle(str(tmp_path / "j.pickle"))
    with pytest.raises(ValueError, match="not a model pickle"):
        load_model(str(tmp_path / "j.pickle"), device="cpu")
    with pytest.raises(Exception):
        jload_model(path)


# ---------------------------------------------------------------------------
# models/classification.py and the estimator surface
# ---------------------------------------------------------------------------

def test_estimator_surface():
    X, y, _ = _data(n=40, seed=6)
    labels = np.where(y == 1, "b", "a")
    clf = GaussianProcessClassifier(inference="ep", device="cpu")
    assert clf._estimator_type == "classifier"
    assert estimator.is_classifier(clf)
    assert clf.get_params()["device"] == "cpu"
    assert estimator.clone(clf).get_params() == clf.get_params()
    clf.fit(X, labels)
    proba = clf.predict_proba(X)
    np.testing.assert_array_equal(clf.predict(X),
                                  clf.classes_[(proba > 0.5).astype(int)])
    assert clf.score(X, labels) == np.mean(clf.predict(X) == labels) > 0.8
    with pytest.raises(ValueError, match="continuous"):
        GaussianProcessClassifier(device="cpu").fit(X, X[:, 0])
    with pytest.raises(ValueError, match="requires 2 classes"):
        GaussianProcessClassifier(device="cpu").fit(X, np.arange(40) % 3)
    with pytest.raises(ValueError, match="unknown inference"):
        GaussianProcessClassifier(inference="laplace", device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="probit \\(Bernoulli\\) likelihood "
                                         "only"):
        SparseGaussianProcessClassifier(likelihood="logit", inference="ep",
                                        device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="unknown likelihood"):
        SparseGaussianProcessClassifier(likelihood="poisson",
                                        device="cpu").fit(X, y)
    estimator.check_classification_targets(np.array([0.0, 1.0, 1.0]))
    estimator.check_classification_targets(np.array(["a", "b"]))


@pytest.mark.parametrize("inference", ["vi", "ep"])
def test_estimator_load_restores_classes(tmp_path, inference):
    X, y, Xs = _data(n=30, seed=7)
    labels = np.where(y == 1, 7, -3)
    clf = SparseGaussianProcessClassifier(num_inducing=6, inference=inference,
                                          device="cpu")
    clf.fit(X, labels, max_iters=20)
    path = str(tmp_path / "clf")
    clf.save(path)
    back = SparseGaussianProcessClassifier(device="cpu").load(path)
    np.testing.assert_array_equal(back.classes_, [-3, 7])
    np.testing.assert_array_equal(back.predict(Xs), clf.predict(Xs))
    np.testing.assert_array_equal(back.predict_proba(Xs),
                                  clf.predict_proba(Xs))


@pytest.mark.parametrize("entry", ["GaussianProcessClassifier",
                                   "SparseGaussianProcessClassifier",
                                   "VGPClassificationModel",
                                   "SparseEPClassificationModel"])
def test_entry_points_without_a_device_refuse_the_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    X, y, _ = _data(n=12, q=2)
    if hasattr(models, entry):
        call = lambda: getattr(models, entry)().fit(X, y)
    else:
        call = lambda: getattr(tcs, entry)(X, y, tk.RBF(2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def _principal_angles(A, B):
    Qa, Qb = np.linalg.qr(A)[0], np.linalg.qr(B)[0]
    s = np.clip(np.linalg.svd(Qa.T @ Qb, compute_uv=False), -1, 1)
    return np.degrees(np.arccos(s))


@pytest.mark.parametrize("cls,kw", [
    ("GaussianProcessClassifier", {"inference": "vi"}),
    ("GaussianProcessClassifier", {"inference": "ep"}),
    ("SparseGaussianProcessClassifier", {"num_inducing": 40}),
    ("SparseGaussianProcessClassifier", {"num_inducing": 40,
                                         "inference": "ep"})])
def test_small_edr_matches_jax(cls, kw):
    """EDR over each classifier on a planted 1-D direction in Q=3, N=40:
    the port's subspace and the JAX package's agree (principal angle), and
    both come as close to the direction.  The sparse models take M = N: with fewer
    inducing inputs their fits (Z included) stop far from converged, at
    different points in the two packages."""
    rng = np.random.default_rng(8)
    X = rng.normal(size=(40, 3))
    b = np.array([[1.0], [-1.0], [0.0]]) / np.sqrt(2)
    y = ((X @ b)[:, 0] + 0.3 * rng.normal(size=40) > 0).astype(int)
    J = {"GaussianProcessClassifier": JGPC,
         "SparseGaussianProcessClassifier": JSGPC}[cls]
    ours = EffectiveDimensionalityReduction(
        getattr(models, cls)(device="cpu", **kw), SVDTransformer(),
        n_components=1).fit(X, y, max_iters=100)
    ref = JEDR(J(**kw), JSVD(), n_components=1).fit(X, y, max_iters=100)
    angle = _principal_angles(ours.components_.T, ref.components_.T)[0]
    assert angle < 1.0
    # 40 noisy labels place the direction to within ~12 degrees
    d_ours = discrepancy(b, ours.components_.T)
    assert abs(d_ours - discrepancy(b, ref.components_.T)) < 0.02
    assert d_ours < 0.3

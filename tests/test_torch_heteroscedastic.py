"""The port's heteroscedastic GP regressor (edrgp_tpu_torch.models.
heteroscedastic) and the per-row noise of ``ops.exact.RBFKy`` against the
JAX package in float64 on the CPU.

Parameters travel from the JAX pytree into the port with
``convert.params_from_jax``; the NLML's gradient goes through RBFKy's fused
backward (the plain version of kernel A on the CPU) for the RBF kernel and
through autograd of ``kernel.K`` for any other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrgp_tpu import EffectiveDimensionalityReduction as JEDR
from edrgp_tpu import SVDTransformer as JSVD
from edrgp_tpu.models import heteroscedastic as jhet
from edrgp_tpu.ops import kernels as jk
from edrgp_tpu_torch import EffectiveDimensionalityReduction, SVDTransformer
from edrgp_tpu_torch import models
from edrgp_tpu_torch.convert import params_from_jax
from edrgp_tpu_torch.models import GaussianProcessHeteroscedasticRegressor
from edrgp_tpu_torch.models.heteroscedastic import (HeteroscedasticGPModel,
                                                    het_nlml)
from edrgp_tpu_torch.models.state import load_model
from edrgp_tpu_torch.ops import exact
from edrgp_tpu_torch.ops import kernels as tk
from edrgp_tpu_torch.ops.kernels import positive


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * 1e-3 * max(np.abs(want).max(), 1))


def _data(n=40, q=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, q))
    sig = 0.05 + 0.3 * (np.arange(n) % 4) / 3
    y = np.sin(X @ rng.normal(size=q)) + sig * rng.normal(size=n)
    return X, y, rng.normal(size=(9, q))


def _pair(X, y, meta, kernel="RBF", seed=1):
    """(JAX model, port model) at the same non-default parameters."""
    rng = np.random.default_rng(seed)
    q = X.shape[1]
    jkern = getattr(jk, kernel)(q, ARD=True)
    jm = jhet.HeteroscedasticGPModel(X, y, jkern, Y_metadata=meta)
    p = jax.tree_util.tree_map(np.asarray, jm.params)
    p["kernel"] = {"variance": np.array(0.7),
                   "lengthscale": rng.uniform(-0.2, 1.0, q)}
    p["raw_noise"] = rng.uniform(-4.0, -1.0, p["raw_noise"].shape)
    jm.params = jax.tree_util.tree_map(jnp.asarray, p)
    tm = HeteroscedasticGPModel(X, y, getattr(tk, kernel)(q, ARD=True),
                                Y_metadata=meta, device="cpu")
    tm.load_state_dict(params_from_jax(p))
    return jm, tm


META = {"per_point": None,
        "grouped": {"output_index": np.arange(40) % 4 * 3 + 1}}


@pytest.mark.parametrize("kernel", ["RBF", "Matern32"])
@pytest.mark.parametrize("meta", list(META))
def test_het_nlml_and_gradients_match_jax(meta, kernel):
    """The NLML and its gradient in every parameter (each group's noise
    among them) against the JAX package's autodiff of ``_het_nlml``; the
    RBF's goes through RBFKy with a noise vector."""
    X, y, _ = _data()
    jm, tm = _pair(X, y, META[meta], kernel)
    val, g = jax.value_and_grad(lambda pp: jhet._het_nlml(
        jm.kernel, pp, jm._X, jm._y, jm._idx))(jm.params)
    tm.zero_grad()
    loss = het_nlml(tm, tm._X, tm._y, tm._idx)
    loss.backward()
    _close(loss.item(), val, 1e-10)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, g))
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), 1e-8)
    assert tm.raw_noise.shape == (40 if meta == "per_point" else 4,)


@pytest.mark.parametrize("noise", ["scalar", "vector"])
def test_rbfky_noise_backward_matches_autograd(noise):
    """RBFKy's closed-form backward against autograd through the plain
    K + diag(noise), for a symmetric cotangent, in ℓ, σ², the noise and
    X."""
    rng = np.random.default_rng(2)
    X = torch.tensor(rng.normal(size=(25, 3)), requires_grad=True)
    ls = torch.tensor(rng.uniform(0.5, 2.0, 3), requires_grad=True)
    var = torch.tensor(1.3, requires_grad=True)
    nz = torch.tensor(rng.uniform(0.01, 0.5, 25 if noise == "vector" else ()),
                      requires_grad=True)
    W = torch.tensor(rng.normal(size=(25, 25)))
    W = W + W.T
    got = torch.autograd.grad((exact.RBFKy.apply(ls, var, nz, X) * W).sum(),
                              (ls, var, nz, X))
    K = var * torch.exp(-0.5 * tk.sq_dist(X / ls, X / ls))
    plain = K + torch.diag(nz.expand(25))
    want = torch.autograd.grad((plain * W).sum(), (ls, var, nz, X))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a.numpy(), b.numpy(), 1e-10)


@pytest.mark.parametrize("meta", list(META))
def test_het_predict_noise_and_gradients_match_jax(meta):
    """Latent predict (with and without the mean-noise band), the learned
    noise per group and per point, and dμ/dx* by the G route against the
    JAX package's."""
    X, y, Xs = _data()
    jm, tm = _pair(X, y, META[meta])
    for incl in (False, True):
        for a, b in zip(tm.predict(Xs, include_likelihood=incl),
                        jm.predict(Xs, include_likelihood=incl)):
            _close(a, b, 1e-8)
    _close(tm.group_noise_variances_, jm.group_noise_variances_, 1e-12)
    _close(tm.noise_variances_, jm.noise_variances_, 1e-12)
    _close(tm.noise_variance, jm.noise_variance, 1e-12)
    np.testing.assert_array_equal(tm.groups_, jm.groups_)
    _close(tm.log_likelihood(), jm.log_likelihood(), 1e-10)
    dmu, dvar = tm.predictive_gradients(Xs)
    _close(dmu, jm.predictive_gradients(Xs)[0], 1e-8)
    # the JAX package's route is its fused mean-gradient op; hold the port
    # against plain autodiff of the JAX latent mean as well
    _, alpha = jm._posterior()
    mean = lambda x: (jm.kernel.K(jm.params["kernel"], x[None], jm._X)[0]
                      @ alpha) * jm.normalizer.std
    _close(dmu[:, :, 0], jax.vmap(jax.grad(mean))(jnp.asarray(Xs)), 1e-8)
    assert not dvar.any()


def test_het_fit_matches_jax():
    """One float64 ML-II fit with grouped noise in each package, from the
    same start, reaches the same NLML and group noises."""
    X, y, Xs = _data(n=40, q=2, seed=3)
    meta = {"output_index": np.arange(40) % 2}
    jm, tm = _pair(X, y, meta)
    jm.optimize(max_iters=300)
    tm.optimize_restarts(num_restarts=5, max_iters=300)
    _close(tm.log_likelihood(), jm.log_likelihood(), 1e-7)
    _close(tm.group_noise_variances_, jm.group_noise_variances_, 1e-4)
    _close(tm.predict(Xs)[0], np.asarray(jm.predict(Xs)[0]), 1e-5)


def test_het_save_load_and_metadata(tmp_path):
    X, y, Xs = _data()
    meta = {"output_index": np.repeat([7, 3], 20)}
    _, tm = _pair(X, y, meta)
    path = str(tmp_path / "het.pickle")
    tm.pickle(path)
    loaded = load_model(path, device="cpu")
    assert type(loaded) is HeteroscedasticGPModel
    assert list(loaded.groups_) == [3, 7]
    assert loaded.Y_metadata is not None
    np.testing.assert_array_equal(loaded.noise_variances_,
                                  tm.noise_variances_)
    for a, b in zip(loaded.predict(Xs), tm.predict(Xs)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(loaded.predictive_gradients(Xs)[0],
                                  tm.predictive_gradients(Xs)[0])
    est = GaussianProcessHeteroscedasticRegressor(device="cpu").load(path)
    np.testing.assert_array_equal(est.predict(Xs), tm.predict(Xs)[0][:, 0])
    with pytest.raises(ValueError, match="3 entries for 40 observations"):
        HeteroscedasticGPModel(X, y, tk.RBF(3), device="cpu",
                               Y_metadata={"output_index": [0, 1, 0]})
    jhet.HeteroscedasticGPModel(X, y, jk.RBF(3)).pickle(
        str(tmp_path / "j.pickle"))
    with pytest.raises(ValueError, match="not a model pickle"):
        load_model(str(tmp_path / "j.pickle"), device="cpu")


def test_het_estimator_surface():
    X, y, _ = _data(n=20)
    est = GaussianProcessHeteroscedasticRegressor(device="cpu")
    assert est._estimator_type == "regressor"
    assert est.get_params()["device"] == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            models.GaussianProcessHeteroscedasticRegressor().fit(X, y)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            HeteroscedasticGPModel(X, y, tk.RBF(3))
    m = HeteroscedasticGPModel(X, y, tk.RBF(3), device="cpu", noise_var=0.3)
    _close(positive(m.raw_noise.detach()).numpy(), np.full(20, 0.3), 1e-12)


def test_small_edr_matches_jax():
    """EDR over the heteroscedastic regressor with grouped noise on a
    planted 1-D direction: the port's subspace is the JAX package's."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(60, 3))
    b = np.array([[1.0], [0.0], [1.0]]) / np.sqrt(2)
    meta = {"output_index": np.arange(60) % 3}
    y = np.tanh((X @ b)[:, 0]) + np.array([0.02, 0.1, 0.2])[
        meta["output_index"]] * rng.normal(size=60)
    ours = EffectiveDimensionalityReduction(
        GaussianProcessHeteroscedasticRegressor(Y_metadata=meta,
                                                device="cpu"),
        SVDTransformer(), n_components=1).fit(X, y, max_iters=200)
    ref = JEDR(jhet.GaussianProcessHeteroscedasticRegressor(Y_metadata=meta),
               JSVD(), n_components=1).fit(X, y, max_iters=200)
    c, r = ours.components_[0], ref.components_[0]
    cos = abs(c @ r) / np.linalg.norm(c) / np.linalg.norm(r)
    assert np.degrees(np.arccos(min(cos, 1.0))) < 0.5
    assert abs(c @ b[:, 0]) / np.linalg.norm(c) > 0.99

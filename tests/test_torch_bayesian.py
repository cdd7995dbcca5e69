"""The port's fully Bayesian GP regressor (edrgp_tpu_torch.models.bayesian)
against the JAX package, float64 on the CPU.

The fitted fixture holds the JAX test file's bars (``tests/test_bayesian.py``)
on its own fit, since the two packages draw different random numbers; at
fixed posterior samples the port's ``predict`` and ``predictive_gradients``
are held to a JAX ``BayesianGPModel`` built by ``_load`` from the same
samples (1e-10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrgp_tpu.models import bayesian as jbayes
from edrgp_tpu.models.state import Normalizer as JNormalizer
from edrgp_tpu.ops import kernels as jkernels
from edrgp_tpu_torch import EffectiveDimensionalityReduction, SVDTransformer
from edrgp_tpu_torch.convert import samples_from_jax
from edrgp_tpu_torch.estimator import clone
from edrgp_tpu_torch.models import BayesianGaussianProcessRegressor
from edrgp_tpu_torch.models.bayesian import BayesianGPModel
from edrgp_tpu_torch.models.state import load_model
from edrgp_tpu_torch.ops import kernels as tkernels


def _tanh_data(seed, n=70):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2))
    return X, np.tanh(X[:, 0]) + 0.1 * rng.normal(size=n)


@pytest.fixture(scope="module")
def fitted():
    # 4 chains × 150 draws after 150 warmup (the JAX test: 200 + 200): 600
    # draws of a 4-dimensional posterior keep split-R̂ well under 1.1
    X, y = _tanh_data(0)
    bgp = BayesianGaussianProcessRegressor(
        kernels=["RBF"], kernel_options=[{"ARD": True}], num_chains=4,
        num_warmup=150, num_samples=150, device="cpu")
    bgp.fit(X, y)
    return bgp, X, y


def test_chains_mix(fitted):
    bgp, _, _ = fitted
    diag = bgp.estimator_.diagnostics_
    assert diag["rhat"].max() < 1.1
    assert diag["divergences"] < 20
    assert diag["step_size"].shape == (4,)
    assert bgp.estimator_.samples_.shape == (32, 4)


def test_posterior_prediction(fitted):
    bgp, X, _ = fitted
    pred = bgp.predict(X)
    assert np.sqrt(np.mean((pred - np.tanh(X[:, 0])) ** 2)) < 0.1
    assert np.all(bgp.predict_variance(X) > 0)
    # the noise posterior brackets the truth (0.01) loosely
    assert 0.003 < bgp.estimator_.noise_variance < 0.1


def test_posterior_gradients_shape_and_direction(fitted):
    bgp, X, _ = fitted
    g = bgp.predict_gradient(X[:20])
    assert g.shape == (20, 2)
    # the target depends on dimension 0 only
    assert np.abs(g[:, 0]).mean() > 5 * np.abs(g[:, 1]).mean()


def test_bayesian_save_load_roundtrip(fitted, tmp_path):
    bgp, X, _ = fitted
    path = str(tmp_path / "bayes")
    bgp.save(path)
    bgp2 = BayesianGaussianProcessRegressor(device="cpu").load(path)
    assert isinstance(bgp2.estimator_, BayesianGPModel)
    np.testing.assert_array_equal(bgp2.predict(X), bgp.predict(X))
    np.testing.assert_array_equal(bgp2.predict_gradient(X[:10]),
                                  bgp.predict_gradient(X[:10]))
    assert bgp2.estimator_.log_likelihood() \
        == bgp.estimator_.log_likelihood()
    np.testing.assert_array_equal(bgp2.estimator_.diagnostics_["rhat"],
                                  bgp.estimator_.diagnostics_["rhat"])


def test_get_params_and_clone():
    est = BayesianGaussianProcessRegressor(num_chains=3, max_models=8,
                                           device="cpu")
    params = est.get_params()
    assert params["num_chains"] == 3 and params["max_models"] == 8
    assert params["device"] == "cpu" and params["target_accept"] == 0.9
    twin = clone(est)
    assert twin is not est and twin.get_params() == params


@pytest.fixture(scope="module")
def fixed_pair(tmp_path_factory):
    """(JAX model, port model, X*) at the same 5 posterior samples."""
    rng = np.random.default_rng(3)
    X, y = _tanh_data(2, n=40)
    port = BayesianGPModel(X, y, tkernels.RBF(2, ARD=True), device="cpu")
    samples = (np.array([0.3, 0.8, 0.2, -3.0])
               + 0.3 * rng.normal(size=(5, 4)))
    port.samples_ = samples_from_jax(samples, port.kernel)
    port._cache = None
    jmodel = jbayes.BayesianGPModel._load({
        "kernel": jkernels.RBF(2, ARD=True), "samples": samples, "X": X,
        "y": port._y.numpy(), "normalizer": JNormalizer(y)})
    return jmodel, port, rng.normal(size=(25, 2)), tmp_path_factory


@pytest.mark.parametrize("include_likelihood", [True, False])
def test_predict_matches_jax_at_fixed_samples(fixed_pair,
                                              include_likelihood):
    jmodel, port, Xs, _ = fixed_pair
    want = jmodel.predict(jnp.asarray(Xs), include_likelihood)
    got = port.predict(Xs, include_likelihood)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-10,
                                   atol=1e-12)


def test_predictive_gradients_match_jax_at_fixed_samples(fixed_pair):
    jmodel, port, Xs, _ = fixed_pair
    want = jmodel.predictive_gradients(jnp.asarray(Xs))
    got = port.predictive_gradients(Xs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-10,
                                   atol=1e-12)
    np.testing.assert_allclose(port.log_likelihood(),
                               jmodel.log_likelihood(), rtol=1e-10)
    np.testing.assert_allclose(port.noise_variance, jmodel.noise_variance,
                               rtol=1e-10)


def test_load_refuses_jax_pickle(fixed_pair):
    jmodel, _, _, tmp = fixed_pair
    path = str(tmp.mktemp("jax") / "bayes.pickle")
    jmodel.pickle(path)
    with pytest.raises(ValueError, match="not a model pickle"):
        load_model(path, device="cpu")


def test_bayesian_edr():
    # 2 chains × 100 draws after 100 warmup (the JAX test: 150 + 150): the
    # direction of a tanh ridge is clear from 200 posterior draws
    X, y = _tanh_data(1)
    edr = EffectiveDimensionalityReduction(
        BayesianGaussianProcessRegressor(
            kernels=["RBF"], kernel_options=[{"ARD": True}],
            num_chains=2, num_warmup=100, num_samples=100, device="cpu"),
        SVDTransformer(), n_components=1)
    edr.fit(X, y)
    c = edr.components_[0]
    c = c / np.linalg.norm(c)
    assert abs(abs(c[0]) - 1.0) < 0.05

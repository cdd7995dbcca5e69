"""The port's main path end to end (EDR → GP regressor → SVD) against the
JAX package, and the port's sklearn-free plumbing against scikit-learn.

The slice test drives the acceptance recipe of the JAX package (N=500, Q=2,
seed 5, float64, one component) through both packages.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import sklearn.base
import sklearn.preprocessing

import edrgp_tpu
import edrgp_tpu.datasets as jdatasets
import edrgp_tpu.utils as jutils
from edrgp_tpu.models import GaussianProcessRegressor as JGPR
import edrgp_tpu_torch
import edrgp_tpu_torch.datasets as tdatasets
import edrgp_tpu_torch.utils as tutils
from edrgp_tpu_torch.estimator import (NotFittedError, StandardScaler,
                                       check_array, check_X_y, clone,
                                       normalize_rows)
from edrgp_tpu_torch.models import GaussianProcessRegressor

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _recipe_data():
    rng = np.random.default_rng(5)
    X = jdatasets.get_gaussian_inputs(
        eig_values=[1, 0.3], sample_size=500,
        eig_vectors=np.array([[1, 1], [-1, 1]]), rng=rng)
    y = jdatasets.get_tanh_targets(X, [0.5, 0.5], rng=rng)
    return X, y


def test_edr_recipe_matches_jax():
    X, y = _recipe_data()
    jedr = edrgp_tpu.EffectiveDimensionalityReduction(
        JGPR(), edrgp_tpu.SVDTransformer(), n_components=1).fit(X, y)
    tedr = edrgp_tpu_torch.EffectiveDimensionalityReduction(
        GaussianProcessRegressor(device="cpu"),
        edrgp_tpu_torch.SVDTransformer(), n_components=1).fit(X, y)
    d = tutils.discrepancy(tutils._span(jedr.components_.T),
                           tedr.components_.T)
    assert d < 1e-3
    unit = tedr.components_[0] / np.linalg.norm(tedr.components_[0])
    assert abs(abs(unit @ np.array([1.0, 1.0])) / np.sqrt(2) - 1) < 1e-2
    np.testing.assert_allclose(tedr.subspace_variance_ratio_,
                               jedr.subspace_variance_ratio_, rtol=1e-3)
    # the final fit in the reduced space reaches the same optimum
    np.testing.assert_allclose(tedr.estimator_.estimator_.log_likelihood(),
                               jedr.estimator_.estimator_.log_likelihood(),
                               rtol=1e-6)
    np.testing.assert_allclose(tedr.transform(X[:5]), jedr.transform(X[:5]),
                               rtol=1e-3, atol=1e-6)


def test_regressor_predictions_match_jax():
    rng = np.random.default_rng(8)
    X = rng.uniform(-2, 2, size=(60, 2))
    y = np.sin(X[:, 0]) * X[:, 1] + 0.05 * rng.normal(size=60)
    Xt = rng.uniform(-2, 2, size=(15, 2))
    kw = dict(kernels="RBF", kernel_options={"ARD": True})
    j = JGPR(**kw).fit(X, y)
    t = GaussianProcessRegressor(device="cpu", **kw).fit(X, y)
    np.testing.assert_allclose(t.predict(Xt), j.predict(Xt), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t.predict_variance(Xt), j.predict_variance(Xt),
                               rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(t.predict_gradient(Xt), j.predict_gradient(Xt),
                               rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="features"):
        t.predict(Xt[:, :1])
    with pytest.raises(NotFittedError):
        GaussianProcessRegressor().predict(Xt)


def test_import_leaves_jax_and_sklearn_out():
    code = ("import sys, edrgp_tpu_torch, edrgp_tpu_torch.models, "
            "edrgp_tpu_torch.datasets, edrgp_tpu_torch.convert, "
            "edrgp_tpu_torch.decomposition, edrgp_tpu_torch.entry; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'sklearn', 'optax', 'edrgp_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA, and alone in a directory, the smoke script exits
    non-zero and prints no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    script = os.path.join(REPO, "chip_smoke.py")
    for cwd, path in ((REPO, script), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            path.write_text(open(script).read())
        proc = subprocess.run([sys.executable, str(path)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_datasets_match_jax():
    for name, args in [("get_beta_inputs", (50, 4)),
                       ("get_gaussian_inputs", (30, [1.0, 0.5],
                                                np.eye(2)))]:
        a = getattr(jdatasets, name)(*args, rng=np.random.default_rng(1))
        b = getattr(tdatasets, name)(*args, rng=np.random.default_rng(1))
        np.testing.assert_array_equal(a, b)
    X = np.random.default_rng(2).normal(size=(40, 3))
    for d in (1, 2, 3):
        np.testing.assert_array_equal(
            jdatasets.get_edr_target(X[:, :d], 0.1, np.random.default_rng(3)),
            tdatasets.get_edr_target(X[:, :d], 0.1, np.random.default_rng(3)))
    np.testing.assert_array_equal(
        jdatasets.get_tanh_targets(X, [1, 2, 3], rng=np.random.default_rng(4)),
        tdatasets.get_tanh_targets(X, [1, 2, 3], rng=np.random.default_rng(4)))


def test_utils_match_jax():
    rng = np.random.default_rng(0)
    G = rng.normal(size=(80, 5)) @ np.diag([3.0, 2.0, 1.0, 0.1, 0.01])
    for nc in (None, 2, 0.9):
        j = jutils.SVDTransformer(nc).fit(G)
        t = tutils.SVDTransformer(nc).fit(G)
        np.testing.assert_allclose(np.abs(t.components_),
                                   np.abs(j.components_), atol=1e-12)
        np.testing.assert_allclose(t.subspace_variance_ratio_,
                                   j.subspace_variance_ratio_, rtol=1e-12)
        tg = tutils.SVDTransformer(nc).fit_gram(G.T @ G)
        np.testing.assert_allclose(tg.subspace_variance_,
                                   t.subspace_variance_, rtol=1e-9)
    V = rng.normal(size=(5, 2))
    B = np.linalg.qr(rng.normal(size=(5, 2)))[0]
    for fn in ("subspace_variance_ratio",):
        np.testing.assert_allclose(getattr(tutils, fn)(G, V),
                                   getattr(jutils, fn)(G, V), rtol=1e-12)
    assert tutils.discrepancy(B, V) == pytest.approx(
        jutils.discrepancy(B, V), rel=1e-12)
    np.testing.assert_allclose(tutils.ort_space(V), jutils.ort_space(V))
    # fixes over the JAX package: zero gradients raise, a duplicated
    # column does not widen the estimated span
    with pytest.raises(ValueError, match="all-zero"):
        tutils.SVDTransformer(1).fit(np.zeros((4, 3)))
    with pytest.raises(ValueError, match="all-zero"):
        tutils.SVDTransformer(1).fit_gram(np.zeros((3, 3)))
    dup = np.stack([B[:, 0], B[:, 0]], axis=1)
    assert tutils.discrepancy(B, dup) == pytest.approx(
        tutils.discrepancy(B, B[:, :1]))


def test_estimator_plumbing_matches_sklearn():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(20, 3)) * [1.0, 2.0, 0.0] + [0.0, 1.0, 5.0]
    sk = sklearn.preprocessing.StandardScaler().fit(X)
    ours = StandardScaler().fit(X)
    np.testing.assert_allclose(ours.scale_, sk.scale_)
    np.testing.assert_allclose(ours.transform(X), sk.transform(X))
    np.testing.assert_allclose(normalize_rows(X),
                               sklearn.preprocessing.normalize(X))
    edr = edrgp_tpu_torch.EffectiveDimensionalityReduction(
        GaussianProcessRegressor(kernels="RBF", device="cpu"),
        edrgp_tpu_torch.SVDTransformer(2), n_components=2, step=1)
    params = edr.get_params()
    assert params["dr_transformer__n_components"] == 2
    assert params["estimator__device"] == "cpu"
    twin = clone(edr)
    assert twin.estimator is not edr.estimator
    assert twin.get_params(deep=False).keys() == \
        edr.get_params(deep=False).keys()
    edr.set_params(estimator__noise_var=0.5, step=None)
    assert edr.estimator.noise_var == 0.5 and edr.step is None
    # every constructor argument is stored, so each EDR class clones
    for cls in (edrgp_tpu_torch.BaseEDR, edrgp_tpu_torch.IterativeEDR):
        base = cls(GaussianProcessRegressor(device="cpu"),
                   edrgp_tpu_torch.SVDTransformer(), n_components=1)
        assert clone(base).get_params(deep=False).keys() == \
            base.get_params(deep=False).keys()
    with pytest.raises(ValueError):
        check_array(np.array([1.0, np.nan]).reshape(-1, 1))
    with pytest.raises(ValueError):
        check_array(np.zeros(3))
    with pytest.raises(ValueError):
        check_X_y(np.zeros((3, 2)), np.zeros(4))
    with pytest.raises(TypeError, match="DeviceMesh"):
        edrgp_tpu_torch.EffectiveDimensionalityReduction(
            GaussianProcessRegressor(device="cpu"),
            edrgp_tpu_torch.SVDTransformer(), gradient_mesh=object()).fit(
                X, X[:, 0])


class _CubicGradient(sklearn.base.BaseEstimator):
    """A stand-in estimator whose gradient field is x + x³ in any
    dimension, so both EDR layers see identical gradients."""

    def __init__(self, scale=1.0):
        self.scale = scale

    def fit(self, X, y, **_):
        self.n_features_ = X.shape[1]
        return self

    def predict_gradient(self, X):
        return self.scale * (X + X ** 3)


@pytest.mark.parametrize("mode", ["BlockEDR", "edr_blocks", "edr_auto"])
def test_block_mode_matches_jax(mode):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(60, 5)) * [1.0, 2.0, 0.5, 1.0, 3.0]
    y = X[:, 0]
    models = []
    for pkg in (edrgp_tpu, edrgp_tpu_torch):
        if mode == "BlockEDR":
            m = pkg.BlockEDR(_CubicGradient(), pkg.SVDTransformer(),
                             n_components=1, blocks=[[0, 1], [2, 3, 4]])
        elif mode == "edr_blocks":
            m = pkg.EffectiveDimensionalityReduction(
                _CubicGradient(), pkg.SVDTransformer(), n_components=[1, 2],
                blocks=[[0, 1], [2, 3, 4]])
        else:
            m = pkg.EffectiveDimensionalityReduction(
                _CubicGradient(), pkg.SVDTransformer(), n_components=[1, 1])
        m.fit(X, y)
        m.refit(pkg.SVDTransformer(1) if mode == "BlockEDR"
                else pkg.SVDTransformer(2))
        models.append(m)
    j, t = models
    np.testing.assert_allclose(np.abs(t.components_), np.abs(j.components_),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.abs(t.refit_components_),
                               np.abs(j.refit_components_), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(t.subspace_variance_ratio_,
                               j.subspace_variance_ratio_, rtol=1e-10)

"""The port end to end: its main path (EDR → GP regressor → SVD) against the
JAX package, its sklearn-free plumbing against scikit-learn, its entry
points against ``__graft_entry__.py``, and the drift guard over the
reference's notebook workloads.

The slice test drives the acceptance recipe of the JAX package (N=500, Q=2,
seed 5, float64, one component) through both packages.  ``entry()``'s NLML
value and gradient are held against the JAX package's ``exact.nlml`` at
the same float64 inputs, and ``dryrun_multichip`` runs in 4 gloo ranks on
the CPU.

The notebook workloads are the port's counterpart of
``tests/test_parity_drift.py``.  Each is defined as in
``benchmarks/parity_runs.py`` and runs through the port only (its GP, its
EDR, its own PCA and SparsePCA; float64 on the CPU) over 3 seeds; the
3-seed mean must lie in the 3σ band around the JAX package's pinned
20-seed mean (``tests/parity_baseline.json``):
|mean₃ − mean₂₀| ≤ 3·std·√(1/3 + 1/20).  Mutual information is
scikit-learn's ``mutual_info_regression``, in the test only.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import sklearn.base
import sklearn.preprocessing
import torch
from scipy.linalg import eigh
from sklearn.feature_selection import mutual_info_regression

from torch_ranks import one_torch_thread  # noqa: F401 (autouse)
import edrgp_tpu
import edrgp_tpu.datasets as jdatasets
import edrgp_tpu.utils as jutils
from edrgp_tpu.models import GaussianProcessRegressor as JGPR
from edrgp_tpu.ops import exact as jexact
from edrgp_tpu.ops import kernels as jkernels
import edrgp_tpu_torch
import edrgp_tpu_torch.datasets as tdatasets
import edrgp_tpu_torch.utils as tutils
from edrgp_tpu_torch import (EffectiveDimensionalityReduction, SVDTransformer,
                             discrepancy)
from edrgp_tpu_torch.convert import params_to_numpy
from edrgp_tpu_torch.datasets import (get_beta_inputs, get_edr_target,
                                      get_gaussian_inputs, get_tanh_targets)
from edrgp_tpu_torch.decomposition import PCA, SparsePCA
from edrgp_tpu_torch.entry import dryrun_multichip, entry
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
    """Importing the port, and fitting its PCA with the randomized and
    ARPACK solvers, loads neither JAX, scikit-learn nor the JAX package."""
    code = ("import sys, numpy as np, edrgp_tpu_torch, "
            "edrgp_tpu_torch.models, edrgp_tpu_torch.datasets, "
            "edrgp_tpu_torch.convert, edrgp_tpu_torch.decomposition, "
            "edrgp_tpu_torch.entry, edrgp_tpu_torch.parallel.edr_sharded; "
            "from edrgp_tpu_torch.decomposition import PCA; "
            "X = np.random.default_rng(0).normal(size=(40, 6)); "
            "[PCA(2, svd_solver=s, random_state=0).fit(X) "
            "for s in ('randomized', 'arpack')]; "
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


def _jax_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.entry()


def test_entry_matches_jax():
    fn, (gp, X, y) = entry(device="cpu")
    value, grads = fn(gp, X, y)
    assert X.dtype == torch.float64 and X.shape == (2048, 8)

    # the JAX entry point's inputs and parameters, drawn in float32
    _, (jparams, jX, jy) = _jax_entry()
    np.testing.assert_array_equal(X.numpy(), np.asarray(jX, np.float64))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy, np.float64))
    # the same parameters: the JAX ones computed in float32 (2 ulps)
    params = params_to_numpy(gp)
    for got, want in zip(jax.tree_util.tree_leaves(params),
                         jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(got, want, rtol=2.5e-7)

    kernel = jkernels.RBF(8, ARD=True)
    want_v, want_g = jax.value_and_grad(
        lambda p: jexact.nlml(kernel, p, jnp.asarray(X.numpy()),
                              jnp.asarray(y.numpy())))(
        jax.tree_util.tree_map(jnp.asarray, params))
    np.testing.assert_allclose(float(value), float(want_v), rtol=1e-10)
    want = {"raw_noise": want_g["raw_noise"],
            "kernel.variance": want_g["kernel"]["variance"],
            "kernel.lengthscale": want_g["kernel"]["lengthscale"]}
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   rtol=1e-10, err_msg=name)


def test_dryrun_multichip_in_four_gloo_ranks():
    out = dryrun_multichip(4, device="cpu")
    assert len(out) == 4
    for rank in out:
        assert rank["nuts_shape"] == (4, 8, 2)
        assert np.isfinite(rank["svgp_elbo"])
        assert np.isfinite(rank["sharded_fit_nlml"])
    # every rank fits the same sharded EDR and sums the same NLML
    for rank in out[1:]:
        np.testing.assert_array_equal(rank["edr_components"],
                                      out[0]["edr_components"])
        assert rank["sharded_nlml"] == out[0]["sharded_nlml"]


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(4)


SEEDS = (0, 1, 2)

with open(os.path.join(os.path.dirname(__file__),
                       "parity_baseline.json")) as f:
    BASELINE = json.load(f)["workloads"]


def _check(workload, runs):
    base = BASELINE[workload]
    mean3 = float(np.mean(runs))
    band = 3.0 * base["std"] * np.sqrt(1 / len(runs) + 1 / base["seeds"])
    assert np.all(np.isfinite(runs)), f"{workload}: non-finite values {runs}"
    assert abs(mean3 - base["mean"]) <= band, (
        f"{workload} drifted: 3-seed mean {mean3:.4f} vs pinned "
        f"{base['mean']:.4f} ± {band:.4f} (per-seed values {runs})")


def _gpr(ard=False):
    if ard:
        return GaussianProcessRegressor(["RBF"], [{"ARD": True}],
                                        device="cpu")
    return GaussianProcessRegressor(device="cpu")


def _mi(edr, X, y):
    return mutual_info_regression(edr.transform(X), y, random_state=0)[0]


def test_regression_example_edr_mi_pinned():
    """regression.ipynb: PCA as the DR method."""
    runs = []
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        X = get_gaussian_inputs(eig_values=[1, 0.3], sample_size=500,
                                eig_vectors=np.array([[1, 1], [-1, 1]]),
                                rng=rng)
        X -= X.mean(0)
        y = get_tanh_targets(X, [0.5, 0.5], rng=rng)
        edr = EffectiveDimensionalityReduction(
            _gpr(), PCA(n_components=1), n_components=1).fit(X, y)
        runs.append(_mi(edr, X, y))
    _check("regression_example_edr_mi", runs)


def test_brief_intro_one_shot_discrepancy_pinned():
    runs = []
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        X = get_beta_inputs(200, 10, rng=rng)
        B = np.linalg.qr(rng.normal(size=(10, 2)))[0]
        y = get_edr_target(X @ B, sigma=0.1, rng=rng)
        edr = EffectiveDimensionalityReduction(
            _gpr(ard=True), SVDTransformer(), normalize=False).fit(X, y)
        runs.append(discrepancy(B, edr.components_.T[:, :2]))
    _check("brief_intro_edr_discrepancy", runs)


def test_chain_pca_corr_preprocessed_mi_pinned():
    """chain_PCA-EDRGP.ipynb: PCA as the preprocessor, correlated inputs."""
    cov = np.array([[1, 0.9, 0.01], [0.9, 1, -0.1], [0.01, -0.1, 1]])
    w, v = eigh(cov)
    runs = []
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        X = get_gaussian_inputs(eig_values=w, sample_size=500,
                                eig_vectors=v, rng=rng)
        X -= X.mean(0)
        y = get_tanh_targets(X, 0.5 * np.ones(3), rng=rng)
        edr = EffectiveDimensionalityReduction(
            _gpr(), SVDTransformer(), n_components=1,
            preprocessor=PCA(n_components=2)).fit(X, y)
        runs.append(_mi(edr, X, y))
    _check("chain_pca_corr_preprocessed_mi", runs)


def test_brief_intro_sparse_refit_pinned():
    """BriefIntro.ipynb cells 60-69: the sparse projector, its SVD
    discrepancy held to the band, then ``refit(SparsePCA(alpha=2))``: two
    unit components, sparser than the SVD's, on B_sparse's subspace."""
    B_sparse = np.linalg.qr(
        scipy.sparse.random(10, 2, density=0.2, random_state=11).toarray())[0]
    runs, refits = [], []
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        X = get_beta_inputs(200, 10, rng=rng)
        y = get_edr_target(X @ B_sparse, sigma=0.1, rng=rng)
        edr = EffectiveDimensionalityReduction(
            _gpr(ard=True), SVDTransformer(), normalize=False).fit(X, y)
        runs.append(discrepancy(B_sparse, edr.components_.T[:, :2]))
        edr.refit(SparsePCA(n_components=2, alpha=2, random_state=0))
        comps = edr.refit_components_
        assert comps.shape == (2, 10) and np.isfinite(comps).all()
        np.testing.assert_allclose(np.linalg.norm(comps, axis=1), 1.0)
        assert (comps == 0).sum() > (edr.components_[:2] == 0).sum()
        refits.append(discrepancy(B_sparse, comps.T))
    _check("brief_intro_sparse_discrepancy", runs)
    assert np.mean(refits) < 0.1, f"refit discrepancies {refits}"

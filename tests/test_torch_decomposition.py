"""The port's PCA and SparsePCA against scikit-learn's, the port's EDR with
them against the JAX package's EDR with scikit-learn's, and the port's
``get_branin_targets`` against the JAX package's; float64 on the CPU.

The gradient matrices SparsePCA is held on are the ones the reference's
notebooks refit: BriefIntro's (N=200, Q=10, the sparse projector
``B_sparse``) and sPCAvsPCA's (``examples/sparse_recovery.py``: N=500,
Q=8), each the cached first-fit gradients of the port's EDR.
"""

import importlib.util
import os

import numpy as np
import pytest
import scipy.sparse
import sklearn.decomposition as skd
from scipy.linalg import eigh

import edrgp_tpu
import edrgp_tpu.datasets as jdatasets
import edrgp_tpu_torch
import edrgp_tpu_torch.datasets as tdatasets
from edrgp_tpu.models import GaussianProcessRegressor as JGPR
from edrgp_tpu_torch.decomposition import PCA, SparsePCA
from edrgp_tpu_torch.estimator import clone
from edrgp_tpu_torch.models import GaussianProcessRegressor as TGPR

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _sparse_recovery():
    spec = importlib.util.spec_from_file_location(
        "sparse_recovery",
        os.path.join(REPO, "examples", "sparse_recovery.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _b_sparse():
    """BriefIntro's sparse projector (its cell 60: scipy RandomState(11))."""
    return np.linalg.qr(scipy.sparse.random(
        10, 2, density=0.2, random_state=11).toarray())[0]


def _brief_intro_sparse(seed=0, n=200):
    rng = np.random.default_rng(seed)
    X = jdatasets.get_beta_inputs(n, 10, rng=rng)
    return X, jdatasets.get_edr_target(X @ _b_sparse(), sigma=0.1, rng=rng)


def _port_edr(**kw):
    return edrgp_tpu_torch.EffectiveDimensionalityReduction(
        TGPR(["RBF"], [{"ARD": True}], device="cpu"),
        edrgp_tpu_torch.SVDTransformer(), **kw)


@pytest.fixture(scope="module")
def gradients():
    """The first-fit gradient matrices of the two notebooks' EDRs."""
    X, y = _brief_intro_sparse()
    brief = _port_edr(normalize=False).fit(X, y)._first_gradients_
    X, y, _ = _sparse_recovery().make_data()
    spca = _port_edr(n_components=3).fit(X, y)._first_gradients_
    return {"brief_intro": (brief, 2), "spca_vs_pca": (spca, 3)}


# ----------------------------------------------------------------- PCA

@pytest.mark.parametrize("n_components", [1, 2, 0.9, None])
@pytest.mark.parametrize("shape", [(200, 10), (500, 3)])
def test_pca_matches_sklearn(shape, n_components):
    rng = np.random.default_rng(sum(shape))
    X = rng.normal(size=shape) @ rng.normal(size=(shape[1], shape[1])) + 3.0
    want = skd.PCA(n_components=n_components).fit(X)
    got = PCA(n_components=n_components).fit(X)
    assert got.n_components_ == want.n_components_
    for name in ("components_", "explained_variance_",
                 "explained_variance_ratio_", "singular_values_", "mean_"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=1e-10, err_msg=name)
    Xt = rng.normal(size=(20, shape[1]))
    np.testing.assert_allclose(got.transform(Xt), want.transform(Xt),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.fit_transform(X), want.fit_transform(X),
                               rtol=0, atol=1e-10)


def test_pca_refuses_what_it_does_not_carry():
    """What scikit-learn refuses, and what the port does not carry, raise
    and name the option."""
    X = np.random.default_rng(0).normal(size=(30, 4))
    for kw, name in (({"n_components": 5}, "n_components"),
                     ({"n_components": 1.5}, "n_components"),
                     ({"n_components": "mle"}, "n_components"),
                     ({"svd_solver": "lobpcg"}, "svd_solver"),
                     ({"svd_solver": "randomized", "n_components": 0.5},
                      "n_components"),
                     ({"svd_solver": "arpack", "n_components": 4},
                      "n_components"),
                     ({"svd_solver": "randomized",
                       "power_iteration_normalizer": "Cholesky"},
                      "power_iteration_normalizer")):
        with pytest.raises(ValueError, match=name):
            PCA(**kw).fit(X)
    wide = np.random.default_rng(1).normal(size=(600, 100))
    with pytest.raises(ValueError, match="n_components"):
        PCA(n_components="mle").fit(wide)   # where "auto" weighs randomized


#: PCA's options against scikit-learn's, with their bars: whitening and
#: the randomized solver draw the same numbers and agree to 1e-10, ARPACK
#: to 1e-8.
OPTIONS = {"whiten": ({"whiten": True}, 1e-10),
           "randomized": ({"svd_solver": "randomized"}, 1e-10),
           "randomized_whiten": ({"svd_solver": "randomized",
                                  "whiten": True}, 1e-10),
           "arpack": ({"svd_solver": "arpack"}, 1e-8),
           "arpack_whiten": ({"svd_solver": "arpack", "whiten": True}, 1e-8)}


@pytest.mark.parametrize("random_state", [0, 1])
@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("matrix", ["brief_intro", "spca_vs_pca"])
def test_pca_options_match_sklearn(gradients, matrix, option, random_state):
    G, k = gradients[matrix]
    kw, tol = OPTIONS[option]
    kw = dict(kw, n_components=k, random_state=random_state)
    want = skd.PCA(**kw).fit(G)
    got = PCA(**kw).fit(G)
    assert got.n_components_ == want.n_components_
    for name in ("components_", "explained_variance_",
                 "explained_variance_ratio_", "singular_values_"):
        w = getattr(want, name)
        np.testing.assert_allclose(getattr(got, name), w, rtol=tol,
                                   atol=tol * np.abs(w).max(), err_msg=name)
    w = want.transform(G)
    np.testing.assert_allclose(got.transform(G), w, rtol=tol,
                               atol=tol * np.abs(w).max())


@pytest.mark.parametrize("port, sk", [
    (PCA(n_components=2, svd_solver="full"),
     skd.PCA(n_components=2, svd_solver="full")),
    (PCA(n_components=2, whiten=True, svd_solver="randomized",
         iterated_power=3, n_oversamples=5, power_iteration_normalizer="QR",
         random_state=4),
     skd.PCA(n_components=2, whiten=True, svd_solver="randomized",
             iterated_power=3, n_oversamples=5,
             power_iteration_normalizer="QR", random_state=4)),
    (PCA(n_components=2, svd_solver="arpack", tol=1e-9, random_state=1),
     skd.PCA(n_components=2, svd_solver="arpack", tol=1e-9,
             random_state=1)),
    (SparsePCA(n_components=3, alpha=2, ridge_alpha=0.1, random_state=0),
     skd.SparsePCA(n_components=3, alpha=2, ridge_alpha=0.1,
                   random_state=0))])
def test_params_are_sklearns(port, sk):
    """scikit-learn's names and values, and ``clone`` keeps them."""
    params = port.get_params()
    want = sk.get_params()
    assert {k: want[k] for k in params} == params
    copy = clone(port)
    assert copy is not port and copy.get_params() == params


# ----------------------------------------------------------- SparsePCA

@pytest.mark.parametrize("alpha", [1, 2])
@pytest.mark.parametrize("matrix", ["brief_intro", "spca_vs_pca"])
def test_sparse_pca_matches_sklearn(gradients, matrix, alpha):
    G, k = gradients[matrix]
    want = skd.SparsePCA(n_components=k, alpha=alpha, random_state=0).fit(G)
    got = SparsePCA(n_components=k, alpha=alpha, random_state=0).fit(G)
    assert got.n_iter_ == want.n_iter_
    np.testing.assert_array_equal(got.components_ == 0,
                                  want.components_ == 0)
    np.testing.assert_allclose(got.components_, want.components_, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.mean_, want.mean_, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.transform(G), want.transform(G), rtol=0,
                               atol=1e-8)


def test_sparse_pca_resamples_unused_atoms_as_sklearn():
    """More atoms than the data's rank: scikit-learn replaces the unused
    ones from its RandomState, and the port draws the same."""
    rng = np.random.default_rng(1)
    B = np.zeros((10, 2))
    B[1, 0], B[4, 0], B[7, 1] = 1.0, 0.5, 1.0
    G = (3.0 * rng.normal(size=(300, 2)) @ B.T
         + 0.1 * rng.normal(size=(300, 10)))
    for k, alpha in ((3, 1), (5, 5)):
        want = skd.SparsePCA(n_components=k, alpha=alpha,
                             random_state=0).fit(G)
        got = SparsePCA(n_components=k, alpha=alpha, random_state=0).fit(G)
        assert got.n_iter_ == want.n_iter_
        np.testing.assert_array_equal(got.components_ == 0,
                                      want.components_ == 0)
        np.testing.assert_allclose(got.components_, want.components_,
                                   rtol=0, atol=1e-6)


# ------------------------------------------ EDR with the port's DR methods

def _regression_data(n=200):
    rng = np.random.default_rng(0)
    X = jdatasets.get_gaussian_inputs(
        eig_values=[1, 0.3], sample_size=n,
        eig_vectors=np.array([[1, 1], [-1, 1]]), rng=rng)
    X -= X.mean(0)
    return X, jdatasets.get_tanh_targets(X, [0.5, 0.5], rng=rng)


def _chain_pca_data(n=200):
    cov = np.array([[1, 0.9, 0.01], [0.9, 1, -0.1], [0.01, -0.1, 1]])
    w, v = eigh(cov)
    rng = np.random.default_rng(0)
    X = jdatasets.get_gaussian_inputs(eig_values=w, sample_size=n,
                                      eig_vectors=v, rng=rng)
    X -= X.mean(0)
    return X, jdatasets.get_tanh_targets(X, 0.5 * np.ones(3), rng=rng)


def _block_data():
    rng = np.random.default_rng(0)
    X = jdatasets.get_beta_inputs(300, 10, rng=rng)
    B = np.linalg.qr(scipy.sparse.random(10, 3, density=0.4,
                                         random_state=0).toarray())[0]
    B[:5, :2] = 0
    B[5:, 2:] = 0
    return X, jdatasets.get_edr_target(X @ B, 0.1, rng=rng)


def _case(name):
    """(data, JAX EDR, port EDR, refit transformers or None, attribute)."""
    ard = ["RBF"], [{"ARD": True}]
    if name == "dr_method":
        return (_regression_data(),
                edrgp_tpu.EffectiveDimensionalityReduction(
                    JGPR(), skd.PCA(n_components=1), n_components=1),
                edrgp_tpu_torch.EffectiveDimensionalityReduction(
                    TGPR(device="cpu"), PCA(n_components=1), n_components=1),
                None, "components_")
    if name == "preprocessor":
        return (_chain_pca_data(),
                edrgp_tpu.EffectiveDimensionalityReduction(
                    JGPR(), edrgp_tpu.SVDTransformer(), n_components=1,
                    preprocessor=skd.PCA(n_components=2)),
                edrgp_tpu_torch.EffectiveDimensionalityReduction(
                    TGPR(device="cpu"), edrgp_tpu_torch.SVDTransformer(),
                    n_components=1, preprocessor=PCA(n_components=2)),
                None, "components_")
    if name == "whitened_preprocessor":
        return (_chain_pca_data(),
                edrgp_tpu.EffectiveDimensionalityReduction(
                    JGPR(), edrgp_tpu.SVDTransformer(), n_components=1,
                    preprocessor=skd.PCA(n_components=2, whiten=True)),
                edrgp_tpu_torch.EffectiveDimensionalityReduction(
                    TGPR(device="cpu"), edrgp_tpu_torch.SVDTransformer(),
                    n_components=1,
                    preprocessor=PCA(n_components=2, whiten=True)),
                None, "components_")
    if name == "refit":
        return (_brief_intro_sparse(),
                edrgp_tpu.EffectiveDimensionalityReduction(
                    JGPR(*ard), edrgp_tpu.SVDTransformer(), normalize=False),
                _port_edr(normalize=False),
                (skd.SparsePCA(n_components=2, alpha=2, random_state=0),
                 SparsePCA(n_components=2, alpha=2, random_state=0)),
                "refit_components_")
    blocks = {"n_components": [2, 2],
              "blocks": [list(range(5)), list(range(5, 10))]}
    return (_block_data(),
            edrgp_tpu.BlockEDR(JGPR(*ard), edrgp_tpu.SVDTransformer(),
                               **blocks),
            edrgp_tpu_torch.BlockEDR(TGPR(*ard, device="cpu"),
                                     edrgp_tpu_torch.SVDTransformer(),
                                     **blocks),
            (skd.SparsePCA(n_components=3, random_state=0),
             SparsePCA(n_components=3, random_state=0)),
            "refit_components_")


@pytest.mark.parametrize("name", ["dr_method", "preprocessor",
                                  "whitened_preprocessor", "refit",
                                  "block_refit"])
def test_edr_with_port_decomposition_matches_jax(name):
    (X, y), jedr, tedr, refit, attr = _case(name)
    jedr.fit(X, y)
    tedr.fit(X, y)
    if refit is not None:
        jedr.refit(refit[0])
        tedr.refit(refit[1])
    want, got = getattr(jedr, attr), getattr(tedr, attr)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_get_branin_targets_matches_jax():
    X = np.random.default_rng(3).uniform(size=(50, 2))
    np.testing.assert_array_equal(tdatasets.get_branin_targets(X),
                                  jdatasets.get_branin_targets(X))
    np.testing.assert_array_equal(
        tdatasets.get_branin_targets(X, 0.1, np.random.default_rng(4)),
        jdatasets.get_branin_targets(X, 0.1, np.random.default_rng(4)))

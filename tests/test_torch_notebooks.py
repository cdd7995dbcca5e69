"""Drift guard of the port over the reference's notebook workloads: the
port's counterpart of ``tests/test_parity_drift.py``.

Each workload is defined as in ``benchmarks/parity_runs.py`` and runs
through the port only (its GP, its EDR, its own PCA and SparsePCA; float64
on the CPU) over 3 seeds; the 3-seed mean must lie in the 3σ band around
the JAX package's pinned 20-seed mean (``tests/parity_baseline.json``):
|mean₃ − mean₂₀| ≤ 3·std·√(1/3 + 1/20).  Mutual information is
scikit-learn's ``mutual_info_regression``, in the test only.
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse
import torch
from scipy.linalg import eigh
from sklearn.feature_selection import mutual_info_regression

from edrgp_tpu_torch import (EffectiveDimensionalityReduction, SVDTransformer,
                             discrepancy)
from edrgp_tpu_torch.datasets import (get_beta_inputs, get_edr_target,
                                      get_gaussian_inputs, get_tanh_targets)
from edrgp_tpu_torch.decomposition import PCA, SparsePCA
from edrgp_tpu_torch.models import GaussianProcessRegressor

SEEDS = (0, 1, 2)

with open(os.path.join(os.path.dirname(__file__),
                       "parity_baseline.json")) as f:
    BASELINE = json.load(f)["workloads"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's small fits: the suite's workers
    share the machine's cores, and torch's default thread count there makes
    each small operation wait on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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

"""The port's data-parallel EDR composition (edrgp_tpu_torch.parallel.
edr_sharded, ``EffectiveDimensionalityReduction(gradient_mesh=...)``)
against the JAX package, float64 on the CPU.

Models are fitted here by the port, saved, and loaded by 4 gloo ranks (see
``torch_ranks.edr_sharded``), which extract the gradients and the summed
Gram; the JAX package's unsharded gradients of the same models (the
port's parameters in JAX models) are the reference, at
``tests/test_edr_sharded.py``'s bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_ranks
from edrgp_tpu.models.state import ExactGPModel as JExactGPModel
from edrgp_tpu.models.state import SGPRModel as JSGPRModel
from edrgp_tpu.models.svgp import SVGPModel as JSVGPModel
from edrgp_tpu.ops import kernels as jk
from edrgp_tpu.ops.svgp import SVGPState as JSVGPState
from edrgp_tpu.parallel import edr_sharded as jedr_sharded
from edrgp_tpu.parallel.mesh import make_mesh
from edrgp_tpu_torch import discrepancy
from edrgp_tpu_torch.convert import params_to_numpy
from edrgp_tpu_torch.datasets import get_beta_inputs, get_edr_target
from edrgp_tpu_torch.models import (GaussianProcessRegressor,
                                    SparseGaussianProcessRegressor)
from edrgp_tpu_torch.models.svgp import SVGPModel
from edrgp_tpu_torch.ops import kernels as tk
from edrgp_tpu_torch.parallel import spawn

RANKS = 4


def _problem(n=120, q=6, d=2, seed=0):
    rng = np.random.default_rng(seed)
    X = get_beta_inputs(n, q, rng=rng)
    B = np.linalg.qr(rng.normal(size=(q, d)))[0]
    y = get_edr_target(X @ B, sigma=0.05, rng=rng)
    return X, y, B


def _jparams(model):
    return jax.tree_util.tree_map(jnp.asarray, params_to_numpy(model))


def _reference(name, model, X, y):
    """The JAX package's unsharded dμ/dx* of the port's fitted model."""
    q = X.shape[1]
    if name == "svgp":
        jm = JSVGPModel(X, y, jk.RBF(q, ARD=True), num_inducing=16)
        jm.qstate = JSVGPState(*(jnp.asarray(t.numpy())
                                 for t in model.qstate))
    elif name == "sgpr":
        jm = JSGPRModel(X, y, jk.RBF(q, ARD=True),
                        Z=model.Z.detach().numpy())
    else:
        jm = JExactGPModel(X, y, jk.RBF(q, ARD=True))
    jm.params = _jparams(model)
    jm._cache = None
    return np.asarray(jm.predictive_gradients(X)[0][:, :, 0])


def _grad_gram_cases(n=103, q=4, m=17, seed=8):
    """(kernel name, X, C, w, JAX kernel params, chunk): 103 rows over 4
    ranks, so the last slab holds 25 rows and 1 pad row; the Matern52 case
    takes the chunked autodiff path in chunks of 8 rows."""
    rng = np.random.default_rng(seed)
    X, C, w = (rng.normal(size=(n, q)), rng.normal(size=(m, q)),
               rng.normal(size=m))
    return [("RBF", X, C, w, {"variance": np.array(0.3),
                              "lengthscale": rng.uniform(-0.5, 1.0, q)}, 8),
            ("Matern52", X, C, w, {"variance": np.array(-0.2),
                                   "lengthscale": np.array([0.6])}, 8)]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("edr_sharded")
    fitted = {}
    X, y, _ = _problem()
    fitted["exact"] = (GaussianProcessRegressor(
        ["RBF"], [{"ARD": True}], device="cpu").fit(
            X, y, max_iters=150).estimator_, X, y)
    X, y, _ = _problem(n=101, q=4)
    fitted["ragged"] = (GaussianProcessRegressor(
        ["RBF"], [{"ARD": True}], device="cpu").fit(
            X, y, max_iters=100).estimator_, X, y)
    X, y, _ = _problem(n=96, q=4)
    fitted["sgpr"] = (SparseGaussianProcessRegressor(
        ["RBF"], [{"ARD": True}], num_inducing=16, device="cpu").fit(
            X, y, max_iters=100).estimator_, X, y)
    X, y, _ = _problem(n=128, q=4)
    svgp = SVGPModel(X, y, tk.RBF(4, ARD=True), num_inducing=16,
                     device="cpu")
    fitted["svgp"] = (svgp.optimize(max_iters=100, batch_size=64), X, y)
    models = []
    for name, (model, X, _) in fitted.items():
        path = str(d / f"{name}.pickle")
        model.pickle(path)
        models.append((name, path, X))
    X, y, B = _problem(n=150, q=6, d=2, seed=4)
    X5, y5, _ = _problem(n=120, q=5, d=2, seed=6)
    payload = {"models": models, "mean_function": _problem(n=64, q=3)[:2],
               "grad_gram": _grad_gram_cases(),
               "edr": {"plain": (X, y, None, 4, 200),
                       "preprocessed": (X5, y5, 4, None, 150)}}
    ranks = spawn(torch_ranks.edr_sharded, RANKS, device="cpu",
                  args=(payload,))
    refs = {name: _reference(name, model, X, y)
            for name, (model, X, y) in fitted.items()}
    unsharded = {name: model.predictive_gradients(X)[0][:, :, 0]
                 for name, (model, X, _) in fitted.items()}
    return ranks, refs, unsharded, B


@pytest.mark.parametrize("name", ["RBF", "Matern52"])
def test_make_sharded_grad_gram_matches_jax(case, name):
    """Each rank's slab of G, gathered, and the summed Gram against the JAX
    package's ``make_sharded_grad_gram`` on a 4-device CPU mesh (1e-10),
    the pad row zero, and the Gram GᵀG."""
    ranks = case[0]
    _, X, C, w, params, chunk = next(c for c in _grad_gram_cases()
                                     if c[0] == name)
    N, Q = X.shape
    rows = -(-N // RANKS)
    mesh = make_mesh(("data",), devices=jax.devices()[:RANKS])
    kern = jk.RBF(Q, ARD=True) if name == "RBF" else jk.Matern52(Q)
    Xp = jax.device_put(jnp.asarray(np.pad(X, ((0, rows * RANKS - N),
                                               (0, 0)))),
                        NamedSharding(mesh, P("data", None)))
    fn = jedr_sharded.make_sharded_grad_gram(kern, mesh, chunk=chunk)
    G_ref, gram_ref = fn(jax.tree_util.tree_map(jnp.asarray, params),
                         jnp.asarray(C), jnp.asarray(w), Xp,
                         jnp.asarray(N, jnp.int32))
    G = np.concatenate([out["grad_gram"][name][0] for out in ranks])
    np.testing.assert_allclose(G, np.asarray(G_ref), rtol=1e-10,
                               atol=1e-10 * np.abs(G_ref).max())
    assert not G[N:].any()
    for out in ranks:
        gram = out["grad_gram"][name][1]
        np.testing.assert_allclose(gram, np.asarray(gram_ref), rtol=1e-10)
        np.testing.assert_allclose(gram, G.T @ G, rtol=1e-10)


def test_make_sharded_grad_gram_refuses_unknown_parameters(case):
    """A name in kparams that the kernel does not have raises, naming it."""
    for out in case[0]:
        assert "'length_scale'" in out["unknown_kparams_error"]


BARS = {"exact": (1e-9, 1e-11, 1e-9, 1e-9), "ragged": (1e-9, 1e-11, 1e-9, 1e-9),
        "sgpr": (1e-8, 1e-10, 1e-8, 1e-8), "svgp": (1e-8, 1e-10, 1e-8, 1e-8)}


@pytest.mark.parametrize("name", list(BARS))
def test_model_gradient_gram_matches_jax(case, name):
    """Every rank's G equals the JAX package's unsharded gradients and its
    Gram GᵀG (101 rows over 4 ranks: the pad rows stay out)."""
    ranks, refs, _, _ = case
    rtol, atol, gram_rtol, gram_atol = BARS[name]
    G1 = refs[name]
    for out in ranks:
        G, gram = out["gram"][name]
        assert G.shape == G1.shape
        np.testing.assert_allclose(G, G1, rtol=rtol, atol=atol)
        np.testing.assert_allclose(gram, G1.T @ G1, rtol=gram_rtol,
                                   atol=gram_atol)


@pytest.mark.parametrize("name", list(BARS))
def test_model_gradient_gram_matches_unsharded_port(case, name):
    """The sharded G equals the port's own unsharded extraction, and the
    Gram is the same on every rank."""
    ranks, _, unsharded, _ = case
    rtol, atol, _, _ = BARS[name]
    np.testing.assert_allclose(ranks[0]["gram"][name][0], unsharded[name],
                               rtol=rtol, atol=atol)
    for out in ranks[1:]:
        assert np.array_equal(out["gram"][name][1], ranks[0]["gram"][name][1])


def test_estimator_hooks(case):
    ranks, refs, _, _ = case
    supported, (G, gram) = ranks[0]["estimator"]
    assert supported
    np.testing.assert_allclose(G, refs["exact"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(gram, G.T @ G, rtol=1e-9, atol=1e-9)


def test_mean_function_model_refuses_sharded(case):
    for out in case[0]:
        assert out["mean_function_supported"] is False
        assert out["mean_function_error"] is not None


def _align_signs(A, ref):
    signs = np.sign(np.sum(A * ref, axis=1))
    signs[signs == 0] = 1.0
    return A * signs[:, None]


@pytest.mark.parametrize("label", ["plain", "preprocessed"])
def test_composed_edr_sharded_equals_single(case, label):
    """fit → sharded gradients → summed Gram → ``fit_gram`` lands the
    mesh-free fit's components (1e-6), with and without a preprocessor.

    Each case is one pass of the EDR (6 → 2 with ``step=4``; 5 → 4 → 2
    with the preprocessor).  A second pass, 6 → 4 → 2, refits a GP on the
    4-D projection whose lengthscale on an input the target ignores runs
    off to ~1e5, so the first pass's last-bit difference (eigh of the Gram
    against the SVD: 7e-15) moves the final components by 2e-7 there."""
    ranks, _, _, B = case
    for out in ranks:
        single, sharded = out["edr"][label][False], out["edr"][label][True]
        assert sharded["gram_used"] and not single["gram_used"]
        c1 = single["components"]
        np.testing.assert_allclose(_align_signs(sharded["components"], c1),
                                   c1, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(sharded["ratio"], single["ratio"],
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(np.abs(sharded["transform"]),
                                   np.abs(single["transform"]), atol=1e-6)
    if label == "plain":
        c8 = ranks[0]["edr"]["plain"][True]["components"]
        assert discrepancy(B, np.linalg.qr(c8.T)[0]) < 0.35

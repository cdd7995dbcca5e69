"""The port's entry points against ``__graft_entry__.py``: ``entry()``'s NLML
value and gradient against the JAX package's ``exact.nlml`` at the same
float64 inputs, and ``dryrun_multichip`` in 4 gloo ranks on the CPU."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrgp_tpu.ops import exact as jexact
from edrgp_tpu.ops import kernels as jkernels
from edrgp_tpu_torch.convert import params_to_numpy
from edrgp_tpu_torch.entry import dryrun_multichip, entry

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's small fits: the suite's workers
    share the machine's cores, and torch's default thread count there makes
    each small operation wait on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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

"""The port's multi-device layer (edrgp_tpu_torch.parallel: meshes, the
barrier and replica check, the sharded SVGP step, the distributed
resample, sharded NUTS and SMC) against the JAX package, float64 on the
CPU.

The port runs in 4 gloo ranks on a 2×2 ("chain", "data") mesh, started
once for the module (``torch_ranks.parallel``); the JAX side runs in this
process on a 2×2 mesh of 4 of the 8 CPU devices of ``tests/conftest.py``.
The setup and bars are ``tests/test_parallel.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from torch_ranks import one_torch_thread  # noqa: F401 (autouse)
from edrgp_tpu.ops import kernels as jk
from edrgp_tpu.ops import svgp as jsvgp
from edrgp_tpu.parallel.mesh import factor_devices as jfactor_devices
from edrgp_tpu.parallel.mesh import make_mesh as jmake_mesh
from edrgp_tpu.parallel.mesh import shard_along as jshard_along
from edrgp_tpu.parallel.sharded import (
    make_sharded_svgp_step as jmake_sharded_svgp_step)
from edrgp_tpu_torch.convert import params_from_jax
from edrgp_tpu_torch.inference.smc import systematic_resample
from edrgp_tpu_torch.models.svgp import SVGPModel
from edrgp_tpu_torch.ops import kernels as tk
from edrgp_tpu_torch.parallel import factor_devices, initialize, spawn

RANKS = 4
N, Q, M, B = 512, 2, 16, 128
LR, RHO = 1e-2, 0.3


def _svgp_data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, Q))
    return X, np.sin(X[:, 0])


def _resample_case():
    rng = np.random.default_rng(0)
    return rng.normal(size=64), rng.normal(size=(64, 3)), 0.3719


@pytest.fixture(scope="module")
def ranks():
    X, y = _svgp_data()
    payload = {"svgp": (X, y, B, M, N, LR, RHO),
               "resample": _resample_case(),
               "smc": 5.0 * np.random.default_rng(1).normal(size=(64, 2))}
    return spawn(torch_ranks.parallel, RANKS, device="cpu",
                 args=(payload,))


def test_factor_devices_matches_jax():
    for n in range(1, 65):
        for axes in (1, 2, 3):
            assert factor_devices(n, axes) == jfactor_devices(n, axes)


@pytest.mark.parametrize("start", ["initialize", "spawn"])
def test_ranks_without_a_device_refuse_the_cpu(start):
    """No device means the card (NCCL): without CUDA both ways of starting
    ranks raise before any rank joins a group, instead of running gloo."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    call = {"initialize": lambda: initialize(),
            "spawn": lambda: spawn(torch_ranks.parallel, RANKS, args=({},))}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call[start]()


def test_mesh_2x2(ranks):
    """Rank r sits at (r // 2, r % 2) of the ("chain", "data") mesh."""
    for r, out in enumerate(ranks):
        assert out["world"] == RANKS
        assert out["mesh"] == ((2, 2), r // 2, r % 2)


def test_replica_check_raises_on_every_rank(ranks):
    """The barriers and an agreeing check passed in every rank; one rank's
    perturbed tensor makes the check raise in all four."""
    for out in ranks:
        assert out["perturbed_error"] is not None
        assert "diverged" in out["perturbed_error"]


def _jax_step():
    X, y = _svgp_data()
    mesh = jmake_mesh(("chain", "data"), devices=jax.devices()[:RANKS])
    k = jk.RBF(Q)
    params = {"kernel": k.init_params(jnp.float64),
              "raw_noise": jk.inv_positive(jnp.asarray(1.0)),
              "Z": jnp.asarray(X[:M])}
    qstate = jsvgp.init_svgp_state(M, jnp.float64)
    step, opt_init = jmake_sharded_svgp_step(k, mesh, n_total=N, lr=LR)
    Xb = jax.device_put(jnp.asarray(X[:B]), jshard_along(mesh, "data", 2))
    yb = jax.device_put(jnp.asarray(y[:B]), jshard_along(mesh, "data", 1))
    p1, q1, _, elbo = step(params, qstate, opt_init(params), Xb, yb,
                           jnp.asarray(RHO))
    return (params_from_jax(jax.tree_util.tree_map(np.asarray, p1)), q1,
            float(elbo))


def test_sharded_svgp_step_matches_jax(ranks):
    """Every rank's parameters, q(u) and ELBO after one data-parallel step
    equal the JAX package's sharded step on the same mesh shape."""
    params, q, elbo = _jax_step()
    for out in ranks:
        got = out["svgp"]
        np.testing.assert_allclose(got["elbo"], elbo, rtol=1e-8)
        for k, v in params.items():
            np.testing.assert_allclose(got["params"][k], v.numpy(),
                                       rtol=1e-7, atol=1e-10)
        np.testing.assert_allclose(got["theta1"], np.asarray(q.theta1),
                                   rtol=1e-7)
        np.testing.assert_allclose(got["theta2"], np.asarray(q.theta2),
                                   rtol=1e-7)


def test_sharded_svgp_step_matches_the_models_own_step(ranks):
    """…and the port's single-process ``SVGPModel`` step on the whole
    minibatch; the replicas hold the same bits."""
    X, y = _svgp_data()
    m = SVGPModel(X, y, tk.RBF(Q), Z=X[:M], normalizer=False, device="cpu")
    opt = torch.optim.Adam(m.parameters(), lr=LR)
    elbo = m._step(opt, torch.as_tensor(X[:B]), torch.as_tensor(y[:B]), N,
                   RHO)
    ref = ranks[0]["svgp"]
    np.testing.assert_allclose(ref["elbo"], float(elbo), rtol=1e-8)
    for k, v in m.state_dict().items():
        np.testing.assert_allclose(ref["params"][k], v.numpy(), rtol=1e-7,
                                   atol=1e-10)
    np.testing.assert_allclose(ref["theta1"], m.qstate.theta1.numpy(),
                               rtol=1e-7)
    np.testing.assert_allclose(ref["theta2"], m.qstate.theta2.numpy(),
                               rtol=1e-7)
    for out in ranks[1:]:
        for k, v in ref["params"].items():
            assert np.array_equal(out["svgp"]["params"][k], v)
        assert np.array_equal(out["svgp"]["theta2"], ref["theta2"])


def test_distributed_resample_matches_single_rank(ranks):
    """The collective resample equals the single-process systematic
    resample of the concatenated weights with the same u0."""
    log_w, particles, u0 = _resample_case()
    idx = systematic_resample(u0, torch.as_tensor(log_w)).numpy()
    expected = particles[idx]
    for out in ranks:
        c = out["mesh"][1]          # rank's position along "chain"
        np.testing.assert_allclose(out["resample"],
                                   expected[c * 32:(c + 1) * 32], rtol=1e-12)


def test_sharded_nuts_pools_one_step_size(ranks):
    """8 chains over the 2 "chain" positions (each in 2 replicas) share one
    ε; the draws find the target's mean."""
    for out in ranks:
        qs, eps, _ = out["nuts"]
        assert qs.shape == (8, 150, 2)
        np.testing.assert_allclose(eps, eps[0], rtol=1e-12)
        np.testing.assert_allclose(qs.reshape(-1, 2).mean(0), [1.0, -1.0],
                                   atol=0.2)
        assert np.array_equal(qs, ranks[0]["nuts"][0])


def test_sharded_smc_stage_runs(ranks):
    for out in ranks:
        parts, logz = out["smc"]
        assert parts.shape == (32, 2)
        assert np.isfinite(parts).all() and np.isfinite(logz)
        assert logz == ranks[0]["smc"][1]


def test_inducing_inputs_do_not_alias_the_callers_array():
    """Z given as a slice of X is copied: an Adam step on Z leaves X as the
    caller made it (a float64 CPU array used to share its memory)."""
    X, y = _svgp_data()
    before = X.copy()
    m = SVGPModel(X, y, tk.RBF(Q), Z=X[:M], normalizer=False, device="cpu")
    m._step(torch.optim.Adam(m.parameters(), lr=LR),
            torch.as_tensor(X[:B]), torch.as_tensor(y[:B]), N, RHO)
    assert not torch.equal(m.Z.detach(), torch.as_tensor(before[:M]))
    assert np.array_equal(X, before)

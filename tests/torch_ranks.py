"""Rank bodies of the port's multi-rank CPU tests.

Each function runs in every rank of a gloo group started by
:func:`edrgp_tpu_torch.parallel.spawn` and returns numpy results for the
test module to hold against the JAX package.  This module imports no JAX,
so a rank starts in the time torch takes to import.

It also holds :func:`one_torch_thread`, the autouse fixture every port test
module imports.
"""

import numpy as np
import pytest
import torch

from edrgp_tpu_torch.convert import params_from_jax
from edrgp_tpu_torch.ops import kernels


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the importing module's tests: the suite's
    workers share the machine's cores, and torch's default thread count
    there makes each small operation wait on threads the other workers
    hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kernel(name, q):
    return (kernels.RBF(q, ARD=True) if name == "RBF"
            else kernels.Matern52(q))


def _numpy_state(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def exact_sharded(rank, world, payload):
    """Sharded NLML values and gradients, the indivisible-N refusal, and
    sharded fits through the model and the estimator."""
    from edrgp_tpu_torch.models import GaussianProcessRegressor
    from edrgp_tpu_torch.models.state import ExactGPModel
    from edrgp_tpu_torch.parallel import (assert_replicas_agree, checksum,
                                          make_mesh,
                                          sharded_nlml_value_and_grad)
    mesh = make_mesh(("data",))
    out = {"nlml": {}}
    for name, X, y, params in payload["nlml"]:
        m = ExactGPModel(X, y, _kernel(name, X.shape[1]), normalizer=False,
                         device="cpu")
        m.load_state_dict(params_from_jax(params))
        value, grads = sharded_nlml_value_and_grad(m, mesh, m._X, m._y)
        out["nlml"][name] = (float(value),
                             {k: g.numpy() for k, g in grads.items()})
    name, X, y, params = payload["nlml"][0]
    m = ExactGPModel(X, y, _kernel(name, X.shape[1]), normalizer=False,
                     device="cpu")
    m.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        m.raw_noise.fill_(float("nan"))     # no factor on any rank
    value, grads = sharded_nlml_value_and_grad(m, mesh, m._X, m._y)
    out["failed_factor"] = (float(value), {k: g.numpy()
                                           for k, g in grads.items()})

    X, y = payload["indivisible"]
    m = ExactGPModel(X, y, kernels.RBF(X.shape[1]), device="cpu")
    try:
        sharded_nlml_value_and_grad(m, mesh, m._X, m._y)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)

    X, y, Xt = payload["fit"]
    m = ExactGPModel(X, y, kernels.RBF(X.shape[1], ARD=True), device="cpu")
    m.optimize_sharded(mesh=mesh, max_iters=200)
    assert_replicas_agree(dict(m.named_parameters()))
    out["fit"] = {"ll": m.log_likelihood(), "pred": m.predict(Xt)[0],
                  "params": _numpy_state(m),
                  "digest": checksum(dict(m.named_parameters()))}

    X, y = payload["estimator"]
    est = GaussianProcessRegressor(kernel_options={"ARD": True},
                                   method="optimize_sharded", device="cpu")
    est.fit(X, y, mesh=mesh, max_iters=150)
    out["estimator"] = {"pred": est.predict(X),
                        "grads": est.predict_gradient(X),
                        "ll": est.estimator_.log_likelihood()}
    return out


def edr_sharded(rank, world, payload):
    """``make_sharded_grad_gram`` on each rank's padded slab,
    ``model_gradient_gram`` of saved exact, SGPR and SVGP models, the
    mean-function refusal, and the composed EDR with and without a
    gradient mesh."""
    from edrgp_tpu_torch import (EffectiveDimensionalityReduction,
                                 SVDTransformer)
    from edrgp_tpu_torch.models import GaussianProcessRegressor
    from edrgp_tpu_torch.models.state import load_model
    from edrgp_tpu_torch.parallel import make_mesh
    from edrgp_tpu_torch.parallel.edr_sharded import (make_sharded_grad_gram,
                                                      model_gradient_gram)
    mesh = make_mesh(("data",))
    out = {"gram": {}, "grad_gram": {}}
    for name, X, C, w, params, chunk in payload["grad_gram"]:
        N, Q = X.shape
        rows = -(-N // world)
        X_local = np.zeros((rows, Q))
        mine = X[rank * rows:(rank + 1) * rows]
        X_local[:len(mine)] = mine
        fn = make_sharded_grad_gram(_kernel(name, Q), mesh, chunk=chunk)
        G_local, gram = fn(params_from_jax(params), torch.as_tensor(C),
                           torch.as_tensor(w), torch.as_tensor(X_local), N)
        out["grad_gram"][name] = (G_local.numpy(), gram.numpy())
    try:
        fn({"length_scale": torch.ones(Q)}, torch.as_tensor(C),
           torch.as_tensor(w), torch.as_tensor(X_local), N)
        out["unknown_kparams_error"] = None
    except ValueError as e:
        out["unknown_kparams_error"] = str(e)
    for name, path, X in payload["models"]:
        G, gram = model_gradient_gram(load_model(path, device="cpu"), X,
                                      mesh)
        out["gram"][name] = (G, gram)
    name, path, X = payload["models"][0]
    est = GaussianProcessRegressor(device="cpu").load(path)
    out["estimator"] = (est.supports_sharded_gradients(),
                        est.predict_gradient_sharded(X, mesh))

    X, y = payload["mean_function"]
    gp = GaussianProcessRegressor(["RBF"], [{"ARD": True}],
                                  mean_function=lambda A: A[:, 0],
                                  device="cpu").fit(X, y, max_iters=50)
    out["mean_function_supported"] = gp.supports_sharded_gradients()
    try:
        model_gradient_gram(gp.estimator_, X, mesh)
        out["mean_function_error"] = None
    except TypeError as e:
        out["mean_function_error"] = str(e)

    out["edr"] = {}
    for label, (X, y, n_pre, step, max_iters) in payload["edr"].items():
        res = {}
        for with_mesh in (False, True):
            edr = EffectiveDimensionalityReduction(
                GaussianProcessRegressor(["RBF"], [{"ARD": True}],
                                         device="cpu"),
                SVDTransformer(), n_components=2, step=step,
                preprocessor=(None if n_pre is None
                              else SVDTransformer(n_components=n_pre)),
                gradient_mesh=mesh if with_mesh else None)
            edr.fit(X, y, max_iters=max_iters)
            res[with_mesh] = {
                "components": edr.components_,
                "ratio": np.asarray(edr.subspace_variance_ratio_),
                "transform": edr.transform(X),
                "gram_used": getattr(edr, "_pending_gram_", None)
                is not None}
        out["edr"][label] = res
    return out


def parallel(rank, world, payload):
    """A 2×2 mesh, the barrier, the replica check, one sharded SVGP step,
    the distributed resample, sharded NUTS and one SMC stage."""
    import torch.distributed as dist
    from edrgp_tpu_torch.models.svgp import SVGPModel
    from edrgp_tpu_torch.ops import svgp
    from edrgp_tpu_torch.parallel import (assert_replicas_agree, barrier,
                                          distributed_systematic_resample,
                                          make_mesh, make_sharded_svgp_step,
                                          run_sharded_nuts,
                                          run_sharded_smc_stage, shard_along)
    out = {}
    mesh = make_mesh(("chain", "data"))
    out["mesh"] = (tuple(mesh.shape), mesh.get_local_rank("chain"),
                   mesh.get_local_rank("data"))
    barrier()
    barrier(mesh.get_group("data"))
    same = {"w": torch.arange(6, dtype=torch.float64)}
    assert_replicas_agree(same)
    bad = {"w": same["w"] + (1e-6 if rank == 2 else 0.0)}
    try:
        assert_replicas_agree(bad)
        out["perturbed_error"] = None
    except RuntimeError as e:
        out["perturbed_error"] = str(e)

    X, y, B, M, n_total, lr, rho = payload["svgp"]
    gp = SVGPModel(X, y, kernels.RBF(X.shape[1]), Z=X[:M], normalizer=False,
                   device="cpu")
    step, opt_init = make_sharded_svgp_step(gp, mesh, n_total, lr=lr)
    Xb = shard_along(mesh, "data", torch.as_tensor(X[:B]))
    yb = shard_along(mesh, "data", torch.as_tensor(y[:B]))
    qstate, elbo = step(opt_init(), svgp.init_svgp_state(M), Xb, yb, rho)
    out["svgp"] = {"params": _numpy_state(gp), "elbo": float(elbo),
                   "theta1": qstate.theta1.numpy(),
                   "theta2": qstate.theta2.numpy()}

    log_w, particles, u0 = payload["resample"]
    lw = shard_along(mesh, "chain", torch.as_tensor(log_w))
    parts = shard_along(mesh, "chain", torch.as_tensor(particles))
    mine, _ = distributed_systematic_resample(u0, lw, parts, mesh, "chain")
    out["resample"] = mine.numpy()

    mu = torch.tensor([1.0, -1.0], dtype=torch.float64)
    qs, info = run_sharded_nuts(
        lambda q: -0.5 * ((q - mu) ** 2).sum(-1),
        torch.zeros(8, 2, dtype=torch.float64), 0, mesh,
        num_warmup=150, num_samples=150, max_depth=6)
    out["nuts"] = (qs, info["step_size"], info["divergences"])

    mu_s = torch.tensor([0.5, 0.5], dtype=torch.float64)
    stage = run_sharded_smc_stage(
        lambda q: -0.5 * ((q - mu_s) ** 2).sum(-1),
        lambda q: -0.5 * (q ** 2).sum(-1) / 25.0, mesh, num_mcmc=2,
        n_leapfrog=5, eps=0.3)
    start = shard_along(mesh, "chain", torch.as_tensor(payload["smc"]))
    parts, logz = stage(start, 0.0, 0.3, 1)
    out["smc"] = (parts.numpy(), float(logz))
    out["world"] = dist.get_world_size()
    return out

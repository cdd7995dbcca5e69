"""Entry points: the flagship single-device evaluation and a dry run of
every sharded path.

The port of ``__graft_entry__.py``:

* :func:`entry` returns ``(fn, args)``: the NLML value and gradient of the
  RBF-ARD exact GP at N=2,048, Q=8, on the inputs the JAX entry point
  draws, through :func:`edrgp_tpu_torch.ops.exact.nlml` (kernel K forward,
  kernel A backward on the card).
* :func:`dryrun_multichip` runs one step of each sharded path at the JAX
  dry run's shapes (the data-parallel SVGP step, chain-parallel NUTS with
  pooled ε, the sharded NLML value and gradient, a sharded fit, the
  composed EDR with ``gradient_mesh``, an SMC stage with collective
  resampling) and asserts what it asserts.

    python -m edrgp_tpu_torch.entry        # on every card of this host
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """(fn, args) with ``fn(*args)`` → (NLML, {parameter name: gradient})
    for the exact GP (RBF-ARD, unit variance and lengthscales, noise 0.1)
    on X ~ N(0, I) [2048, 8], y = sin(N(0, 1)) from ``default_rng(0)``,
    rounded to float32 as the JAX entry point draws them.  ``device`` None
    means the card (float32); ``"cpu"`` computes in float64."""
    from .models.state import ExactGPModel
    from .ops import exact
    from .ops.kernels import RBF

    N, Q = 2048, 8
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, Q)).astype(np.float32)
    y = np.sin(rng.normal(size=N)).astype(np.float32)
    gp = ExactGPModel(X, y, RBF(Q, ARD=True), normalizer=False,
                      noise_var=0.1, device=device)

    def nlml_value_and_grad(gp, X, y):
        params = dict(gp.named_parameters())
        value = exact.nlml(gp, X, y)
        grads = torch.autograd.grad(value, list(params.values()))
        return value.detach(), dict(zip(params, grads))

    return nlml_value_and_grad, (gp, gp._X, gp._y)


def _finite(x) -> bool:
    return bool(np.all(np.isfinite(np.asarray(x))))


def _check(ok, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def _dryrun(rank: int, world: int) -> dict:
    """One step of each sharded path in the current process group, on the
    group's device; returns the values it checked."""
    from . import EffectiveDimensionalityReduction, SVDTransformer
    from .models import GaussianProcessRegressor
    from .models.state import ExactGPModel
    from .models.svgp import SVGPModel
    from .ops import svgp as _svgp
    from .ops.kernels import RBF
    from .parallel import (make_mesh, make_sharded_svgp_step,
                           run_sharded_nuts, run_sharded_smc_stage,
                           shard_along, sharded_nlml_value_and_grad)
    from .parallel.distributed import collective_device
    from .parallel.mesh import axis_size

    device = collective_device()
    mesh = make_mesh(("chain", "data"))
    chain_size = axis_size(mesh, "chain")
    data_size = axis_size(mesh, "data")
    out = {}

    # data-parallel SVGP training step (over "data")
    rng = np.random.default_rng(0)
    N, Q, M = 64, 3, 8
    B = 8 * data_size
    X = rng.normal(size=(N, Q)).astype(np.float32)
    y = np.sin(X[:, 0]).astype(np.float32)
    gp = SVGPModel(X, y, RBF(Q, ARD=True), Z=X[:M], normalizer=False,
                   device=device)
    step, opt_init = make_sharded_svgp_step(gp, mesh, n_total=N, lr=1e-2)
    Xb = shard_along(mesh, "data", gp._as_input(X[:B]))
    yb = shard_along(mesh, "data", gp._as_input(y[:B]))
    _, elbo = step(opt_init(),
                   _svgp.init_svgp_state(M, Xb.dtype, device), Xb, yb, 0.5)
    out["svgp_elbo"] = float(elbo)
    _check(np.isfinite(out["svgp_elbo"]),
           "sharded SVGP step produced non-finite ELBO")

    # chain-parallel NUTS with pooled adaptation (over "chain")
    mu = torch.tensor([0.7, -0.3], dtype=Xb.dtype, device=device)

    def logprob(q):
        return -0.5 * ((q - mu) ** 2).sum(-1)

    C = 2 * chain_size
    qs, _ = run_sharded_nuts(
        logprob, torch.zeros(C, 2, dtype=Xb.dtype, device=device), 0, mesh,
        num_warmup=8, num_samples=8, max_depth=4)
    out["nuts_shape"] = qs.shape
    _check(qs.shape == (C, 8, 2), f"sharded NUTS samples {qs.shape}")

    # kernel-block-parallel exact GP (over "data")
    mesh1d = make_mesh(("data",))
    Ns = 16 * world
    Xs = rng.normal(size=(Ns, Q)).astype(np.float32)
    ys = np.sin(Xs[:, 0]).astype(np.float32)
    m = ExactGPModel(Xs, ys, RBF(Q, ARD=True), normalizer=False,
                     noise_var=0.1, device=device)
    val, grads = sharded_nlml_value_and_grad(m, mesh1d, m._X, m._y)
    out["sharded_nlml"] = float(val)
    _check(np.isfinite(out["sharded_nlml"]),
           "sharded NLML produced non-finite value")
    _check(all(_finite(g.cpu()) for g in grads.values()),
           "sharded NLML produced non-finite gradients")

    # distributed fit: L-BFGS over the sharded NLML
    m.optimize_sharded(mesh=mesh1d, max_iters=4, tol=1e-3)
    out["sharded_fit_nlml"] = float(m._objective)
    _check(np.isfinite(out["sharded_fit_nlml"]),
           "sharded fit produced non-finite NLML")

    # the composed EDR loop: sharded fit, sharded gradient extraction,
    # summed Gram, projector, reduced-space sharded refit
    Ne, Qe = 8 * world, 4
    Xe = rng.normal(size=(Ne, Qe)).astype(np.float32)
    Be = np.linalg.qr(rng.normal(size=(Qe, 2)))[0]
    ye = (np.tanh(Xe @ Be[:, 0]) + 0.3 * (Xe @ Be[:, 1]) ** 2
          + 0.05 * rng.normal(size=Ne)).astype(np.float32)
    edr = EffectiveDimensionalityReduction(
        GaussianProcessRegressor(["RBF"], [{"ARD": True}],
                                 method="optimize_sharded", device=device),
        SVDTransformer(), n_components=2, gradient_mesh=mesh1d)
    edr.fit(Xe, ye, mesh=mesh1d, max_iters=4)
    out["edr_components"] = np.asarray(edr.components_)
    _check(out["edr_components"].shape == (2, Qe)
           and _finite(out["edr_components"]),
           "sharded EDR produced bad components")
    _check(getattr(edr, "_pending_gram_", None) is not None,
           "sharded EDR never routed the distributed Gram")
    _check(_finite(edr.transform(Xe)), "sharded EDR transform not finite")

    # SMC stage with collective resampling (over "chain")
    def loglik(q):
        return -0.5 * ((q - mu) ** 2).sum(-1)

    def logprior(q):
        return -0.5 * (q ** 2).sum(-1) / 25.0

    stage = run_sharded_smc_stage(loglik, logprior, mesh, num_mcmc=1,
                                  n_leapfrog=3, eps=0.3)
    n_parts = 4 * chain_size
    gen = torch.Generator().manual_seed(1)
    parts = 5.0 * torch.randn(n_parts, 2, generator=gen, dtype=Xb.dtype)
    local = shard_along(mesh, "chain", parts.to(device))
    parts2, logz = stage(local, 0.0, 0.5, 2)
    out["smc_logz_inc"] = float(logz)
    _check(parts2.shape == local.shape and np.isfinite(out["smc_logz_inc"]),
           "sharded SMC stage produced bad particles or evidence")
    return out


def dryrun_multichip(n_devices: int, device=None) -> list:
    """One step of each sharded path on ``n_devices`` ranks; returns the
    checked values of each rank it ran, in rank order.

    In a process group of ``n_devices`` ranks it runs in that group (every
    rank calls it, and gets its own values; ``device`` is the group's).
    Otherwise it starts ``n_devices`` ranks on this host
    through :func:`edrgp_tpu_torch.parallel.spawn`: NCCL ranks on the cards
    when ``device`` is None or ``"cuda"`` (one card a rank), gloo ranks
    with ``device="cpu"``.  A script that calls it so needs the
    ``if __name__ == "__main__":`` guard.
    """
    import torch.distributed as dist

    from .config import resolve_device
    from .parallel import spawn

    if dist.is_initialized() and dist.get_world_size() == n_devices:
        return [_dryrun(dist.get_rank(), n_devices)]
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} cards, have "
                           f"{torch.cuda.device_count()}")
    return spawn(_dryrun, n_devices, device=device)


if __name__ == "__main__":
    fn, fn_args = entry()
    print("entry ok:", float(fn(*fn_args)[0]))
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip ok")

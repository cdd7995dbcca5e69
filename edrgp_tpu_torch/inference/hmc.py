"""Hamiltonian Monte Carlo with window adaptation, batch-first over chains.

The port of :mod:`edrgp_tpu.inference.hmc`.  The JAX package writes one
chain per function and ``vmap``s it; here every function takes the chains
as a leading axis: positions are [C, D], ``logprob_fn`` maps [C, D] to [C],
and its gradient is autograd of the sum (chains are independent).  One
chain is C = 1.  Trajectories are fixed-length, proposals are drawn
multinomially from the whole trajectory (Betancourt 2017), and step-size
adaptation can be pooled across the chains of a batch (``pool_eps``: the
mean over the chain axis, where the JAX package takes ``pmean`` over a
named axis).  Randomness comes from a ``torch.Generator`` on the chains'
device; its draws cannot match JAX's keys.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["HMCState", "AdaptState", "init_state", "value_and_grad",
           "hmc_step", "find_reasonable_epsilon", "window_adaptation_init",
           "window_adaptation_update", "pooled_mean", "curvature_inv_mass",
           "run_hmc", "run_hmc_pytree", "make_generator"]


class HMCState(NamedTuple):
    q: torch.Tensor          # positions [C, D]
    logp: torch.Tensor       # log target at q [C]
    grad: torch.Tensor       # ∇ log target at q [C, D]


class AdaptState(NamedTuple):
    """Dual-averaging step size + Welford diagonal mass matrix, per chain."""
    log_eps: torch.Tensor        # [C]
    log_eps_avg: torch.Tensor    # [C]
    h_avg: torch.Tensor          # [C]
    mu: torch.Tensor             # [C]
    count: torch.Tensor          # [C]
    w_mean: torch.Tensor         # Welford running mean [C, D]
    w_m2: torch.Tensor           # Welford running M2 [C, D]
    inv_mass: torch.Tensor       # current diagonal inverse mass [C, D]


def make_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def value_and_grad(logprob_fn: Callable, q: torch.Tensor):
    """(log p [C], ∇ log p [C, D]) at positions q [C, D], detached."""
    with torch.enable_grad():
        q = q.detach().requires_grad_(True)
        logp = logprob_fn(q)
        (grad,) = torch.autograd.grad(logp.sum(), q)
    return logp.detach(), grad


def init_state(logprob_fn: Callable, q: torch.Tensor) -> HMCState:
    logp, grad = value_and_grad(logprob_fn, q)
    return HMCState(q=q.detach(), logp=logp, grad=grad)


def _col(x: torch.Tensor) -> torch.Tensor:
    """A per-chain [C] value as a [C, 1] column against [C, D]."""
    return x[:, None]


def _momentum(gen: torch.Generator, q: torch.Tensor,
              inv_mass: torch.Tensor) -> torch.Tensor:
    return torch.randn(q.shape, generator=gen, dtype=q.dtype,
                       device=q.device) / torch.sqrt(inv_mass)


def _kinetic(p: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    return 0.5 * (p * p * inv_mass).sum(-1)


def _leapfrog(logprob_fn, q, p, grad, eps, inv_mass, n_steps):
    """n fixed leapfrog steps of every chain (ε [C]); returns the trajectory
    (q [n, C, D], logp [n, C], grad [n, C, D], p [n, C, D])."""
    e = _col(eps)
    traj = []
    for _ in range(n_steps):
        p = p + 0.5 * e * grad
        q = q + e * inv_mass * p
        logp, grad = value_and_grad(logprob_fn, q)
        p = p + 0.5 * e * grad
        traj.append((q, logp, grad, p))
    return tuple(torch.stack(t) for t in zip(*traj))


def _categorical(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One index per row of ``logits`` [C, K] by the Gumbel-max trick, as
    ``jax.random.categorical`` draws."""
    u = torch.rand(logits.shape, generator=gen, dtype=logits.dtype,
                   device=logits.device)
    tiny = torch.finfo(logits.dtype).tiny
    return (logits - torch.log(-torch.log(u.clamp_min(tiny)))).argmax(-1)


def hmc_step(logprob_fn: Callable, state: HMCState, gen: torch.Generator,
             eps, inv_mass: torch.Tensor, n_steps: int):
    """One multinomial-HMC transition of every chain.

    Samples the next state from the *whole* trajectory with weights
    ∝ exp(logp − ½pᵀM⁻¹p) (energy-conserving multinomial scheme), rather
    than accept/reject on the endpoint.  ``eps`` is a number or [C],
    ``inv_mass`` [C, D] or [D].  Returns (state, info dict of [C] values).
    """
    q = state.q
    C = q.shape[0]
    eps = torch.as_tensor(eps, dtype=q.dtype, device=q.device).expand(C)
    inv_mass = inv_mass.expand(q.shape)
    p0 = _momentum(gen, q, inv_mass)
    energy0 = state.logp - _kinetic(p0, inv_mass)

    qs, logps, grads, ps = _leapfrog(logprob_fn, q, p0, state.grad, eps,
                                     inv_mass, n_steps)
    energies = logps - _kinetic(ps, inv_mass)                   # [n, C]
    # numerical safety: divergent energies get -inf weight
    log_w = torch.where(torch.isfinite(energies), energies - energy0,
                        torch.full_like(energies, -math.inf))
    # include the initial point with weight 1
    log_w_all = torch.cat([torch.zeros_like(log_w[:1]), log_w]).T  # [C, n+1]
    idx = _categorical(gen, log_w_all)

    rows = torch.arange(C, device=q.device)
    q_all = torch.cat([q[None], qs])
    logp_all = torch.cat([state.logp[None], logps])
    grad_all = torch.cat([state.grad[None], grads])
    new = HMCState(q=q_all[idx, rows], logp=logp_all[idx, rows],
                   grad=grad_all[idx, rows])

    accept_stat = torch.minimum(torch.ones_like(log_w),
                                torch.exp(log_w)).mean(0)
    diverged = (~torch.isfinite(energies)).any(0)
    return new, {"accept_stat": accept_stat, "diverged": diverged,
                 "energy": -new.logp}


def find_reasonable_epsilon(logprob_fn: Callable, state: HMCState,
                            gen: torch.Generator, inv_mass=None,
                            eps0: float = 1.0,
                            max_doublings: int = 20) -> torch.Tensor:
    """Hoffman-Gelman ε init per chain [C]: double/halve until the
    one-leapfrog accept ratio crosses 0.5; non-finite energies count as
    reject.  One host read per doubling."""
    q = state.q
    dt, dev = q.dtype, q.device
    inv_mass = (torch.ones_like(q) if inv_mass is None
                else torch.as_tensor(inv_mass, dtype=dt,
                                     device=dev).expand(q.shape))
    p0 = _momentum(gen, q, inv_mass)
    energy0 = state.logp - _kinetic(p0, inv_mass)

    def accept(eps):
        e = _col(eps)
        p_half = p0 + 0.5 * e * state.grad
        logp, grad = value_and_grad(logprob_fn, q + e * inv_mass * p_half)
        energy = logp - _kinetic(p_half + 0.5 * e * grad, inv_mass)
        a = torch.exp(torch.clamp(energy - energy0, max=0.0))
        return torch.where(torch.isfinite(energy), a, torch.zeros_like(a))

    eps = torch.full((q.shape[0],), float(eps0), dtype=dt, device=dev)
    a = accept(eps)
    d = torch.where(a > 0.5, 1.0, -1.0).to(dt)
    k = 0
    while k < max_doublings:
        keep = torch.where(d > 0, a > 0.5, a < 0.5)
        if not bool(keep.any()):
            break
        eps = torch.where(keep, eps * torch.exp2(d), eps)
        k += 1
        # chains that stopped keep their ε; only the others are re-read
        a = torch.where(keep, accept(eps), a)
    # one step back toward the crossing point for the shrinking direction
    return torch.where(d > 0, eps, eps * 2.0) / 2.0


def window_adaptation_init(q: torch.Tensor, eps0,
                           inv_mass0=None) -> AdaptState:
    """Adaptation state of chains at q [C, D] with initial ε (a number or
    [C]) and an optional initial inverse mass ([D] or [C, D])."""
    C, d = q.shape
    dt, dev = q.dtype, q.device
    log_eps = torch.log(torch.as_tensor(eps0, dtype=dt,
                                        device=dev).expand(C)).clone()
    inv_mass = (torch.ones(C, d, dtype=dt, device=dev) if inv_mass0 is None
                else torch.as_tensor(inv_mass0, dtype=dt,
                                     device=dev).expand(C, d).clone())
    zeros = torch.zeros(C, dtype=dt, device=dev)
    return AdaptState(
        log_eps=log_eps, log_eps_avg=log_eps.clone(), h_avg=zeros,
        mu=math.log(10.0) + log_eps, count=zeros.clone(),
        w_mean=torch.zeros(C, d, dtype=dt, device=dev),
        w_m2=torch.zeros(C, d, dtype=dt, device=dev), inv_mass=inv_mass)


def curvature_inv_mass(logprob_fn: Callable, q: torch.Tensor,
                       floor: float = 1e-6) -> torch.Tensor:
    """Diagonal inverse-mass init [D] from the target's curvature at q [D].

    Per dimension: inverse mass = 1 / (−∂²logp/∂q²), the Laplace
    variance, wherever the curvature is above ``floor`` (at or near a
    mode), unit mass elsewhere, clipped to [1e-6, 1e6].  The JAX package
    takes the Hessian diagonal as D forward-over-reverse products; the NLML
    path here is differentiable once (its kernels' adjoints are hand
    written), so the diagonal is the central difference of the gradient,
    −(gᵢ(q + hᵢeᵢ) − gᵢ(q − hᵢeᵢ)) / 2hᵢ, with hᵢ = ε_mach^(1/3)·max(1, |qᵢ|)
    (6.1e-6 in float64, 4.9e-3 in float32: the step that balances the
    O(h²) truncation against rounding): 2D gradient evaluations in one
    batch of 2D chains.  On a quadratic target the difference is exact to
    rounding.
    """
    D = q.shape[0]
    h = torch.finfo(q.dtype).eps ** (1.0 / 3.0) * q.abs().clamp_min(1.0)
    step = torch.diag(h)
    _, g = value_and_grad(logprob_fn, torch.cat([q + step, q - step]))
    idx = torch.arange(D, device=q.device)
    curv = -(g[idx, idx] - g[D + idx, idx]) / (2.0 * h)
    var = torch.where(curv > floor, 1.0 / curv.clamp_min(floor),
                      torch.ones_like(curv))
    return var.clamp(1e-6, 1e6)


def pooled_mean(x: torch.Tensor, pool_group=None) -> torch.Tensor:
    """The mean of ``x`` [C] over its chains and, with ``pool_group`` (a
    ``torch.distributed`` process group whose ranks hold C chains each),
    over every rank's chains, the same bits on every rank: the JAX
    package's ``pmean`` over the (vmap, mesh) axes."""
    if pool_group is None:
        return x.mean()
    import torch.distributed as dist
    from ..parallel.distributed import ordered_sum
    return (ordered_sum(x.sum(), pool_group)
            / (x.shape[0] * dist.get_world_size(pool_group)))


def window_adaptation_update(adapt: AdaptState, q: torch.Tensor,
                             accept_stat: torch.Tensor,
                             target: float = 0.8,
                             pool_eps: bool = False,
                             pool_group=None) -> AdaptState:
    """Nesterov dual averaging on ε + Welford update of the diagonal mass.

    With ``pool_eps`` the acceptance statistic is the mean over the batch's
    chains, and over every rank's chains of ``pool_group`` when it is
    given (:func:`pooled_mean`), so every chain shares one ε (the JAX
    package's ``pmean`` over ``axis_name``).  Without a group nothing
    leaves this process."""
    a = accept_stat
    if pool_eps:
        a = pooled_mean(a, pool_group).expand(a.shape)
    t = adapt.count + 1.0
    kappa, gamma, t0 = 0.75, 0.05, 10.0
    h_avg = (1.0 - 1.0 / (t + t0)) * adapt.h_avg + (target - a) / (t + t0)
    log_eps = adapt.mu - torch.sqrt(t) / gamma * h_avg
    w = t ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * adapt.log_eps_avg

    delta = q - adapt.w_mean
    w_mean = adapt.w_mean + delta / _col(t)
    w_m2 = adapt.w_m2 + delta * (q - w_mean)
    return adapt._replace(log_eps=log_eps, log_eps_avg=log_eps_avg,
                          h_avg=h_avg, count=t, w_mean=w_mean, w_m2=w_m2)


def _finalize_mass(adapt: AdaptState) -> AdaptState:
    """Regularized sample variance → inverse mass (Stan-style shrinkage),
    followed by a dual-averaging RESTART re-anchored at the current ε.

    The restart is load-bearing: ``count`` doubles as the Welford n and
    the dual-averaging time t, so zeroing it without also resetting
    (h_avg, μ, log_eps_avg) snaps ε back toward the *initial* anchor
    after every mass update (the JAX package measured ε collapsing to 1e-4
    and every tree at max depth that way).  Stan restarts dual averaging
    at each window boundary for exactly this reason."""
    n = _col(adapt.count.clamp_min(2.0))
    var = adapt.w_m2 / (n - 1.0)
    var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    eps = torch.exp(adapt.log_eps)
    return AdaptState(
        log_eps=torch.log(eps), log_eps_avg=torch.log(eps),
        h_avg=torch.zeros_like(adapt.h_avg), mu=torch.log(10.0 * eps),
        count=torch.zeros_like(adapt.count),
        w_mean=torch.zeros_like(adapt.w_mean),
        w_m2=torch.zeros_like(adapt.w_m2), inv_mass=var)


def run_hmc(logprob_fn: Callable, q0: torch.Tensor, seed: int = 0, *,
            num_warmup: int = 500, num_samples: int = 500,
            n_leapfrog: int = 16, target_accept: float = 0.8,
            pool_eps: bool = False):
    """Full HMC run of the chains q0 [C, D].

    Warmup: two halves — the first adapts ε only, the second also
    accumulates the diagonal mass matrix, applied at the midpoint and the
    end (dual averaging restarts at each boundary, Stan-style).  ε starts
    from the Hoffman-Gelman doubling search.  Returns (samples
    [C, num_samples, D], info dict of per-chain traces)."""
    gen = make_generator(seed, q0.device)
    state = init_state(logprob_fn, q0)
    eps0 = find_reasonable_epsilon(logprob_fn, state, gen)
    adapt = window_adaptation_init(q0, eps0)

    half = num_warmup // 2
    for n in (half, num_warmup - half):
        for _ in range(n):
            state, info = hmc_step(logprob_fn, state, gen,
                                   torch.exp(adapt.log_eps), adapt.inv_mass,
                                   n_leapfrog)
            adapt = window_adaptation_update(adapt, state.q,
                                             info["accept_stat"],
                                             target_accept, pool_eps)
        adapt = _finalize_mass(adapt)
    eps = torch.exp(adapt.log_eps_avg)

    qs, accs, divs = [], [], []
    for _ in range(num_samples):
        state, info = hmc_step(logprob_fn, state, gen, eps, adapt.inv_mass,
                               n_leapfrog)
        qs.append(state.q)
        accs.append(info["accept_stat"])
        divs.append(info["diverged"])
    return torch.stack(qs, 1), {
        "accept_rate": torch.stack(accs).mean(0),
        "divergences": torch.stack(divs).sum(0),
        "step_size": eps, "inv_mass": adapt.inv_mass}


def run_hmc_pytree(logprob_fn: Callable, init_params: dict, seed: int = 0,
                   **kw):
    """Dict-of-tensors adapter around :func:`run_hmc`: ``init_params`` maps
    names to [C, *shape] chain starts, ``logprob_fn`` takes such a dict;
    the samples come back as a dict of [C, S, *shape]."""
    flat0, unravel = ravel_chains(init_params)
    qs, info = run_hmc(lambda q: logprob_fn(unravel(q)), flat0, seed, **kw)
    C, S = qs.shape[:2]
    return {k: v.reshape(C, S, *v.shape[1:])
            for k, v in unravel(qs.reshape(C * S, -1)).items()}, info


def ravel_chains(params: dict):
    """(θ [C, D], unravel) for a dict of [C, *shape] tensors, the entries in
    sorted key order (``jax.flatten_util.ravel_pytree``'s order for a
    flat dict); ``unravel`` maps [B, D] back to a dict of [B, *shape]."""
    names = sorted(params)
    shapes = [tuple(params[n].shape[1:]) for n in names]
    sizes = [int(np.prod(s)) for s in shapes]
    C = next(iter(params.values())).shape[0]
    flat = torch.cat([params[n].reshape(C, -1) for n in names], dim=1)

    def unravel(theta):
        parts = theta.split(sizes, dim=1)
        return {n: p.reshape(theta.shape[0], *s)
                for n, p, s in zip(names, parts, shapes)}

    return flat, unravel

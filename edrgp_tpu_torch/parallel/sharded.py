"""Sharded training and sampling steps over a device mesh.

The port of :mod:`edrgp_tpu.parallel.sharded` onto ``torch.distributed``:

  * :func:`make_sharded_svgp_step` — data-parallel SVGP: the minibatch's
    rows split over the ``data`` dimension, the ELBO's gradient and the
    natural-gradient statistics summed over it, the parameters replicated.
  * :func:`run_sharded_nuts` — chain-parallel NUTS: each rank runs the
    batch-first sampler on its chains, with ε's dual averaging pooled over
    every chain of every rank.
  * :func:`distributed_systematic_resample` and
    :func:`run_sharded_smc_stage` — SMC with the particles split over a
    dimension: the log-weights all-gathered, the same global ancestors
    picked on every rank from one shared uniform, then each rank gathers
    its own.

Sums that feed replicated state are taken in rank order
(:func:`~edrgp_tpu_torch.parallel.distributed.ordered_sum`), so the
replicas keep the same bits.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..ops import svgp as _svgp
from ..ops.exact import noise_variance
from .distributed import all_gather_cat, collective_device, ordered_sum
from .mesh import axis_groups, axis_index, axis_size, shard_along

__all__ = ["make_sharded_svgp_step", "run_sharded_nuts",
           "distributed_systematic_resample", "run_sharded_smc_stage"]

_LOG2PI = math.log(2.0 * math.pi)


def make_sharded_svgp_step(gp, mesh, n_total: int, lr: float = 3e-3,
                           data_axis: str | tuple = "data"):
    """A data-parallel SVGP step for ``gp`` (an
    :class:`~edrgp_tpu_torch.models.svgp.SVGPModel` or any module holding
    ``kernel``, ``raw_noise`` and ``Z``): ``(step, opt_init)``.

    ``opt_init()`` builds the Adam optimizer of ``gp``'s parameters;
    ``step(opt, qstate, Xb, yb, rho) -> (qstate, elbo)`` takes this rank's
    rows of the minibatch (:func:`~edrgp_tpu_torch.parallel.mesh.shard_along`
    over ``data_axis``), takes one Adam step of ``gp``'s parameters in
    place on the minibatch ELBO (each rank weights the KL by 1/n_shards, so
    the sum of the ranks' losses is the ELBO) and one natural-gradient
    step of q(u) at the updated parameters, and returns the new q(u) and
    the ELBO before both.  ``data_axis`` may be a tuple of dimensions
    (``("host", "data")`` on a hybrid mesh): the batch is then split over
    their product and every sum runs over each in turn.
    """
    groups = axis_groups(mesh, data_axis)
    n_shards = axis_size(mesh, data_axis)
    params = list(gp.parameters())

    def total(x):
        for g in groups:
            x = ordered_sum(x, g)
        return x

    def opt_init():
        return torch.optim.Adam(params, lr=float(lr))

    def step(opt, qstate, Xb, yb, rho):
        B_local = Xb.shape[0]
        scale = n_total / (B_local * n_shards)
        m, S = _svgp.q_from_natural(qstate)
        with torch.enable_grad():
            sigma2 = noise_variance(gp)
            mu, var, Luu = _svgp._latent_moments(gp, m, S, Xb)
            quad = ((yb - mu) ** 2 + var).sum()
            exp_ll = -0.5 * (B_local * (_LOG2PI + torch.log(sigma2))
                             + quad / sigma2)
            loss = -(scale * exp_ll - _svgp._kl(m, S, Luu) / n_shards)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        flat = total(torch.cat([loss.detach().reshape(1)] + [
            (torch.zeros_like(p) if g is None else g).reshape(-1)
            for p, g in zip(params, grads)]))
        for p, g in zip(params, flat[1:].split([p.numel() for p in params])):
            p.grad = g.view_as(p).clone()
        opt.step()
        Kuu_inv, t1, t2 = _svgp.natural_gradient_stats(gp, Xb, yb)
        M = t1.shape[0]
        t12 = total(torch.cat([t1, t2.reshape(-1)]))
        qstate = _svgp.natural_gradient_step(
            gp, qstate, Kuu_inv, t12[:M], t12[M:].view(M, M), scale, rho)
        return qstate, -flat[0]

    return step, opt_init


def _gather_numpy(a, group, device) -> np.ndarray:
    """Every rank's array ``a`` concatenated along dim 0, as numpy."""
    t = torch.as_tensor(np.ascontiguousarray(a)).to(device)
    return all_gather_cat(t, group).cpu().numpy()


def run_sharded_nuts(logprob_fn: Callable, q0_chains: torch.Tensor,
                     seed: int, mesh, *, chain_axis: str = "chain",
                     num_warmup: int = 200, num_samples: int = 200,
                     max_depth: int = 6, **kwargs):
    """NUTS over C chains split over ``mesh``'s dimension ``chain_axis``.

    ``q0_chains`` [C, D] (every chain's start, the same on every rank; C
    divisible by the dimension's size): each rank runs
    :func:`~edrgp_tpu_torch.inference.nuts.run_nuts_segmented` on its own
    chains, batch-first, from its own generator (seed·p + rank), with the
    acceptance statistic pooled over every chain of every rank, so all
    chains share one ε trajectory.  Further keywords go to
    ``run_nuts_segmented``.  Returns, on every rank, (samples [C, S, D]
    numpy, info) with every chain's step size and inverse mass and the
    accept rate, divergences and mean leapfrogs over all chains.
    """
    from ..inference.nuts import run_nuts_segmented
    group = mesh.get_group(chain_axis)
    p, s = axis_size(mesh, chain_axis), axis_index(mesh, chain_axis)
    q0 = shard_along(mesh, chain_axis, q0_chains)
    qs, info = run_nuts_segmented(
        logprob_fn, q0, int(seed) * p + s, num_warmup=num_warmup,
        num_samples=num_samples, max_depth=max_depth, pool_eps=True,
        pool_group=group, **kwargs)
    dev = collective_device(group)
    stats = _gather_numpy(np.array([[info["accept_rate"],
                                     info["divergences"],
                                     info["mean_leapfrogs"]]]), group, dev)
    return _gather_numpy(qs, group, dev), {
        "accept_rate": float(stats[:, 0].mean()),
        "divergences": int(stats[:, 1].sum()),
        "step_size": _gather_numpy(info["step_size"], group, dev),
        "mean_leapfrogs": float(stats[:, 2].mean()),
        "inv_mass": _gather_numpy(info["inv_mass"], group, dev)}


def distributed_systematic_resample(u0, log_w_local: torch.Tensor,
                                    particles_local: torch.Tensor, mesh,
                                    axis: str = "chain"):
    """Globally consistent systematic resampling with the particles split
    over ``axis``: all-gather the log-weights, pick the global ancestors
    from the one uniform ``u0`` every rank shares
    (:func:`~edrgp_tpu_torch.inference.smc.systematic_resample`, the same
    vector on every rank), then take this rank's ancestors from the
    all-gathered particles.  Returns (particles_local, log_w_all)."""
    from ..inference.smc import systematic_resample
    group = mesh.get_group(axis)
    n_local = log_w_local.shape[0]
    s = axis_index(mesh, axis)
    log_w_all = all_gather_cat(log_w_local, group)
    ancestors = systematic_resample(u0, log_w_all)
    mine = ancestors[s * n_local:(s + 1) * n_local]
    return all_gather_cat(particles_local, group)[mine], log_w_all


def run_sharded_smc_stage(loglik_fn: Callable, logprior_fn: Callable,
                          mesh, *, particle_axis: str = "chain",
                          num_mcmc: int = 3, n_leapfrog: int = 8,
                          eps: float = 0.2):
    """One SMC tempering stage with the particles split over
    ``particle_axis``: ``stage(particles_local, beta_old, beta_new, seed)
    -> (particles_local, logZ_inc)``.  It reweights by the tempering
    increment, resamples collectively (u0 from ``seed``, the same on every
    rank), and rejuvenates this rank's particles, as one batch, with
    ``num_mcmc`` multinomial-HMC sweeps of ``n_leapfrog`` steps at unit
    mass, drawn from a generator of its own (seed·p + rank).
    ``loglik_fn`` and ``logprior_fn`` map particles [n, D] to [n]; the β
    schedule stays with the caller."""
    from ..inference.hmc import hmc_step, init_state, make_generator
    p = axis_size(mesh, particle_axis)
    s = axis_index(mesh, particle_axis)

    def stage(particles_local, beta_old, beta_new, seed):
        with torch.no_grad():
            loglik = loglik_fn(particles_local)
        log_w_local = (beta_new - beta_old) * loglik
        u0 = float(np.random.default_rng(seed).random())
        particles_local, log_w_all = distributed_systematic_resample(
            u0, log_w_local, particles_local, mesh, particle_axis)
        logZ_inc = (torch.logsumexp(log_w_all, 0)
                    - math.log(log_w_all.shape[0]))

        def temp_logprob(q):
            return beta_new * loglik_fn(q) + logprior_fn(q)

        gen = make_generator(int(seed) * p + s, particles_local.device)
        state = init_state(temp_logprob, particles_local)
        ones = torch.ones_like(particles_local[0])
        for _ in range(num_mcmc):
            state, _ = hmc_step(temp_logprob, state, gen, eps, ones,
                                n_leapfrog)
        return state.q, logZ_inc

    return stage

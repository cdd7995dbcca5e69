"""Sequential Monte Carlo sampler (adaptive tempering + HMC moves).

The port of :mod:`edrgp_tpu.inference.smc` (Del Moral et al. 2006,
adaptive-β variant), batch-first: ``loglik_fn`` and ``logprior_fn`` map
particles [N, D] to [N].

  1. start from N particles (prior draws, or draws around a fit);
  2. bisect for the next inverse temperature β whose incremental weights
     keep the ESS at a target;
  3. resample systematically, then rejuvenate every particle with K HMC
     steps targeting p(θ)^β·prior, all particles in one batch (or in
     groups of ``particle_chunk``);
  4. repeat until β = 1.  Returns particles and the log-evidence estimate.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .hmc import hmc_step, init_state, make_generator, ravel_chains

__all__ = ["systematic_resample", "run_smc", "run_smc_segmented",
           "run_smc_pytree", "ess"]


def ess(log_w: torch.Tensor) -> torch.Tensor:
    """Effective sample size of normalized log-weights."""
    w = torch.softmax(log_w, -1)
    return 1.0 / (w * w).sum(-1)


def systematic_resample(u0, log_w: torch.Tensor) -> torch.Tensor:
    """Systematic resampling → ancestor indices [N], given the one uniform
    offset ``u0`` in [0, 1): N evenly spaced points through the weight
    CDF, the lowest-variance O(N) scheme.  The JAX package draws u0 from
    its key; the same u0 gives the same indices."""
    n = log_w.shape[0]
    cdf = torch.cumsum(torch.softmax(log_w, -1), 0)
    pts = (torch.as_tensor(u0, dtype=log_w.dtype, device=log_w.device)
           + torch.arange(n, dtype=log_w.dtype, device=log_w.device)) / n
    return torch.searchsorted(cdf, pts).clamp(0, n - 1)


def _next_beta(loglik: torch.Tensor, beta, target_ess: float):
    """Bisect for the largest Δβ whose incremental weights keep ESS ≥
    target (30 halvings at most, to a bracket of 1e-6); one host read per
    halving."""
    beta = float(beta)

    def ok(b):
        return bool(ess((b - beta) * loglik) >= target_ess)

    if ok(1.0):
        return torch.tensor(1.0, dtype=loglik.dtype, device=loglik.device)
    lo, hi = beta, 1.0
    for _ in range(30):
        if hi - lo <= 1e-6:
            break
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if ok(mid) else (lo, mid)
    return torch.tensor(lo, dtype=loglik.dtype, device=loglik.device)


def _rejuvenate(loglik_fn, logprior_fn, particles, beta, gen, eps, inv_mass,
                num_mcmc: int, n_leapfrog: int, chunk: int):
    """``num_mcmc`` multinomial-HMC sweeps of every particle at temperature
    β, ``chunk`` particles a batch; (particles, mean acceptance)."""
    def temp_logprob(q):
        return beta * loglik_fn(q) + logprior_fn(q)

    out, accs = [], []
    for group in particles.split(chunk):
        st = init_state(temp_logprob, group)
        for _ in range(num_mcmc):
            st, info = hmc_step(temp_logprob, st, gen, eps, inv_mass,
                                n_leapfrog)
            accs.append(info["accept_stat"])
        out.append(st.q)
    return torch.cat(out), torch.cat(accs).mean() if accs else None


def run_smc(loglik_fn: Callable, logprior_fn: Callable,
            particles0: torch.Tensor, seed: int = 0, *,
            num_mcmc: int = 5, n_leapfrog: int = 10, eps: float = 0.1,
            target_ess_frac: float = 0.5, max_stages: int = 50):
    """Adaptive-tempering SMC from ``particles0`` [N, D] with a fixed HMC
    kernel (unit mass, step ``eps``).

    Returns (particles [N, D], info) with ``info["log_evidence"]`` the
    tempered estimate of log Z and ``info["beta_trace"]`` the temperature
    ladder actually taken (−1 padding past termination, to ``max_stages``).
    """
    N, D = particles0.shape
    dt, dev = particles0.dtype, particles0.device
    gen = make_generator(seed, dev)
    particles = particles0
    beta = torch.zeros((), dtype=dt, device=dev)
    logZ = torch.zeros((), dtype=dt, device=dev)
    betas = torch.full((max_stages,), -1.0, dtype=dt, device=dev)
    ones = torch.ones(D, dtype=dt, device=dev)
    for stage in range(max_stages):
        loglik = loglik_fn(particles)
        new_beta = _next_beta(loglik, beta, target_ess_frac * N)
        log_w = (new_beta - beta) * loglik
        logZ = logZ + torch.logsumexp(log_w, 0) - math.log(N)
        u0 = torch.rand((), generator=gen, dtype=dt, device=dev)
        particles = particles[systematic_resample(u0, log_w)]
        particles, _ = _rejuvenate(loglik_fn, logprior_fn, particles,
                                   new_beta, gen, eps, ones, num_mcmc,
                                   n_leapfrog, N)
        beta = new_beta
        betas[stage] = beta
        if bool(beta >= 1.0):
            break
    return particles, {"log_evidence": logZ, "beta_trace": betas,
                       "final_beta": beta, "converged": bool(beta >= 1.0)}


def run_smc_segmented(loglik_fn: Callable, logprior_fn: Callable,
                      particles0: torch.Tensor, seed: int = 0, *,
                      num_mcmc: int = 5, n_leapfrog: int = 10,
                      eps: float = 0.1, target_ess_frac: float = 0.5,
                      max_stages: int = 50,
                      particle_chunk: int | None = None,
                      on_stage: Callable | None = None):
    """Adaptive-tempering SMC with an adaptive rejuvenation kernel, one host
    round per β-stage, stopping as soon as β reaches 1.

    ``particle_chunk`` bounds how many particles one batched likelihood or
    HMC call holds (the memory knob when each likelihood holds O(N²)
    temporaries); the groups run in turn.  ``on_stage(stage_idx, beta, ess,
    logZ)`` is a host-side progress hook.

    The rejuvenation kernel ADAPTS between stages: the HMC inverse mass is
    the resampled ensemble's per-dimension variance (the current
    posterior-scale estimate) and ε is driven toward ~0.6 mean trajectory
    acceptance by a clipped multiplicative update; ``eps`` seeds the first
    stage only.  A fixed-scale kernel freezes once β·curvature outgrows it:
    duplicates from resampling never re-diversify and the ESS turns into a
    copy-counter while it "rises", which the
    ``unique_particles_after_resample`` trace exposes.

    Returns (particles [N, D], info) with the β, ESS, log-weight and
    log-likelihood spreads, unique particles, ε and acceptance traces as
    Python lists of the stages run.
    """
    N, D = particles0.shape
    dt, dev = particles0.dtype, particles0.device
    chunk = int(particle_chunk) if particle_chunk else N
    if N % chunk:
        raise ValueError(f"particles ({N}) must divide by particle_chunk "
                         f"({chunk})")
    gen = make_generator(seed, dev)
    particles = particles0
    beta = torch.zeros((), dtype=dt, device=dev)
    logZ = torch.zeros((), dtype=dt, device=dev)
    betas, esss, logw_stds, loglik_stds, uniques = [], [], [], [], []
    eps_trace, acc_trace = [], []
    eps_s = float(eps)
    for stage_idx in range(max_stages):
        loglik = torch.cat([loglik_fn(p) for p in particles.split(chunk)])
        new_beta = _next_beta(loglik, beta, target_ess_frac * N)
        log_w = (new_beta - beta) * loglik
        ess_val = ess(log_w)
        logZ = logZ + torch.logsumexp(log_w, 0) - math.log(N)
        u0 = torch.rand((), generator=gen, dtype=dt, device=dev)
        particles = particles[systematic_resample(u0, log_w)]
        # Per-stage weight diagnostics: a large final Δβ with a high ESS
        # is legitimate iff Δβ·std(loglik) is small; read it with the
        # unique-particle count, which tells it from particle collapse.
        logw_stds.append(float(log_w.std(correction=0)))
        loglik_stds.append(float(loglik.std(correction=0)))
        uniques.append(int(np.unique(particles.cpu().numpy(),
                                     axis=0).shape[0]))
        # Ensemble-variance preconditioning: as β climbs and the target
        # tightens, the rejuvenation kernel tightens with it.
        inv_mass = particles.var(0, correction=0).clamp_min(1e-12)
        particles, acc = _rejuvenate(loglik_fn, logprior_fn, particles,
                                     new_beta, gen, eps_s, inv_mass,
                                     num_mcmc, n_leapfrog, chunk)
        acc = float(acc) if acc is not None else 0.0
        beta = new_beta
        betas.append(float(beta))
        esss.append(float(ess_val))
        eps_trace.append(eps_s)
        acc_trace.append(acc)
        if on_stage is not None:
            on_stage(stage_idx, betas[-1], esss[-1], float(logZ))
        if betas[-1] >= 1.0:
            break
        # Robbins-Monro-flavored ε adaptation toward ~0.6 mean trajectory
        # acceptance (multinomial-HMC statistic), clipped to 4×/stage.
        eps_s = float(np.clip(eps_s * np.exp(1.5 * (acc - 0.6)),
                              eps_s * 0.25, eps_s * 4.0))
    return particles, {"log_evidence": float(logZ),
                       "beta_trace": betas, "ess_trace": esss,
                       "logw_std_trace": logw_stds,
                       "loglik_std_trace": loglik_stds,
                       "unique_particles_after_resample": uniques,
                       "eps_trace": eps_trace, "accept_trace": acc_trace,
                       "final_beta": betas[-1] if betas else 0.0,
                       "converged": bool(betas and betas[-1] >= 1.0),
                       "n_stages": len(betas)}


def run_smc_pytree(loglik_fn: Callable, logprior_fn: Callable,
                   particles0: dict, seed: int = 0, **kw):
    """Dict-of-tensors adapter around :func:`run_smc`: particles carry a
    leading particle axis on every entry."""
    flat, unravel = ravel_chains(particles0)
    particles, info = run_smc(lambda q: loglik_fn(unravel(q)),
                              lambda q: logprior_fn(unravel(q)), flat, seed,
                              **kw)
    return unravel(particles), info

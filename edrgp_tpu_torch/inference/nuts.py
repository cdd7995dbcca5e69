"""No-U-Turn Sampler, batch-first over chains.

The port of :mod:`edrgp_tpu.inference.nuts`: generalized multinomial NUTS
(Betancourt 2017) with within-subtree progressive multinomial sampling,
biased progressive sampling across doublings, and the full dyadic U-turn
checks by prefix-sum checkpoints (one slot per tree level, O(max_depth)
memory): a balanced subtree ``[n−2^k+1, n]`` closes at leaf ``n`` iff
``2^k | (n+1)``, and its momentum sum is rebuilt from a checkpoint written
when the interval opened (``2^k | n``).

The JAX package runs one chain per function under ``vmap``, where a
``while_loop`` runs until every lane is done and masks the lanes that
finished.  Here the chains are a leading axis [C, D] and every loop is a
Python loop that runs while any chain is active, with ``torch.where``
updates of the active chains only: one host read per leapfrog step and per
doubling.  A leapfrog step evaluates ``logprob_fn`` on the batch of the
chains still active, so a transition's gradient work is the sum of its
chains' trees (under ``vmap`` every lane pays for the deepest tree); its
host steps still follow the deepest tree.  Chains that are active in a
doubling all sit at the same depth and leaf index, so the checkpoint slots
are host integers.  A chain whose energy is not finite (a failed Cholesky gives NaN)
stops its tree as a divergence; NaN stays in its own lane.

Step size and mass adaptation reuse :mod:`.hmc`'s window adaptation,
including ε pooled over the chains of a batch.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .hmc import (HMCState, _finalize_mass, _kinetic, _momentum, init_state,
                  find_reasonable_epsilon, make_generator, pooled_mean,
                  ravel_chains, value_and_grad, window_adaptation_init,
                  window_adaptation_update)

__all__ = ["nuts_step", "run_nuts", "run_nuts_pytree", "run_nuts_segmented"]

_DIVERGENCE_THRESHOLD = 1000.0


def _tz(n: int) -> int:
    """Trailing zeros of a positive integer."""
    return (n & -n).bit_length() - 1


def _is_turning(inv_mass, p_left, p_right, rho):
    """Generalized U-turn: either end's velocity opposes the interval sum
    (a bool per row of the leading axes)."""
    v_left = inv_mass * p_left
    v_right = inv_mass * p_right
    return ((v_left * rho).sum(-1) <= 0) | ((v_right * rho).sum(-1) <= 0)


def _where(mask, n_true: int, new: dict, old: dict) -> dict:
    """Per-chain select of every field: ``new`` where ``mask`` [C], which
    holds ``n_true`` Trues (all of them: ``new`` as it is)."""
    if n_true == mask.shape[0]:
        return new
    return {k: torch.where(mask.view(-1, *[1] * (v.ndim - 1)), v, old[k])
            for k, v in new.items()}


def _value_and_grad_of(logprob_fn, q, mask, n_true: int):
    """(log p [C], ∇ log p [C, D]) at the chains of ``mask`` (``n_true`` of
    them), evaluated as one batch of those chains only; the other rows are
    zero, and the caller's masked update discards them."""
    if n_true == mask.shape[0]:
        return value_and_grad(logprob_fn, q)
    idx = mask.nonzero()[:, 0]
    logp, grad = value_and_grad(logprob_fn, q[idx])
    return (torch.zeros_like(q[:, 0]).index_copy(0, idx, logp),
            torch.zeros_like(q).index_copy(0, idx, grad))


def _build_subtree(logprob_fn, q0, p0, grad0, eps, inv_mass, n_leaves: int,
                   energy0, gen, max_depth: int, active):
    """Integrate up to ``n_leaves`` leapfrog steps of each ``active`` chain
    from one edge, in the subtree's local time (q̇ = +M⁻¹p); returns edge
    state, subtree multinomial proposal, log weight, momentum sum and stop
    flags, per chain."""
    C, D = q0.shape
    dt, dev = q0.dtype, q0.device
    e = eps[:, None]
    K = max_depth + 1
    s = {
        "n": torch.zeros(C, dtype=torch.int64, device=dev),
        "q": q0, "p": p0, "grad": grad0,
        "psum": torch.zeros_like(q0),
        "p_start": torch.zeros(C, K, D, dtype=dt, device=dev),
        "psum_before": torch.zeros(C, K, D, dtype=dt, device=dev),
        "log_sum_w": torch.full((C,), -math.inf, dtype=dt, device=dev),
        "q_prop": q0,
        "logp_prop": torch.full((C,), -math.inf, dtype=dt, device=dev),
        "grad_prop": grad0,
        "turning": torch.zeros(C, dtype=torch.bool, device=dev),
        "diverging": torch.zeros(C, dtype=torch.bool, device=dev),
        "sum_accept": torch.zeros(C, dtype=dt, device=dev),
    }
    slots = torch.arange(K, device=dev)
    for n in range(n_leaves):
        go = active & ~s["turning"] & ~s["diverging"]
        n_go = int(go.sum())
        if n_go == 0:
            break
        # -- leapfrog step (local time, step +eps)
        p_half = s["p"] + 0.5 * e * s["grad"]
        q = s["q"] + e * inv_mass * p_half
        logp, grad = _value_and_grad_of(logprob_fn, q, go, n_go)
        p = p_half + 0.5 * e * grad

        energy = logp - _kinetic(p, inv_mass)
        log_w = energy - energy0
        diverging = ~((energy0 - energy) <= _DIVERGENCE_THRESHOLD)
        log_w = torch.where(torch.isfinite(log_w), log_w,
                            torch.full_like(log_w, -math.inf))

        # -- checkpoint opens: intervals [n, n+2^k−1] for k ≤ tz(n)
        t_open = max_depth if n == 0 else _tz(n)
        open_mask = (slots <= t_open)[None, :, None]
        p_start = torch.where(open_mask, p[:, None, :], s["p_start"])
        psum_before = torch.where(open_mask, s["psum"][:, None, :],
                                  s["psum_before"])
        psum = s["psum"] + p

        # -- checkpoint closes: intervals [n−2^k+1, n] for k ≤ tz(n+1)
        t_close = min(_tz(n + 1), max_depth)
        rho_k = psum[:, None, :] - psum_before[:, :t_close + 1]
        turning = _is_turning(inv_mass[:, None, :],
                              p_start[:, :t_close + 1], p[:, None, :],
                              rho_k).any(-1)

        # -- progressive multinomial proposal within the subtree
        log_sum_w = torch.logaddexp(s["log_sum_w"], log_w)
        u = torch.rand(C, generator=gen, dtype=dt, device=dev)
        take = (torch.log(u) < (log_w - log_sum_w))[:, None]
        accept = torch.exp(torch.clamp(log_w, max=0.0))
        s = _where(go, n_go, {
            "n": s["n"] + 1, "q": q, "p": p, "grad": grad,
            "psum": psum, "p_start": p_start, "psum_before": psum_before,
            "log_sum_w": log_sum_w,
            "q_prop": torch.where(take, q, s["q_prop"]),
            "logp_prop": torch.where(take[:, 0], logp, s["logp_prop"]),
            "grad_prop": torch.where(take, grad, s["grad_prop"]),
            "turning": turning, "diverging": diverging,
            "sum_accept": s["sum_accept"] + accept}, s)
    return s


def nuts_step(logprob_fn: Callable, state: HMCState, gen: torch.Generator,
              eps, inv_mass: torch.Tensor, max_depth: int = 8):
    """One NUTS transition of every chain (``eps`` a number or [C],
    ``inv_mass`` [C, D] or [D]).  Returns (HMCState, info of [C] values)."""
    q = state.q
    C = q.shape[0]
    dt, dev = q.dtype, q.device
    eps = torch.as_tensor(eps, dtype=dt, device=dev).expand(C)
    inv_mass = inv_mass.expand(q.shape)
    p0 = _momentum(gen, q, inv_mass)
    energy0 = state.logp - _kinetic(p0, inv_mass)

    t = {
        "q_left": q, "p_left": p0, "grad_left": state.grad,
        "q_right": q, "p_right": p0, "grad_right": state.grad,
        "q_prop": q, "logp_prop": state.logp, "grad_prop": state.grad,
        "log_sum_w": torch.zeros(C, dtype=dt, device=dev), "rho": p0,
        "depth": torch.zeros(C, dtype=torch.int64, device=dev),
        "turning": torch.zeros(C, dtype=torch.bool, device=dev),
        "diverging": torch.zeros(C, dtype=torch.bool, device=dev),
        "sum_accept": torch.zeros(C, dtype=dt, device=dev),
        "n_leaves": torch.ones(C, dtype=torch.int64, device=dev),
    }
    for depth in range(max_depth):
        active = ~t["turning"] & ~t["diverging"]
        n_active = int(active.sum())
        if n_active == 0:
            break
        u_dir = torch.rand(C, generator=gen, dtype=dt, device=dev)
        v = torch.where(u_dir < 0.5, 1.0, -1.0).to(dt)
        right = (v > 0)[:, None]
        sub = _build_subtree(
            logprob_fn, torch.where(right, t["q_right"], t["q_left"]),
            torch.where(right, t["p_right"], -t["p_left"]),
            torch.where(right, t["grad_right"], t["grad_left"]), eps,
            inv_mass, 2 ** depth, energy0, gen, max_depth, active)
        sub_ok = ~sub["turning"] & ~sub["diverging"]

        # new edge in global time (leftward momenta flip back)
        p_edge = torch.where(right, sub["p"], -sub["p"])
        p_left = torch.where(right, t["p_left"], p_edge)
        p_right = torch.where(right, p_edge, t["p_right"])

        # biased progressive sampling: favor the new subtree
        u_bias = torch.rand(C, generator=gen, dtype=dt, device=dev)
        take = ((torch.log(u_bias) < sub["log_sum_w"] - t["log_sum_w"])
                & sub_ok)[:, None]
        rho = t["rho"] + v[:, None] * sub["psum"]
        full_turning = _is_turning(inv_mass, p_left, p_right, rho)
        t = _where(active, n_active, {
            "q_left": torch.where(right, t["q_left"], sub["q"]),
            "p_left": p_left,
            "grad_left": torch.where(right, t["grad_left"], sub["grad"]),
            "q_right": torch.where(right, sub["q"], t["q_right"]),
            "p_right": p_right,
            "grad_right": torch.where(right, sub["grad"], t["grad_right"]),
            "q_prop": torch.where(take, sub["q_prop"], t["q_prop"]),
            "logp_prop": torch.where(take[:, 0], sub["logp_prop"],
                                     t["logp_prop"]),
            "grad_prop": torch.where(take, sub["grad_prop"], t["grad_prop"]),
            "log_sum_w": torch.logaddexp(t["log_sum_w"], sub["log_sum_w"]),
            "rho": rho, "depth": t["depth"] + 1,
            "turning": sub["turning"] | (full_turning & sub_ok),
            "diverging": sub["diverging"],
            "sum_accept": t["sum_accept"] + sub["sum_accept"],
            "n_leaves": t["n_leaves"] + sub["n"]}, t)

    new_state = HMCState(q=t["q_prop"], logp=t["logp_prop"],
                         grad=t["grad_prop"])
    accept_stat = t["sum_accept"] / (t["n_leaves"] - 1).clamp_min(1).to(dt)
    return new_state, {"accept_stat": accept_stat,
                       "diverged": t["diverging"], "depth": t["depth"],
                       "n_leaves": t["n_leaves"]}


def run_nuts(logprob_fn: Callable, q0: torch.Tensor, seed: int = 0, *,
             num_warmup: int = 500, num_samples: int = 500,
             max_depth: int = 8, target_accept: float = 0.8,
             pool_eps: bool = False):
    """Full NUTS run of the chains q0 [C, D]: two-window adaptation
    (dual-averaging restarts at the window boundaries; ε initialized by the
    Hoffman-Gelman doubling search, its geometric mean over the chains when
    ``pool_eps``).  PyTorch needs no bounded programs, so this is
    :func:`run_nuts_segmented` with one segment per phase, and returns
    what it returns."""
    return run_nuts_segmented(
        logprob_fn, q0, seed, num_warmup=num_warmup, num_samples=num_samples,
        max_depth=max_depth, target_accept=target_accept,
        segment_len=max(num_warmup, num_samples, 1), pool_eps=pool_eps)


def run_nuts_pytree(logprob_fn: Callable, init_params: dict, seed: int = 0,
                    **kw):
    """Dict-of-tensors adapter around :func:`run_nuts` (see
    :func:`~edrgp_tpu_torch.inference.hmc.run_hmc_pytree`)."""
    flat0, unravel = ravel_chains(init_params)
    qs, info = run_nuts(lambda q: logprob_fn(unravel(q)), flat0, seed, **kw)
    C, S = qs.shape[:2]
    flat = torch.as_tensor(qs, device=flat0.device).reshape(C * S, -1)
    return {k: v.reshape(C, S, *v.shape[1:])
            for k, v in unravel(flat).items()}, info


def _chunks(total: int, seg: int):
    out = [seg] * (total // seg)
    if total % seg:
        out.append(total % seg)
    return out


def run_nuts_segmented(logprob_fn: Callable, q0: torch.Tensor, seed: int = 0,
                       *, num_warmup: int = 500, num_samples: int = 500,
                       max_depth: int = 8, target_accept: float = 0.8,
                       segment_len: int = 32, pool_eps: bool = False,
                       inv_mass0=None, chain_chunk: int | None = None,
                       reuse_adaptation: tuple | None = None,
                       on_segment: Callable | None = None,
                       pool_group=None):
    """Multi-chain NUTS from the chain starts q0 [C, D], in segments.

    The JAX package segments the run into bounded device programs; here
    ``segment_len`` transitions run between host syncs, each followed by
    ``on_segment(phase, done, total)`` (a progress hook), and the
    signatures stay.  ``pool_eps=True`` pools the dual-averaging
    acceptance statistic across chains (one shared ε).  ``inv_mass0`` ([D])
    seeds the diagonal inverse mass for the first warmup window (see
    :func:`~edrgp_tpu_torch.inference.hmc.curvature_inv_mass`); the Welford
    estimate replaces it at the window boundary as usual.
    ``chain_chunk`` caps how many chains one batched ``logprob_fn`` call
    holds: groups of ``chain_chunk`` chains advance in turn at every
    transition, and pooled ε pools within each group; with
    ``chain_chunk ≥ C`` the run is the unchunked one, bit for bit.
    ``pool_group`` (a ``torch.distributed`` process group whose ranks each
    run this function on as many chains) pools ε over every rank's chains
    too (:func:`~edrgp_tpu_torch.inference.hmc.pooled_mean`): the JAX
    package's ``axis_name``.  Every rank then runs the same transitions in
    the same order.
    ``reuse_adaptation=(eps, inv_mass)`` samples with a tuned kernel from
    an earlier run on the same target and skips warmup.  Returns (samples
    [C, num_samples, D] numpy, info) with the accept rate, divergences,
    per-chain step sizes, mean leapfrogs, the [S, C] per-transition
    per-chain ``leapfrogs_per_transition`` (leaf counts: a transition of
    the batch costs its maximum over chains) and the inverse masses.
    """
    C, D = q0.shape
    chunk = int(chain_chunk) if chain_chunk and chain_chunk < C else C
    if C % chunk:
        raise ValueError(f"chains ({C}) must divide by chain_chunk "
                         f"({chunk})")
    groups = [slice(g, g + chunk) for g in range(0, C, chunk)]
    dt, dev = q0.dtype, q0.device
    gen = make_generator(seed, dev)
    states = [init_state(logprob_fn, q0[g]) for g in groups]

    if reuse_adaptation is not None:
        # Adaptation transfer: chains are exchangeable, so warmup is paid
        # once and amortized across later chain groups (quality is checked
        # downstream by split-R̂/ESS over all chains).
        eps_in, im_in = reuse_adaptation
        eps = torch.as_tensor(np.asarray(eps_in).reshape(-1)[:1], dtype=dt,
                              device=dev).expand(C)
        inv_mass = torch.as_tensor(np.asarray(im_in), dtype=dt,
                                   device=dev).expand(C, D)
    else:
        im = (None if inv_mass0 is None
              else torch.as_tensor(np.asarray(inv_mass0), dtype=dt,
                                   device=dev))
        eps0 = torch.cat([find_reasonable_epsilon(logprob_fn, s, gen,
                                                  inv_mass=im)
                          for s in states])
        if pool_eps:
            eps0 = torch.exp(pooled_mean(torch.log(eps0),
                                         pool_group)).expand(C)
        adapts = [window_adaptation_init(q0[g], eps0[g], inv_mass0=im)
                  for g in groups]
        half = num_warmup // 2
        for phase, length in (("warmup1", half),
                              ("warmup2", num_warmup - half)):
            done = 0
            for seg in _chunks(length, segment_len):
                for _ in range(seg):
                    for i in range(len(groups)):
                        a = adapts[i]
                        states[i], info = nuts_step(
                            logprob_fn, states[i], gen, torch.exp(a.log_eps),
                            a.inv_mass, max_depth)
                        adapts[i] = window_adaptation_update(
                            a, states[i].q, info["accept_stat"],
                            target_accept, pool_eps, pool_group)
                states[0].q[:1].cpu()       # wait for the card
                done += seg
                if on_segment is not None:
                    on_segment(phase, done, length)
            adapts = [_finalize_mass(a) for a in adapts]
        eps = torch.cat([torch.exp(a.log_eps_avg) for a in adapts])
        inv_mass = torch.cat([a.inv_mass for a in adapts])

    qs, accs, divs, leaves = [], [], [], []
    done = 0
    for seg in _chunks(num_samples, segment_len):
        seg_out = []
        for _ in range(seg):
            outs = []
            for i, g in enumerate(groups):
                states[i], info = nuts_step(logprob_fn, states[i], gen,
                                            eps[g], inv_mass[g], max_depth)
                outs.append((states[i].q, info["accept_stat"],
                             info["diverged"], info["n_leaves"]))
            seg_out.append([torch.cat(t) for t in zip(*outs)])
        # [seg, C, ...] → host once a segment
        for store, t in zip((qs, accs, divs, leaves), zip(*seg_out)):
            store.append(torch.stack(t).cpu().numpy())
        done += seg
        if on_segment is not None:
            on_segment("sample", done, num_samples)

    qs = np.concatenate(qs, axis=0).swapaxes(0, 1)     # [C, S, D]
    accs, divs = np.concatenate(accs), np.concatenate(divs)
    leaves = np.concatenate(leaves)
    return qs, {"accept_rate": float(accs.mean()),
                "divergences": int(divs.sum()),
                "step_size": eps.cpu().numpy(),
                "mean_leapfrogs": float(leaves.mean()),
                "leapfrogs_per_transition": leaves,
                "inv_mass": inv_mass.cpu().numpy()}

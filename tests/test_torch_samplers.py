"""The port's samplers (edrgp_tpu_torch.inference.hmc, .nuts, .smc), its
chain-batched NLML (ops.exact.nlml_chains) and its MCMC diagnostics
(edrgp_tpu_torch.metrics) against the JAX package, float64 on the CPU.

The deterministic parts are held to the JAX functions on the same numpy
inputs (1e-10 unless a test says otherwise); the JAX package runs one chain
per function, so its side is ``vmap``ped where the port takes a batch.  The
two packages cannot draw the same random numbers, so sampled outputs are
held to the JAX test file's own bars (``tests/test_samplers.py``) on its
correlated Gaussian.  The runs are shorter than there, since a batch of
chains gives the same number of draws at a fraction of the transitions;
each shortened run says what Monte-Carlo error it leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from scipy.stats import multivariate_normal

from torch_ranks import one_torch_thread  # noqa: F401 (autouse)
from edrgp_tpu import metrics as jmetrics
from edrgp_tpu.inference import hmc as jhmc
from edrgp_tpu.inference import nuts as jnuts
from edrgp_tpu.inference import smc as jsmc
from edrgp_tpu.ops import exact as jexact
from edrgp_tpu.ops import kernels as jkernels
from edrgp_tpu_torch import metrics
from edrgp_tpu_torch.convert import (params_from_jax, samples_from_jax,
                                     theta_from_jax, theta_to_jax)
from edrgp_tpu_torch.inference import hmc, nuts, smc
from edrgp_tpu_torch.ops import exact, linalg
from edrgp_tpu_torch.ops import kernels as tkernels

F64 = torch.float64
A = np.array([[2.0, 0.5], [0.5, 1.0]])
SIGMA = A @ A.T
PREC = np.linalg.inv(SIGMA)
MU = np.array([1.0, -2.0])
PREC_T, MU_T = torch.tensor(PREC), torch.tensor(MU)


def gauss_logprob(q):
    """The JAX test file's correlated Gaussian, batch-first: [C, 2] → [C]."""
    d = q - MU_T
    return -0.5 * ((d @ PREC_T) * d).sum(-1)


def logprior25(q):
    return -0.5 * (q * q).sum(-1) / 25.0


def _true_logZ():
    return np.log((2 * np.pi) * np.sqrt(np.linalg.det(SIGMA))
                  * multivariate_normal.pdf(MU, mean=np.zeros(2),
                                            cov=SIGMA + 25 * np.eye(2)))


def _close(got, want, rtol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1.0))


# ---------------------------------------------------------------------------
# A small exact-GP log-posterior in both packages (N = 40, Q = 2)
# ---------------------------------------------------------------------------

def _gp_target(n=40, q=2, kernel="RBF"):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, q))
    y = np.sin(X[:, 0]) + 0.1 * rng.normal(size=n)
    jk = getattr(jkernels, kernel)(q, ARD=True)
    p0 = {"kernel": jk.init_params(jnp.float64),
          "raw_noise": jnp.asarray(-2.0)}
    flat0, unravel = ravel_pytree(p0)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)

    def jlogprob(qf):
        return (-jexact.nlml(jk, unravel(qf), Xj, yj)
                - 0.5 * jnp.sum(qf ** 2) / 9.0)

    tk = getattr(tkernels, kernel)(q, ARD=True)
    Xt, yt = torch.tensor(X), torch.tensor(y)

    def tlogprob(qf):
        return (-exact.nlml_chains(tk, qf, Xt, yt)
                - 0.5 * (qf * qf).sum(-1) / 9.0)

    return jk, tk, unravel, np.asarray(flat0), jlogprob, tlogprob, (X, y)


def test_tz_matches_jax():
    ns = np.arange(1, 1025, dtype=np.int32)
    want = np.asarray(jax.vmap(jnuts._tz)(jnp.asarray(ns)))
    assert [nuts._tz(int(n)) for n in ns] == want.tolist()


def test_is_turning_matches_jax():
    rng = np.random.default_rng(1)
    im, pl, pr, rho = (rng.normal(size=(200, 3)) for _ in range(4))
    im = np.abs(im)
    want = jax.vmap(jnuts._is_turning)(*(jnp.asarray(a)
                                         for a in (im, pl, pr, rho)))
    got = nuts._is_turning(*(torch.tensor(a) for a in (im, pl, pr, rho)))
    assert got.tolist() == np.asarray(want).tolist()
    assert 0 < int(got.sum()) < 200


@pytest.mark.parametrize("pool", [False, True])
def test_window_adaptation_matches_jax(pool):
    """Dual averaging + Welford over a fixed sequence of (q, accept), then
    the window restart, for 3 chains; pooled, the JAX side pools with
    ``pmean`` over the vmapped axis."""
    rng = np.random.default_rng(2)
    C, D, T = 3, 4, 25
    qs = rng.normal(size=(T, C, D))
    accs = rng.uniform(size=(T, C))
    eps0 = np.array([0.3, 0.1, 0.7])
    axis = "c" if pool else None
    ja = jax.vmap(jhmc.window_adaptation_init)(jnp.asarray(qs[0]),
                                               jnp.asarray(eps0))
    upd = jax.vmap(lambda a, q, acc: jhmc.window_adaptation_update(
        a, q, acc, 0.8, axis), axis_name="c")
    ta = hmc.window_adaptation_init(torch.tensor(qs[0]), torch.tensor(eps0))
    for t in range(T):
        ja = upd(ja, jnp.asarray(qs[t]), jnp.asarray(accs[t]))
        ta = hmc.window_adaptation_update(ta, torch.tensor(qs[t]),
                                          torch.tensor(accs[t]), 0.8, pool)
    for j, t in zip(ja, ta):
        _close(t, j)
    for j, t in zip(jax.vmap(jhmc._finalize_mass)(ja),
                    hmc._finalize_mass(ta)):
        _close(t, j)


def test_leapfrog_trajectory_matches_jax():
    """16 leapfrog steps of 3 chains on the GP log-posterior (the port's
    batch against the JAX package's vmapped chains); relative 1e-9, since
    16 steps carry each step's rounding forward."""
    _, _, _, flat0, jlogprob, tlogprob, _ = _gp_target()
    rng = np.random.default_rng(3)
    C, D = 3, flat0.shape[0]
    q = flat0 + 0.3 * rng.normal(size=(C, D))
    p = rng.normal(size=(C, D))
    eps = np.array([0.05, 0.02, 0.08])
    im = rng.uniform(0.5, 1.5, size=(C, D))
    g = np.stack([np.asarray(jax.grad(jlogprob)(jnp.asarray(qi)))
                  for qi in q])
    want = jax.vmap(lambda *a: jhmc._leapfrog(jlogprob, *a, 16))(
        *(jnp.asarray(a) for a in (q, p, g, eps, im)))
    got = hmc._leapfrog(tlogprob, *(torch.tensor(a) for a in (q, p, g, eps,
                                                              im)), 16)
    for w, t in zip(want, got):
        _close(t.transpose(0, 1), w, rtol=1e-9)


def test_curvature_inv_mass_matches_jax_hvp():
    """Central differences of the gradient (step ε^(1/3)·max(1, |q|) =
    6.1e-6 in float64) against ``jhmc.curvature_inv_mass``, the JAX
    package's exact forward-over-reverse diagonal, of the same
    log-posterior written in plain JAX autodiff (slogdet and solve):
    1e-6 relative, the O(h²) truncation being ~1e-10 here.  Through the
    JAX package's own ``exact.nlml`` that diagonal is not the Hessian's,
    since forward mode over its custom VJP does not differentiate the
    factorization again (2.7 to 8.5 times the curvature at this point);
    both packages' gradients agree, and the port's difference quotient
    of its gradient is the plain Hessian's diagonal."""
    jk, _, unravel, flat0, jlogprob, tlogprob, (X, y) = _gp_target()
    n = X.shape[0]

    def plain_logprob(qf):
        p = unravel(qf)
        ls = jkernels.positive(p["kernel"]["lengthscale"])
        Xs = X / ls
        d2 = ((Xs[:, None, :] - Xs[None, :, :]) ** 2).sum(-1)
        K = (jkernels.positive(p["kernel"]["variance"]) * jnp.exp(-0.5 * d2)
             + jkernels.positive(p["raw_noise"]) * jnp.eye(n))
        logdet = jnp.linalg.slogdet(K)[1]
        nlml = 0.5 * (n * np.log(2 * np.pi) + logdet
                      + y @ jnp.linalg.solve(K, y))
        return -nlml - 0.5 * jnp.sum(qf ** 2) / 9.0

    q = flat0 + np.array([0.2, -0.1, 0.3, 0.1])
    _close(plain_logprob(jnp.asarray(q)), jlogprob(jnp.asarray(q)))
    want = jax.jit(lambda v: jhmc.curvature_inv_mass(plain_logprob, v))(
        jnp.asarray(q))
    got = hmc.curvature_inv_mass(tlogprob, torch.tensor(q))
    _close(got, want, rtol=1e-6)
    assert not np.allclose(np.asarray(want), 1.0)
    # the JAX package's own diagonal through exact.nlml (ROADMAP Queue 3)
    own = jax.jit(lambda v: jhmc.curvature_inv_mass(jlogprob, v))(
        jnp.asarray(q))
    assert np.all(np.asarray(want) / np.asarray(own) > 2.5)


def test_curvature_inv_mass_fallback_and_segmented_nuts():
    """The JAX test's Laplace-mass cases: exact −1/Hessian-diag on a
    Gaussian, unit mass where the curvature is flat, curvature 2 → 0.5;
    and the segmented runner on a badly scaled target (scales 10 and 0.1)
    mixes with shallow trees from the curvature mass."""
    im = hmc.curvature_inv_mass(gauss_logprob, MU_T)
    _close(im, 1.0 / np.diag(PREC), rtol=1e-5)
    flat = hmc.curvature_inv_mass(lambda q: q[:, 0] * 0.0 - q[:, 1] ** 2,
                                  torch.zeros(2, dtype=F64))
    _close(flat, [1.0, 0.5], rtol=1e-5)

    scales = torch.tensor([10.0, 0.1], dtype=F64)

    def scaled(q):
        return -0.5 * ((q / scales) ** 2).sum(-1)

    q0 = torch.zeros(4, 2, dtype=F64)
    q0[:, 0] += torch.tensor(np.random.default_rng(7).normal(size=4))
    im0 = hmc.curvature_inv_mass(scaled, torch.zeros(2, dtype=F64))
    # 4 chains × 300 samples: the relative sd error of the scale estimate
    # is ~1/√(2·ESS) ≈ 0.05 against the 0.25 bar
    qs, info = nuts.run_nuts_segmented(
        scaled, q0, 3, num_warmup=150, num_samples=300, max_depth=8,
        segment_len=50, inv_mass0=im0.numpy())
    assert info["mean_leapfrogs"] < 32.0
    np.testing.assert_allclose(qs.reshape(-1, 2).std(0), scales.numpy(),
                               rtol=0.25)


def test_smc_building_blocks_match_jax():
    """ess, systematic resampling given the JAX package's u₀, and the
    bisection for the next β on the same log-likelihoods."""
    rng = np.random.default_rng(4)
    log_w = rng.normal(size=300) * 3.0
    _close(smc.ess(torch.tensor(log_w)), jsmc.ess(jnp.asarray(log_w)))
    for i in range(5):
        key = jax.random.PRNGKey(i)
        u0 = float(jax.random.uniform(key, (), dtype=jnp.float64))
        want = jsmc.systematic_resample(key, jnp.asarray(log_w))
        got = smc.systematic_resample(u0, torch.tensor(log_w))
        assert got.tolist() == np.asarray(want).tolist()
    loglik = -np.abs(rng.normal(size=300)) * 50.0
    for beta in (0.0, 0.01, 0.3):
        want = jsmc._next_beta(jnp.asarray(loglik), jnp.asarray(beta), 150.0)
        got = smc._next_beta(torch.tensor(loglik), beta, 150.0)
        _close(got, want)
        assert 0.0 < float(got) <= 1.0
    assert float(smc._next_beta(torch.zeros(10, dtype=F64), 0.5, 5.0)) == 1.0


def test_mcmc_diagnostics_match_jax():
    rng = np.random.default_rng(5)
    chains = np.cumsum(rng.normal(size=(4, 200, 3)), axis=1) * 0.1 \
        + rng.normal(size=(4, 200, 3))
    _close(metrics.potential_scale_reduction(chains),
           jmetrics.potential_scale_reduction(chains))
    _close(metrics.effective_sample_size(chains),
           jmetrics.effective_sample_size(chains))
    _close(metrics.effective_sample_size(chains[0]),
           jmetrics.effective_sample_size(chains[0]))


@pytest.mark.parametrize("kernel", ["RBF", "Matern32"])
@pytest.mark.parametrize("C", [1, 3, 5])
def test_nlml_chains_matches_jax(C, kernel):
    """Value and θ-gradient of every chain against the JAX package's
    ``exact.nlml`` of that chain; the RBF goes through RBFKy's chain batch
    (the plain K and A on the CPU), the Matern32 through each chain's
    ``kernel.K``."""
    jk, tk, unravel, flat0, _, _, (X, y) = _gp_target(kernel=kernel)
    theta = flat0 + 0.4 * np.random.default_rng(C).normal(size=(C, 4))
    th = torch.tensor(theta, requires_grad=True)
    val = exact.nlml_chains(tk, th, torch.tensor(X), torch.tensor(y))
    (grad,) = torch.autograd.grad(val.sum(), th)
    f = jax.value_and_grad(lambda qf: jexact.nlml(jk, unravel(qf),
                                                  jnp.asarray(X),
                                                  jnp.asarray(y)))
    for c in range(C):
        v, g = f(jnp.asarray(theta[c]))
        _close(val[c].detach(), v)
        _close(grad[c], g)


@pytest.mark.parametrize("name", ["rbf_ard", "rbf_iso", "ratquad",
                                  "sum"])
def test_theta_layout_matches_ravel_pytree(name):
    """θ from a JAX pytree is ``ravel_pytree``'s vector, and back."""
    q = 3
    jk, tk = {
        "rbf_ard": (jkernels.RBF(q, ARD=True), tkernels.RBF(q, ARD=True)),
        "rbf_iso": (jkernels.RBF(q), tkernels.RBF(q)),
        "ratquad": (jkernels.RatQuad(q, ARD=True),
                    tkernels.RatQuad(q, ARD=True)),
        "sum": (jkernels.RBF(q, ARD=True) + jkernels.Linear(q),
                tkernels.RBF(q, ARD=True) + tkernels.Linear(q)),
    }[name]
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=np.shape(a)),
        {"kernel": jk.init_params(jnp.float64),
         "raw_noise": jnp.asarray(0.3)})
    flat, _ = ravel_pytree(params)
    theta = theta_from_jax(params, tk)
    np.testing.assert_array_equal(theta, np.asarray(flat))
    back = theta_to_jax(theta, tk)
    assert jax.tree_util.tree_structure(back) \
        == jax.tree_util.tree_structure(params)
    np.testing.assert_array_equal(ravel_pytree(back)[0], flat)
    # the flat vector of a port kernel holding these parameters
    tk.load_state_dict({k[len("kernel."):]: v for k, v in
                        params_from_jax(params).items()
                        if k.startswith("kernel.")})
    np.testing.assert_array_equal(
        exact.flatten_theta(tk, params["raw_noise"]).numpy(), flat)
    assert samples_from_jax(flat[None], tk).shape == (1, flat.shape[0])
    with pytest.raises(ValueError):
        samples_from_jax(flat[None, 1:], tk)


def test_batched_jitter_ladder_is_per_matrix():
    """Only the failed matrices escalate, each on its own mean diagonal;
    one that fails every rung is all NaN, and the others keep the bits of
    their single-matrix factorization."""
    rng = np.random.default_rng(8)
    B = rng.normal(size=(4, 6, 6))
    mats = torch.tensor(B @ B.transpose(0, 2, 1) + 6 * np.eye(6))
    mats[1] = -torch.eye(6, dtype=F64)                     # never factors
    v = torch.tensor(rng.normal(size=(6, 1)))
    mats[2] = 4.0 * (v @ v.T)                              # rank one
    jitter, L = linalg.jitter_ladder(mats)
    assert jitter[0] == 0 and jitter[3] == 0
    assert torch.isnan(jitter[1]) and torch.isnan(L[1]).all()
    assert 0 < float(jitter[2]) < 1e-4 * max(float(mats[2].diagonal()
                                                   .mean()), 1.0)
    for c in (0, 2, 3):
        j1, L1 = linalg.jitter_ladder(mats[c])
        assert torch.equal(L[c], L1) and float(jitter[c]) == j1


def test_nlml_chains_failed_chain_stays_in_its_lane():
    """A chain whose kernel matrix is not finite (σ² = inf) gives a
    non-finite NLML and gradient in its own entry only: every other chain
    keeps the bits it has in the same batch without the failure, and
    matches its own single-chain call (1e-12)."""
    _, tk, _, flat0, _, tlogprob, _ = _gp_target()
    theta = flat0 + 0.2 * np.random.default_rng(9).normal(size=(4, 4))
    good = torch.tensor(theta)
    bad = good.clone()
    bad[2, 2] = np.inf
    lp, g = hmc.value_and_grad(tlogprob, bad)
    lp0, g0 = hmc.value_and_grad(tlogprob, good)
    keep = [0, 1, 3]
    assert not torch.isfinite(lp[2])
    assert torch.equal(lp[keep], lp0[keep]) and torch.equal(g[keep],
                                                            g0[keep])
    for c in keep:
        lp1, g1 = hmc.value_and_grad(tlogprob, good[c:c + 1])
        _close(lp[c], lp1[0], rtol=1e-12)
        _close(g[c], g1[0], rtol=1e-12)


def test_nuts_counts_a_non_finite_chain_as_divergent():
    """A NaN energy ends that chain's tree as a divergence and leaves the
    chain where it was; the other chains move."""
    def target(q):
        lp = gauss_logprob(q)
        return torch.where(q[:, 0] > 50.0, torch.full_like(lp, float("nan")),
                           lp)

    q = torch.tensor([[1.0, -2.0], [49.9, -2.0], [0.0, 0.0]], dtype=F64)
    state = hmc.init_state(target, q)
    gen = hmc.make_generator(0, "cpu")
    im = torch.tensor([[1.0, 1.0], [1e4, 1.0], [1.0, 1.0]], dtype=F64)
    new, info = nuts.nuts_step(target, state, gen, 0.5, im, 6)
    assert torch.isfinite(new.logp).all()
    assert not bool((new.q[[0, 2]] == q[[0, 2]]).all())


def test_nuts_step_shapes():
    state = hmc.init_state(gauss_logprob, torch.zeros(3, 2, dtype=F64))
    new, info = nuts.nuts_step(gauss_logprob, state,
                               hmc.make_generator(0, "cpu"), 0.25,
                               torch.ones(2, dtype=F64), 6)
    assert new.q.shape == (3, 2) and torch.isfinite(new.logp).all()
    assert (info["n_leaves"] >= 1).all() and info["depth"].shape == (3,)


# ---------------------------------------------------------------------------
# Statistical tests: the JAX test file's bars on its correlated Gaussian
# ---------------------------------------------------------------------------

def _pooled(qs):
    return np.asarray(qs).reshape(-1, 2)


def test_hmc_moments():
    # 8 chains × 400 draws: 3,200 draws (the JAX test takes 3,000 of one)
    qs, info = hmc.run_hmc(gauss_logprob, torch.zeros(8, 2, dtype=F64), 0,
                           num_warmup=300, num_samples=400, n_leapfrog=16)
    assert int(info["divergences"].sum()) == 0
    assert 0.6 < float(info["accept_rate"].mean()) <= 1.0
    np.testing.assert_allclose(_pooled(qs).mean(0), MU, atol=0.15)
    np.testing.assert_allclose(np.cov(_pooled(qs).T), SIGMA, atol=0.6)


@pytest.fixture(scope="module")
def nuts_run():
    # 8 chains × 600 draws: the mean's Monte-Carlo sd is ~0.04 (ESS ~2,400
    # of sd ≤ 2.1), under a third of the 0.15 bar.  ε is pooled: eight
    # chains adapting alone put one chain's ε past the leapfrog's
    # stability limit now and then (in the JAX package's vmapped run_nuts
    # too), and its divergences break the bar of 0.
    return nuts.run_nuts(gauss_logprob, torch.zeros(8, 2, dtype=F64), 1,
                         num_warmup=300, num_samples=600, max_depth=8,
                         pool_eps=True)


def test_nuts_moments(nuts_run):
    qs, info = nuts_run
    assert qs.shape == (8, 600, 2)
    assert info["divergences"] == 0
    np.testing.assert_allclose(_pooled(qs).mean(0), MU, atol=0.15)
    np.testing.assert_allclose(np.cov(_pooled(qs).T), SIGMA, atol=0.6)


def test_nuts_adapts_trajectory_length(nuts_run):
    """On a wide target NUTS takes >1 leapfrog per step on average;
    divergent behaviour would show as depth-0 trees everywhere."""
    _, info = nuts_run
    assert info["mean_leapfrogs"] > 2.0
    assert info["leapfrogs_per_transition"].shape == (600, 8)


def test_nuts_segmented_pooled_eps():
    """pool_eps shares one dual-averaging ε across chains.  8 chains × 200
    draws (the JAX test: 3 × 200) put the mean's Monte-Carlo sd at ~0.07,
    under a third of the 0.25 bar."""
    q0 = torch.tensor([[0.5, -1.0]] * 8, dtype=F64)
    qs, info = nuts.run_nuts_segmented(gauss_logprob, q0, 8,
                                       num_warmup=200, num_samples=200,
                                       segment_len=50, pool_eps=True)
    eps = info["step_size"]
    assert eps.shape == (8,)
    np.testing.assert_allclose(eps, eps[0], rtol=1e-6)
    np.testing.assert_allclose(_pooled(qs).mean(0), MU, atol=0.25)


def test_chain_chunked_segmented_nuts():
    """chain_chunk ≥ C is the unchunked run bit for bit; smaller groups run
    in turn (pooled ε per group) and stay statistically sound; a chunk
    that does not divide C is refused."""
    q0 = torch.zeros(8, 2, dtype=F64)
    kw = dict(num_warmup=100, num_samples=100, max_depth=6, segment_len=25)
    full, _ = nuts.run_nuts_segmented(gauss_logprob, q0, 2, **kw)
    same, _ = nuts.run_nuts_segmented(gauss_logprob, q0, 2, chain_chunk=8,
                                      **kw)
    np.testing.assert_array_equal(same, full)
    # 8 chains × 100 draws: mean sd ~0.1 (ESS ~400), against 0.3
    qs, info = nuts.run_nuts_segmented(gauss_logprob, q0, 2, pool_eps=True,
                                       chain_chunk=4, **kw)
    np.testing.assert_allclose(_pooled(qs).mean(0), MU, atol=0.3)
    assert info["divergences"] == 0
    assert len(set(info["step_size"][:4])) == 1
    with pytest.raises(ValueError):
        nuts.run_nuts_segmented(gauss_logprob, q0, 2, chain_chunk=3, **kw)


def test_nuts_adaptation_reuse():
    """A second chain group sampling with the first group's tuned (ε,
    inverse mass) and no warmup gives sound moments."""
    q0 = torch.zeros(8, 2, dtype=F64)
    kw = dict(num_samples=200, max_depth=6, segment_len=25)
    _, info = nuts.run_nuts_segmented(gauss_logprob, q0, 2, num_warmup=200,
                                      pool_eps=True, **kw)
    reuse = (info["step_size"].ravel()[0], info["inv_mass"].mean(axis=0))
    qs2, info2 = nuts.run_nuts_segmented(gauss_logprob, q0 + 0.1, 9,
                                         num_warmup=0,
                                         reuse_adaptation=reuse, **kw)
    assert info2["divergences"] == 0
    np.testing.assert_allclose(_pooled(qs2).mean(0), MU, atol=0.3)


def test_smc_evidence_and_moments():
    parts0 = 5.0 * torch.tensor(np.random.default_rng(1).normal(
        size=(1000, 2)))
    parts, info = smc.run_smc(gauss_logprob, logprior25, parts0, 2,
                              num_mcmc=5, n_leapfrog=10, eps=0.3)
    assert info["converged"]
    assert abs(float(info["log_evidence"]) - _true_logZ()) < 0.3
    np.testing.assert_allclose(parts.mean(0).numpy(), MU, atol=0.3)
    assert info["beta_trace"].shape == (50,)
    assert float(info["beta_trace"][-1]) == -1.0


def test_smc_segmented_matches_monolithic_quality():
    parts0 = 5.0 * torch.tensor(np.random.default_rng(1).normal(
        size=(1000, 2)))
    parts, info = smc.run_smc_segmented(gauss_logprob, logprior25, parts0,
                                        2, num_mcmc=5, n_leapfrog=10,
                                        eps=0.3, particle_chunk=250)
    assert info["converged"] and info["beta_trace"][-1] >= 1.0
    assert len(info["ess_trace"]) == info["n_stages"]
    assert abs(info["log_evidence"] - _true_logZ()) < 0.3
    np.testing.assert_allclose(parts.mean(0).numpy(), MU, atol=0.3)
    with pytest.raises(ValueError):
        smc.run_smc_segmented(gauss_logprob, logprior25, parts0, 2,
                              particle_chunk=300)


def test_smc_adaptive_rejuvenation_survives_stiff_target():
    """A target 500× tighter than the prior: the adaptive kernel
    (ensemble-variance mass + acceptance-driven ε) keeps the ensemble
    diverse and lands the right posterior."""
    mu = torch.tensor([0.8, -0.5], dtype=F64)
    sig = 0.01

    def loglik(q):
        return -0.5 * ((q - mu) ** 2).sum(-1) / sig ** 2

    parts0 = 5.0 * torch.tensor(np.random.default_rng(4).normal(
        size=(512, 2)))
    parts, info = smc.run_smc_segmented(loglik, logprior25, parts0, 5,
                                        num_mcmc=3, n_leapfrog=10, eps=0.3,
                                        max_stages=60)
    assert info["converged"]
    assert min(info["unique_particles_after_resample"]) > 50
    assert info["accept_trace"][-1] > 0.2
    np.testing.assert_allclose(parts.mean(0).numpy(), mu.numpy(),
                               atol=5 * sig)
    post_std = parts.std(0, correction=0).numpy()
    assert np.all(post_std > 0.2 * sig) and np.all(post_std < 5 * sig)


def test_pytree_adapters():
    """The dict adapters give draws keyed like the starts."""
    def lp(p):
        return gauss_logprob(torch.cat([p["a"], p["b"]], 1))

    init = {"a": torch.zeros(4, 1, dtype=F64), "b": torch.zeros(4, 1,
                                                                 dtype=F64)}
    out, _ = nuts.run_nuts_pytree(lp, init, 0, num_warmup=50,
                                  num_samples=20)
    assert out["a"].shape == (4, 20, 1) and out["b"].shape == (4, 20, 1)
    out, _ = hmc.run_hmc_pytree(lp, init, 0, num_warmup=20, num_samples=10,
                                n_leapfrog=4)
    assert out["a"].shape == (4, 10, 1)
    parts, info = smc.run_smc_pytree(
        lp, lambda p: logprior25(torch.cat([p["a"], p["b"]], 1)),
        {"a": torch.randn(200, 1, dtype=F64), "b": torch.randn(200, 1,
                                                                dtype=F64)},
        0, num_mcmc=2, n_leapfrog=5, eps=0.3)
    assert parts["a"].shape == (200, 1) and info["converged"]


def test_metrics_logger_writes_jsonl(tmp_path):
    path = tmp_path / "m" / "log.jsonl"
    log = metrics.MetricsLogger(str(path))
    log.log(3, nlml=torch.tensor(1.5), accept=0.8)
    log.close()
    line = path.read_text().strip()
    assert '"step": 3' in line and '"nlml": 1.5' in line
    assert metrics.is_host0()

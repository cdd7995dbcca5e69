"""The port on an NVIDIA GPU: each CUDA kernel against its plain version,
the NLML gradient through the kernels against plain autograd, a small EDR
fit on the card against the CPU float64 fit, an SGPR model's gradients
through kernel G against a CPU float64 model, the SVGP ops, the stream feed,
G and K at the classifier EDR's shapes, the heteroscedastic NLML's per-row
noise through kernels K and A, each classifier against its CPU float64
model, and the samplers' chain batches: K and A over a leading chain axis,
a chain whose factorization fails, ``nlml_chains`` and the Bayesian
regressor's predictions against CPU float64; and, in a one-rank NCCL group,
the sharded NLML against the single-device one and the sharded gradient
extraction against the unsharded G.

Every test needs a card and skips without one.  The file imports no JAX, so
on the GPU machine (which has no JAX) it runs without the suite's
conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from edrgp_tpu_torch import EffectiveDimensionalityReduction, SVDTransformer
from edrgp_tpu_torch import config, discrepancy
from edrgp_tpu_torch.datasets import get_gaussian_inputs, get_tanh_targets
from edrgp_tpu_torch.models import GaussianProcessRegressor
from edrgp_tpu_torch.models.state import ExactGPModel
from edrgp_tpu_torch.ops import exact, linalg
from edrgp_tpu_torch.ops.cuda import rbf
from edrgp_tpu_torch.ops.kernels import RBF, positive


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 3, 4, 7, 9, 10, 13, 33, 64, 128])
def test_cuda_kernels_match_plain(card, Q):
    """Kernel vs plain version on the card; the plain versions use the
    matmul trick, the kernels the direct difference, hence tolerances
    relative to the largest entry: K 1e-5, G and A 1e-4.  Q = 1, 9 and 13
    run A padded to its next specialisation (3, 10, 16)."""
    g = torch.Generator().manual_seed(Q)
    M, N = 300, 517
    X1 = torch.randn(M, Q, generator=g).to(card)
    X2 = torch.randn(N, Q, generator=g).to(card)
    ls = (torch.rand(Q, generator=g) + 0.5).to(card) * Q ** 0.5
    alpha = torch.randn(N, generator=g).to(card)
    W = torch.randn(N, N, generator=g).to(card)
    W = W + W.T
    rbf.reset_launches()
    K = rbf.rbf_kernel_matrix(X1 / ls, X2 / ls, 1.3)
    G = rbf.rbf_grad_mu(X1, X2, alpha, ls, 1.3)
    P, r = rbf.rbf_nlml_adjoint(X2, W, ls, 1.3)
    torch.cuda.synchronize()
    assert all(v == 1 for v in rbf.LAUNCHES.values())
    assert _rel(K, rbf.rbf_kernel_matrix_plain(X1 / ls, X2 / ls, 1.3)) < 1e-5
    assert _rel(G, rbf.rbf_grad_mu_plain(X1, X2, alpha, ls, 1.3)) < 1e-4
    P0, r0 = rbf.rbf_nlml_adjoint_plain(X2, W, ls, 1.3)
    assert _rel(P, P0) < 1e-4 and _rel(r, r0) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [7, 9, 33])
@pytest.mark.parametrize("N", [1, 63, 65, 517, 4097, 4100])
def test_cuda_kernels_ragged_n(card, N, Q):
    """K, G and A at N that straddle the 64-wide tiles and the column splits
    (N=4,097 puts one column in the last split of A on a 132-SM card), in
    a narrow (Q=7), a padded (Q=9, run as 10) and the wide (Q=33)
    instantiation of the contraction.  N not a multiple of 4 takes the
    4-byte loads and stores; N=4,100 takes A's TMA loads, zero-filled past
    the edges of W and, at Q=9, past the last coordinate.  G runs
    M = N − N//3 test rows against the N training rows, by TMA at every
    N."""
    g = torch.Generator().manual_seed(N + Q)
    X = torch.randn(N, Q, generator=g).to(card)
    ls = (torch.rand(Q, generator=g) + 0.5).to(card) * Q ** 0.5
    W = torch.randn(N, N, generator=g).to(card)
    W = W + W.T
    alpha = torch.randn(N, generator=g).to(card)
    Xnew = torch.randn(N - N // 3, Q, generator=g).to(card)
    K = rbf.rbf_kernel_matrix(X[:N - N // 3] / ls, X / ls, 0.7)
    G = rbf.rbf_grad_mu(Xnew, X, alpha, ls, 0.7)
    P, r = rbf.rbf_nlml_adjoint(X, W, ls, 0.7)
    torch.cuda.synchronize()
    assert _rel(K, rbf.rbf_kernel_matrix_plain(X[:N - N // 3] / ls, X / ls,
                                               0.7)) < 1e-5
    assert _rel(G, rbf.rbf_grad_mu_plain(Xnew, X, alpha, ls, 0.7)) < 1e-4
    P0, r0 = rbf.rbf_nlml_adjoint_plain(X, W, ls, 0.7)
    assert _rel(P, P0) < 1e-4 and _rel(r, r0) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [7, 9, 33])
def test_cuda_grad_mu_without_training_rows(card, Q):
    """With N = 0 training rows the posterior mean is 0, and so is its
    gradient: G launches over an empty column range and returns zeros."""
    g = torch.Generator().manual_seed(Q)
    Xnew = torch.randn(130, Q, generator=g).to(card)
    X = torch.empty((0, Q), device=card)
    alpha = torch.empty((0,), device=card)
    rbf.reset_launches()
    G = rbf.rbf_grad_mu(Xnew, X, alpha, torch.ones(Q, device=card), 1.0)
    torch.cuda.synchronize()
    assert rbf.LAUNCHES["rbf_grad_mu"] == 1
    assert G.shape == (130, Q) and torch.equal(G, torch.zeros_like(G))


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,Q", [(20_000, 700, 10), (17_000, 300, 33),
                                   (100, 4000, 10), (64, 4097, 3)])
def test_cuda_grad_mu_rows_and_columns(card, M, N, Q):
    """G at M ≠ N: many test rows against few training rows take one
    column split, few test rows against many training rows take many;
    both match the plain version."""
    g = torch.Generator().manual_seed(M + N + Q)
    Xnew = torch.randn(M, Q, generator=g).to(card)
    X = torch.randn(N, Q, generator=g).to(card)
    alpha = torch.randn(N, generator=g).to(card)
    ls = (torch.rand(Q, generator=g) + 0.5).to(card) * Q ** 0.5
    splits, _ = rbf._gradmu_split(M, N, Q, torch.cuda.current_device())
    assert (splits == 1) == (M > N)
    G = rbf.rbf_grad_mu(Xnew, X, alpha, ls, 1.3)
    torch.cuda.synchronize()
    assert _rel(G, rbf.rbf_grad_mu_plain(Xnew, X, alpha, ls, 1.3)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [200, 302])
def test_cuda_grad_mu_wide_q(card, Q):
    """G has no W tiles beside x_j, so its wide instantiation reaches
    Q=302, as far as the kernel it replaced; Q=302 stages more than a TMA
    box holds and takes the cp.async loads."""
    g = torch.Generator().manual_seed(Q)
    Xnew = torch.randn(150, Q, generator=g).to(card)
    X = torch.randn(517, Q, generator=g).to(card)
    alpha = torch.randn(517, generator=g).to(card)
    ls = torch.full((Q,), Q ** 0.5, device=card)
    G = rbf.rbf_grad_mu(Xnew, X, alpha, ls, 1.0)
    torch.cuda.synchronize()
    assert _rel(G, rbf.rbf_grad_mu_plain(Xnew, X, alpha, ls, 1.0)) < 1e-4


@pytest.mark.cuda
def test_cuda_grad_mu_q_limit_raises(card):
    """One coordinate above G's limit (Q=303) the launch is refused with an
    error rather than computed another way, and the refusal leaves no
    error behind for the next launch."""
    g = torch.Generator().manual_seed(303)
    X = torch.randn(100, 303, generator=g).to(card)
    alpha = torch.randn(100, generator=g).to(card)
    ls = torch.full((303,), 303 ** 0.5, device=card)
    with pytest.raises(RuntimeError, match="rbf_grad_mu launch failed"):
        rbf.rbf_grad_mu(X, X, alpha, ls, 1.0)
    G = rbf.rbf_grad_mu(X[:, :10], X[:, :10], alpha, ls[:10], 1.0)
    torch.cuda.synchronize()
    assert _rel(G, rbf.rbf_grad_mu_plain(X[:, :10], X[:, :10], alpha,
                                         ls[:10], 1.0)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [3, 10, 33])
def test_cuda_grad_mu_far_from_origin(card, Q):
    """Inputs offset by +5 lengthscales in every coordinate: the form
    Σw·xs − xs*·Σw would cancel there, so G is held to 1e-4 of its largest
    entry against the plain version in float64 on the card."""
    g = torch.Generator().manual_seed(500 + Q)
    ls = (torch.rand(Q, generator=g) + 0.5).to(card) * Q ** 0.5
    Xnew = (torch.randn(1500, Q, generator=g).to(card) + 5.0) * ls
    X = (torch.randn(2500, Q, generator=g).to(card) + 5.0) * ls
    alpha = torch.randn(2500, generator=g).to(card)
    G = rbf.rbf_grad_mu(Xnew, X, alpha, ls, 1.3)
    G0 = rbf.rbf_grad_mu_plain(Xnew.double(), X.double(), alpha.double(),
                               ls.double(), 1.3)
    torch.cuda.synchronize()
    assert _rel(G.double(), G0) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [3, 10, 33])
def test_cuda_adjoint_any_w(card, Q):
    """A computes ((W∘K)·Xs, (W∘K)·1) for a W that is not symmetric: rows
    and columns are not interchangeable."""
    g = torch.Generator().manual_seed(100 + Q)
    N = 700
    X = torch.randn(N, Q, generator=g).to(card)
    ls = (torch.rand(Q, generator=g) + 0.5).to(card) * Q ** 0.5
    W = torch.randn(N, N, generator=g).to(card)
    W[:, : N // 2] *= 3.0
    P, r = rbf.rbf_nlml_adjoint(X, W, ls, 1.1)
    P0, r0 = rbf.rbf_nlml_adjoint_plain(X, W, ls, 1.1)
    Pt, rt = rbf.rbf_nlml_adjoint_plain(X, W.T.contiguous(), ls, 1.1)
    torch.cuda.synchronize()
    assert _rel(P, P0) < 1e-4 and _rel(r, r0) < 1e-4
    assert _rel(r, rt) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [4, 10, 33])
def test_cuda_kernels_are_deterministic(card, Q):
    """Two launches of K, two of G and two of A on the same inputs agree
    bit for bit: G and A add their column splits (eight for G's 2,000 test
    rows on a 132-SM card) in a fixed order, with no atomics."""
    g = torch.Generator().manual_seed(Q)
    N = 3000
    X = torch.randn(N, Q, generator=g).to(card)
    ls = (torch.rand(Q, generator=g) + 0.5).to(card) * Q ** 0.5
    W = torch.randn(N, N, generator=g).to(card)
    alpha = torch.randn(N, generator=g).to(card)
    Xnew = torch.randn(2000, Q, generator=g).to(card)
    K1 = rbf.rbf_kernel_matrix(X / ls, X / ls, 1.3)
    K2 = rbf.rbf_kernel_matrix(X / ls, X / ls, 1.3)
    G1, G2 = (rbf.rbf_grad_mu(Xnew, X, alpha, ls, 1.3) for _ in range(2))
    (P1, r1), (P2, r2) = (rbf.rbf_nlml_adjoint(X, W, ls, 1.3)
                          for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(K1, K2) and torch.equal(G1, G2)
    assert torch.equal(P1, P2) and torch.equal(r1, r2)


@pytest.mark.cuda
def test_cuda_adjoint_q_limit_raises(card):
    """A's wide instantiation stages all Q rows of its tiles: Q=170 still
    fits the card's shared memory, Q=200 is refused with an error rather
    than computed another way, and the refusal leaves no error behind for
    the next launch."""
    g = torch.Generator().manual_seed(170)
    X = torch.randn(200, 200, generator=g).to(card)
    W = torch.randn(200, 200, generator=g).to(card)
    ls = torch.full((200,), 9.0, device=card)
    P, r = rbf.rbf_nlml_adjoint(X[:, :170], W, ls[:170], 1.0)
    P0, r0 = rbf.rbf_nlml_adjoint_plain(X[:, :170], W, ls[:170], 1.0)
    torch.cuda.synchronize()
    assert _rel(P, P0) < 1e-4 and _rel(r, r0) < 1e-4
    with pytest.raises(RuntimeError, match="rbf_nlml_adjoint launch failed"):
        rbf.rbf_nlml_adjoint(X, W, ls, 1.0)
    K = rbf.rbf_kernel_matrix(X / ls, X / ls, 1.0)
    torch.cuda.synchronize()
    assert _rel(K, rbf.rbf_kernel_matrix_plain(X / ls, X / ls, 1.0)) < 1e-5


@pytest.mark.cuda
def test_cuda_wrappers_refuse_float64(card):
    X = torch.zeros((4, 2), dtype=torch.float64, device=card)
    with pytest.raises(TypeError):
        rbf.rbf_kernel_matrix(X, X, 1.0)


@pytest.mark.cuda
def test_cuda_nlml_gradient_matches_plain_backward(card):
    rng = np.random.default_rng(0)
    N, Q = 700, 4
    X = rng.normal(size=(N, Q))
    y = np.sin(X @ rng.normal(size=Q)) + 0.1 * rng.normal(size=N)
    m = ExactGPModel(X, y, RBF(Q, ARD=True), device=card)
    out = []
    for Ky in (exact._Ky, exact._Ky_generic):
        m.zero_grad()
        rbf.reset_launches()
        logdet, quad = linalg.logdet_and_quad(Ky(m, m._X), m._y)
        (0.5 * (N * math.log(2 * math.pi) + logdet + quad)).backward()
        out.append(([p.grad.clone() for p in m.parameters()],
                    dict(rbf.LAUNCHES)))
    assert out[0][1]["rbf_kernel_matrix"] == 1
    assert out[0][1]["rbf_nlml_adjoint"] == 1
    assert sum(out[1][1].values()) == 0
    for a, b in zip(out[0][0], out[1][0]):
        assert _rel(a, b) < 1e-3


@pytest.mark.cuda
def test_cuda_edr_fit_matches_cpu(card):
    rng = np.random.default_rng(5)
    X = get_gaussian_inputs(eig_values=[1, 0.3], sample_size=300,
                            eig_vectors=np.array([[1, 1], [-1, 1]]), rng=rng)
    y = get_tanh_targets(X, [0.5, 0.5], rng=rng)
    comps = []
    for device in ("cpu", card):
        rbf.reset_launches()
        edr = EffectiveDimensionalityReduction(
            GaussianProcessRegressor(device=device), SVDTransformer(),
            n_components=1).fit(X, y)
        comps.append(edr.components_.T)
    assert all(v >= 1 for v in rbf.LAUNCHES.values())
    assert discrepancy(comps[0] / np.linalg.norm(comps[0]), comps[1]) < 1e-2


@pytest.mark.cuda
def test_cuda_device_resolution_refuses_tf32(card):
    assert config.resolve_device("cuda").type == "cuda"
    assert config.default_dtype(card) == torch.float32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            config.resolve_device("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_cuda_sgpr_gradients_match_cpu_float64(card):
    """An SGPR fit at N=2,000, M=64 on the card: its predictive gradients
    go through kernel G and match a float64 CPU model at the same
    parameters to 1e-4 of the largest entry.  The fit starts from ℓ = 2:
    from the default ℓ = 1 on [−3, 3]⁸ it ends at the noise-only optimum,
    where the gradients hold no kernel signal."""
    from edrgp_tpu_torch.models.state import SGPRModel
    rng = np.random.default_rng(1)
    N, M, Q = 2000, 64, 8
    X = rng.uniform(-3, 3, size=(N, Q)).astype(np.float32)
    f = np.sin(X[:, 0]) * np.cos(X[:, 1]) + 0.5 * np.tanh(X[:, 2])
    y = (f + 0.1 * rng.normal(size=N)).astype(np.float32)
    m = SGPRModel(X, y, RBF(Q, ARD=True, lengthscale=2.0), num_inducing=M,
                  device=card)
    m.optimize(max_iters=100, num_restarts=1)
    assert m.get_hyperparameters()["['kernel']['variance']"] > 0.1
    cpu = SGPRModel(X, y, RBF(Q, ARD=True), num_inducing=M, device="cpu")
    cpu.load_state_dict(m.state_dict())
    rbf.reset_launches()
    dmu = m.predictive_gradients(X)[0]
    assert rbf.LAUNCHES["rbf_grad_mu"] == 1
    want = cpu.predictive_gradients(X)[0]
    assert np.abs(dmu - want).max() < 1e-4 * np.abs(want).max()
    m.predict(X[:100])
    assert rbf.LAUNCHES["rbf_kernel_matrix"] == 1


def _svgp_problem(N, Q, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, size=(N, Q)).astype(np.float32)
    f = np.sin(X[:, 0]) * np.cos(X[:, 1]) + 0.5 * np.tanh(X[:, 2])
    return X, (f + 0.1 * rng.normal(size=N)).astype(np.float32)


@pytest.mark.cuda
def test_cuda_svgp_matches_cpu_float64(card):
    """SVGP at N=1,024, M=32, Q=8 from ℓ = 2: the card (float32) against a
    CPU float64 model holding the same parameters, q(u) (one full
    natural-gradient step on the minibatch) and 256-row minibatch.  The
    ELBO to 1e-4 relative, each gradient and θ₁, θ₂ after a step with
    ρ = 0.5 to 1e-3 of their largest entries, predict and dμ/dx* (through
    kernels K and G) to 1e-4."""
    from edrgp_tpu_torch.models.svgp import SVGPModel
    from edrgp_tpu_torch.ops import svgp
    N, Q = 1024, 8
    X, y = _svgp_problem(N, Q, 2)
    idx = np.sort(np.random.default_rng(3).choice(N, 256, replace=False))
    models = [SVGPModel(X, y, RBF(Q, ARD=True, lengthscale=2.0),
                        num_inducing=32, noise_var=0.1, device=dev,
                        dtype=dt)
              for dev, dt in ((card, torch.float32), ("cpu", torch.float64))]
    models[1].load_state_dict(models[0].state_dict())
    cpu = models[1]
    q = svgp.natural_gradient_update(cpu, cpu.qstate, cpu._X[idx],
                                     cpu._y[idx], N, 1.0)
    models[0].qstate = svgp.SVGPState(*(t.float().to(card) for t in q))
    cpu.qstate = svgp.SVGPState(*(t.cpu().double()
                                  for t in models[0].qstate))
    out = []
    for gp in models:
        m, S = svgp.q_from_natural(gp.qstate)
        elbo = svgp.svgp_elbo(gp, m, S, gp._X[idx], gp._y[idx], N)
        elbo.backward()
        step = svgp.natural_gradient_update(gp, gp.qstate, gp._X[idx],
                                            gp._y[idx], N, 0.5)
        rbf.reset_launches()
        out.append((elbo.item(),
                    [p.grad.cpu().double() for p in gp.parameters()],
                    [t.cpu().double() for t in step],
                    [torch.from_numpy(a).double()
                     for a in (*gp.predict(X[:300]),
                               gp.predictive_gradients(X[:300])[0])],
                    dict(rbf.LAUNCHES)))
    (e, grads, theta, pred, launches), (e0, grads0, theta0, pred0, _) = out
    assert abs(e - e0) < 1e-4 * abs(e0)
    for a, b in zip(grads + theta, grads0 + theta0):
        assert _rel(a, b) < 1e-3
    for a, b in zip(pred, pred0):
        assert _rel(a, b) < 1e-4
    assert launches["rbf_kernel_matrix"] == 1
    assert launches["rbf_grad_mu"] == 1


class _SynchronousFeed:
    """Each chunk to the card in one synchronous copy from pageable memory."""

    def __init__(self, device, dtype):
        self.device, self.dtype = device, dtype

    def put(self, Xc, yc):
        return (torch.as_tensor(Xc, dtype=self.dtype, device=self.device),
                torch.as_tensor(yc, dtype=self.dtype, device=self.device))


@pytest.mark.cuda
def test_cuda_stream_feed_is_the_synchronous_feed(card, monkeypatch):
    """optimize_stream's pinned, double-buffered chunks give the same bits
    as the same 40 steps fed one synchronous copy at a time: a refill of a
    buffer whose copy were still in flight would change a batch."""
    from edrgp_tpu_torch.models import svgp as svgp_models
    from edrgp_tpu_torch.models.svgp import SVGPModel
    X, y = _svgp_problem(4096, 4, 5)
    rng = np.random.default_rng(6)
    batches = [(X[i], y[i]) for i in (rng.integers(0, 4096, 512)
                                      for _ in range(40))]
    states = []
    for feed in (None, _SynchronousFeed):
        if feed is not None:
            monkeypatch.setattr(svgp_models, "_ChunkFeed", feed)
        m = SVGPModel(X, y, RBF(4, ARD=True), num_inducing=64, device=card)
        m.optimize_stream(iter(batches), n_total=4096, steps=40, lr=1e-2,
                          scan_chunk=3)
        states.append([t.clone() for t in (*m.state_dict().values(),
                                           *m.qstate)])
    assert all(torch.equal(a, b) for a, b in zip(*states))


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [7, 4, 3])
def test_cuda_grad_mu_svgp_capstone_shape(card, Q):
    """G at the capstone's 1,048,576 rows by 512 inducing inputs, at the Q
    of each EDR fit after the first (Q=10 is in chip_smoke.py's kernels
    phase), against its plain version to 1e-4 of the largest entry."""
    g = torch.Generator(device=card).manual_seed(Q)
    Xn = torch.randn(1 << 20, Q, generator=g, device=card)
    Z = torch.randn(512, Q, generator=g, device=card)
    w = torch.randn(512, generator=g, device=card)
    ls = torch.full((Q,), Q ** 0.5, device=card)
    rbf.reset_launches()
    G = rbf.rbf_grad_mu(Xn, Z, w, ls, 1.3)
    assert rbf.LAUNCHES["rbf_grad_mu"] == 1
    assert _rel(G, rbf.rbf_grad_mu_plain(Xn, Z, w, ls, 1.3)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [10, 7, 4, 3])
def test_cuda_grad_mu_ep_classifier_shape(card, Q):
    """G and K at the EP classifier EDR's 4,096 training rows, at the Q of
    each of its fits, against their plain versions (G 1e-4, K 1e-5 of the
    largest entry)."""
    g = torch.Generator(device=card).manual_seed(Q)
    X = torch.rand(4096, Q, generator=g, device=card) * 2 - 1
    w = torch.randn(4096, generator=g, device=card)
    ls = torch.full((Q,), 0.5 * Q ** 0.5, device=card)
    rbf.reset_launches()
    G = rbf.rbf_grad_mu(X, X, w, ls, 1.3)
    K = rbf.rbf_kernel_matrix(X / ls, X / ls, 1.3)
    assert rbf.LAUNCHES["rbf_grad_mu"] == rbf.LAUNCHES["rbf_kernel_matrix"] == 1
    assert _rel(G, rbf.rbf_grad_mu_plain(X, X, w, ls, 1.3)) < 1e-4
    assert _rel(K, rbf.rbf_kernel_matrix_plain(X / ls, X / ls, 1.3)) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1000, 4097])
def test_cuda_rbfky_noise_vector_matches_plain_backward(card, N):
    """The heteroscedastic NLML through RBFKy with one noise per row (K
    forward, A backward, the noise's gradient off W's diagonal) against
    plain autograd through K + diag(noise) on the card, to 1e-3 of each
    gradient's largest entry."""
    from edrgp_tpu_torch.models.heteroscedastic import (
        HeteroscedasticGPModel, het_nlml)
    rng = np.random.default_rng(N)
    X = rng.normal(size=(N, 5))
    y = np.sin(X @ rng.normal(size=5)) + 0.1 * rng.normal(size=N)
    m = HeteroscedasticGPModel(X, y, RBF(5, ARD=True), device=card,
                               Y_metadata={"output_index": np.arange(N) % 7})
    with torch.no_grad():
        m.raw_noise.copy_(torch.linspace(-4.0, -1.0, 7))
    out = []
    for route in ("kernels", "plain"):
        m.zero_grad()
        rbf.reset_launches()
        if route == "kernels":
            loss = het_nlml(m, m._X, m._y, m._idx)
        else:
            noise = positive(m.raw_noise)[m._idx]
            Ky = m.kernel.K(m._X, m._X) + torch.diag(noise)
            logdet, quad = linalg.logdet_and_quad(Ky, m._y)
            loss = 0.5 * (N * math.log(2 * math.pi) + logdet + quad)
        loss.backward()
        out.append(([p.grad.clone() for p in m.parameters()],
                    dict(rbf.LAUNCHES), loss.item()))
    assert out[0][1]["rbf_kernel_matrix"] == 1
    assert out[0][1]["rbf_nlml_adjoint"] == 1
    assert sum(out[1][1].values()) == 0
    assert abs(out[0][2] - out[1][2]) < 1e-4 * abs(out[1][2])
    for a, b in zip(out[0][0], out[1][0]):
        assert _rel(a, b) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["VGPClassificationModel",
                                  "SparseVGPClassificationModel",
                                  "EPClassificationModel",
                                  "SparseEPClassificationModel"])
def test_cuda_classifier_matches_cpu_float64(card, name):
    """Each classifier on the card (float32) against the CPU float64 model
    at the same parameters: the bound or log Z_EP (1e-4 relative; EP 1e-3),
    P(y=1) and dμ/dx* through G (1e-4 of the largest entry).  ℓ = 0.3 keeps
    the full VI model's K(X, X) factorable without jitter in float32: at
    ℓ = 1 on these 400 rows in [−1, 1]⁴ the float32 ladder adds 1e-6 of
    jitter where float64 adds 1e-10, and the two bounds differ by that."""
    from edrgp_tpu_torch.models import cls_state
    rng = np.random.default_rng(3)
    X = rng.uniform(-1, 1, size=(400, 4))
    y = (np.sin(3 * X[:, 0]) + X[:, 1] + 0.3 * rng.normal(size=400) > 0)
    Xs = rng.uniform(-1, 1, size=(300, 4))
    kw = {"num_inducing": 32} if name.startswith("Sparse") else {}
    cls = getattr(cls_state, name)
    gpu = cls(X, y, RBF(4, ARD=True, lengthscale=0.3), device=card, **kw)
    with torch.no_grad():
        if hasattr(gpu, "m"):
            gpu.m.copy_(torch.as_tensor(0.5 * rng.normal(size=gpu.m.shape)))
    cpu = cls(X, y, RBF(4, ARD=True), device="cpu", **kw)
    cpu.load_state_dict(gpu.state_dict())
    rbf.reset_launches()
    dmu = gpu.predictive_gradients(Xs)[0]
    assert rbf.LAUNCHES["rbf_grad_mu"] == 1
    tol = 1e-3 if "EP" in name else 1e-4
    want = cpu.log_likelihood()
    assert abs(gpu.log_likelihood() - want) < tol * abs(want)
    for a, b in ((gpu.predict(Xs)[0], cpu.predict(Xs)[0]),
                 (dmu, cpu.predictive_gradients(Xs)[0])):
        assert np.abs(a - b).max() < 1e-4 * np.abs(b).max()


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3, 16])
@pytest.mark.parametrize("N", [517, 1023, 1024])
def test_cuda_chain_batched_kernels_match_plain(card, N, C):
    """K and A on a chain batch ([C, N, Q], ℓ and σ² one per chain, Q=4 as
    in the samplers' NLML) against their plain versions (K 1e-5, A 1e-4 of
    the largest entry), one launch per chain, and each chain's slice the
    bits of a single-chain call."""
    g = torch.Generator().manual_seed(N + C)
    Q = 4
    X = torch.randn(C, N, Q, generator=g).to(card)
    ls = (torch.rand(C, Q, generator=g) + 0.5).to(card) * Q ** 0.5
    s2 = (1.0 + torch.rand(C, generator=g)).to(card)
    W = torch.randn(C, N, N, generator=g).to(card)
    W = W + W.mT
    Xs = X / ls[:, None, :]
    rbf.reset_launches()
    K = rbf.rbf_kernel_matrix(Xs, Xs, s2)
    P, r = rbf.rbf_nlml_adjoint(X, W, ls, s2)
    torch.cuda.synchronize()
    assert rbf.LAUNCHES["rbf_kernel_matrix"] == C
    assert rbf.LAUNCHES["rbf_nlml_adjoint"] == C
    assert _rel(K, rbf.rbf_kernel_matrix_plain(Xs, Xs, s2)) < 1e-5
    P0, r0 = rbf.rbf_nlml_adjoint_plain(X, W, ls, s2)
    assert _rel(P, P0) < 1e-4 and _rel(r, r0) < 1e-4
    for c in range(C):
        assert torch.equal(K[c], rbf.rbf_kernel_matrix(Xs[c], Xs[c],
                                                       s2[c]))
        Pc, rc = rbf.rbf_nlml_adjoint(X[c], W[c], ls[c], s2[c])
        assert torch.equal(P[c], Pc) and torch.equal(r[c], rc)


def _chain_target(device, N=500, Q=4, C=16):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(N, Q))
    y = np.sin(1.3 * X[:, 0]) + 0.5 * np.cos(X[:, 1]) \
        + 0.15 * rng.normal(size=N)
    theta = np.array([0.5, 1.0, 3.0, 3.0, 0.0, -3.5]) \
        + 0.1 * rng.normal(size=(C, Q + 2))
    dt = config.default_dtype(device)
    return (torch.as_tensor(X, dtype=dt, device=device),
            torch.as_tensor(y, dtype=dt, device=device),
            torch.as_tensor(theta, dtype=dt, device=device))


@pytest.mark.cuda
def test_cuda_nlml_chains_matches_cpu_float64(card):
    """16 chains' NLML and θ-gradient on the card (K and A once per chain)
    against CPU float64: values 1e-4 relative, gradients 1e-3 of each
    parameter's largest entry."""
    out = []
    for device in (card, "cpu"):
        X, y, theta = _chain_target(device)
        theta.requires_grad_(True)
        rbf.reset_launches()
        v = exact.nlml_chains(RBF(4, ARD=True).to(X), theta, X, y)
        (g,) = torch.autograd.grad(v.sum(), theta)
        out.append((v.double().cpu(), g.double().cpu(), dict(rbf.LAUNCHES)))
    (v, g, launches), (v0, g0, _) = out
    assert launches["rbf_kernel_matrix"] == 16
    assert launches["rbf_nlml_adjoint"] == 16
    assert _rel(v, v0) < 1e-4
    for d in range(g0.shape[1]):
        assert _rel(g[:, d], g0[:, d]) < 1e-3


@pytest.mark.cuda
def test_cuda_failed_chain_stays_in_its_lane(card):
    """A chain at σ² = inf factors on no rung of the jitter ladder: its
    NLML and gradient are not finite, and every other chain keeps the
    bits it has in a batch without the failure."""
    from edrgp_tpu_torch.inference.hmc import value_and_grad
    X, y, theta = _chain_target(card)
    kernel = RBF(4, ARD=True).to(X)

    def f(q):
        return exact.nlml_chains(kernel, q, X, y)

    bad = theta.clone()
    bad[5, 4] = float("inf")
    v, g = value_and_grad(f, theta)
    vb, gb = value_and_grad(f, bad)
    keep = torch.arange(16, device=card) != 5
    assert not torch.isfinite(vb[5])
    assert torch.equal(vb[keep], v[keep]) and torch.equal(gb[keep], g[keep])


@pytest.mark.cuda
def test_cuda_bayesian_predictions_match_cpu_float64(card):
    """The Bayesian regressor at 8 fixed posterior samples on the card
    (K(X, X*) and G once per sample) against CPU float64: the mixture
    mean and variance and the averaged dμ/dx* to 1e-4 of their largest
    entries."""
    from edrgp_tpu_torch.models.bayesian import BayesianGPModel
    rng = np.random.default_rng(6)
    X = rng.normal(size=(300, 4))
    y = np.tanh(X[:, 0] - X[:, 1]) + 0.1 * rng.normal(size=300)
    Xs = rng.normal(size=(200, 4))
    samples = np.array([0.5, 0.5, 2.0, 2.0, 0.0, -4.0]) \
        + 0.2 * rng.normal(size=(8, 6))
    out = []
    for device in (card, "cpu"):
        m = BayesianGPModel(X, y, RBF(4, ARD=True), device=device)
        m.samples_ = torch.as_tensor(samples, dtype=m._X.dtype,
                                     device=m._X.device)
        m._cache = None
        rbf.reset_launches()
        mean, var = m.predict(Xs)
        k_launches = rbf.LAUNCHES["rbf_kernel_matrix"]
        dmu, sd = m.predictive_gradients(Xs)
        out.append((mean, var, dmu, sd, k_launches,
                    rbf.LAUNCHES["rbf_grad_mu"]))
    for a, b in zip(out[0][:4], out[1][:4]):
        assert np.abs(a - b).max() < 1e-4 * np.abs(b).max()
    assert out[0][4] >= 8 and out[0][5] == 8


@pytest.fixture(scope="module")
def nccl_group():
    """A one-rank NCCL group on the card, torn down after the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL runs on the card only")
    import torch.distributed as dist
    from edrgp_tpu_torch.parallel import initialize, make_mesh
    initialize(device="cuda")
    try:
        yield make_mesh(("data",))
    finally:
        dist.destroy_process_group()


def _sharded_problem(N, Q, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, Q))
    return X, np.sin(X @ rng.normal(size=Q)) + 0.1 * rng.normal(size=N)


@pytest.mark.cuda
def test_cuda_sharded_nlml_matches_single_device(nccl_group):
    """The sharded NLML on a one-rank NCCL group at N=2,048 (K for the slab,
    the closed-form slab backward, NCCL's collectives) against the
    single-device NLML on the card: value 1e-4 relative, each gradient 1e-3
    of its largest entry; one K launch an evaluation, the same bits
    twice."""
    from edrgp_tpu_torch.parallel import sharded_nlml_value_and_grad
    X, y = _sharded_problem(2048, 8)
    m = ExactGPModel(X, y, RBF(8, ARD=True), noise_var=0.1, device="cuda")
    rbf.reset_launches()
    value, grads = sharded_nlml_value_and_grad(m, nccl_group, m._X, m._y)
    assert rbf.LAUNCHES["rbf_kernel_matrix"] == 1
    again = sharded_nlml_value_and_grad(m, nccl_group, m._X, m._y)
    assert torch.equal(again[0], value)
    m.zero_grad()
    ref = exact.nlml(m, m._X, m._y)
    ref.backward()
    ref = float(ref.detach())
    assert abs(float(value) - ref) / abs(ref) < 1e-4
    for name, p in m.named_parameters():
        assert _rel(grads[name], p.grad) < 1e-3, name


@pytest.mark.cuda
def test_cuda_model_gradient_gram_is_the_unsharded_G(nccl_group):
    """``model_gradient_gram`` on one rank: G is the unsharded extraction's
    bit for bit (one G launch), the Gram GᵀG to 1e-4."""
    from edrgp_tpu_torch.parallel.edr_sharded import model_gradient_gram
    X, y = _sharded_problem(2048, 6, seed=1)
    m = ExactGPModel(X, y, RBF(6, ARD=True), noise_var=0.1, device="cuda")
    G1 = m.predictive_gradients(X)[0][:, :, 0]
    rbf.reset_launches()
    G, gram = model_gradient_gram(m, X, nccl_group)
    assert rbf.LAUNCHES["rbf_grad_mu"] == 1
    assert np.array_equal(G, G1)
    ref = G1.T @ G1
    assert np.abs(gram - ref).max() / np.abs(ref).max() < 1e-4

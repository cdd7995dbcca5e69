"""The float64 reference against a CPU float64 run of the program's own
objectives and posterior at a small size, and the frozen data recipe
against the program's generators."""

import numpy as np
import pytest
import torch

from harness.data import edr_problem, generator
from reference import exact_gp, gp


@pytest.fixture(scope="module")
def problem():
    X, y, B = edr_problem(generator(7, 1, 0), 120, 4, 3, 0.1)
    return X, y, B


def test_recipe_matches_the_programs_generators():
    from edrgp_tpu_torch.datasets import get_beta_inputs, get_edr_target
    X, y, B = edr_problem(generator(123, 1, 0), 50, 10, 3, 0.1)
    rng = generator(123, 1, 0)
    X2 = get_beta_inputs(50, 10, rng=rng)
    B2 = np.linalg.qr(rng.normal(size=(10, 3)))[0]
    y2 = get_edr_target(X2 @ B2, sigma=0.1, rng=rng)
    assert np.array_equal(X, X2) and np.array_equal(B, B2)
    assert np.array_equal(y, y2)


def test_large_and_negative_seeds_draw():
    a = edr_problem(generator(2 ** 31 + 5, 1, 0), 8, 3, 2, 0.1)[0]
    b = edr_problem(generator(-3, 1, 0), 8, 3, 2, 0.1)[0]
    assert a.shape == b.shape == (8, 3) and not np.array_equal(a, b)


def _model(X, y):
    from edrgp_tpu_torch.models.state import ExactGPModel
    from edrgp_tpu_torch.ops.kernels import RBF
    torch.manual_seed(0)
    model = ExactGPModel(X, y, RBF(X.shape[1], ARD=True), device="cpu")
    with torch.no_grad():      # away from the defaults, as a fit moves them
        for p in model.parameters():
            p.add_(0.3 * torch.randn(p.shape, dtype=p.dtype))
    return model


def _raw(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def test_objective_value_and_gradient(problem):
    X, y, _ = problem
    Xk, yk, _ = gp.fit_inputs(X, y, None)
    model = _model(Xk, y)
    loss = model._objective_fn()()
    loss.backward()
    p = gp.as_params(_raw(model), gp.FLOAT64, "cpu", grad=True)
    value, jitter = exact_gp.objective(p, torch.as_tensor(Xk),
                                       torch.as_tensor(yk))
    value.backward()
    assert jitter == 0.0
    assert float(value.detach()) == pytest.approx(float(loss.detach()),
                                                rel=1e-10, abs=1e-9)
    for name, q in model.named_parameters():
        np.testing.assert_allclose(p[name].grad.numpy(), q.grad.numpy(),
                                   rtol=1e-8, atol=1e-9)


def test_weights_mean_and_gradients(problem):
    X, y, _ = problem
    Xk, yk, std = gp.fit_inputs(X, y, None)
    model = _model(Xk, y)
    _, C, w = model._gradient_basis()
    raw = _raw(model)
    p = gp.as_params(raw, gp.FLOAT64, "cpu")
    Xt, yt = torch.as_tensor(Xk), torch.as_tensor(yk)
    w_r = exact_gp.coef(p, Xt, yt)
    np.testing.assert_allclose(w_r.numpy(), w.detach().numpy(),
                               rtol=1e-8, atol=1e-10)
    C_r = exact_gp.centres(p, Xt)
    G_prog = model.predictive_gradients(Xk)[0][:, :, 0]
    G_ref, T = gp.mean_grad(Xt, C_r, w_r, p, terms=True)
    np.testing.assert_allclose(G_ref.numpy() * std, G_prog, rtol=1e-8,
                               atol=1e-9)
    assert (T[:, 0] >= G_ref.abs().amax(1)).all()
    mu_prog = model.predict(Xk, include_likelihood=False)[0][:, 0]
    mu_ref = gp.mean(Xt, C_r, w_r, p).numpy() * std + np.mean(y)
    np.testing.assert_allclose(mu_ref, mu_prog, rtol=1e-8, atol=1e-9)


def test_jitter_rungs_follow_the_ladder():
    assert gp.rung_jitter(0, 5.0) == 0.0
    assert gp.rung_jitter(1, 5.0) == pytest.approx(5e-6)
    assert gp.rung_jitter(3, 0.5) == pytest.approx(1e-4)
    assert gp.rung_jitter(2, 2.0, torch.float64) == pytest.approx(2e-9)


def test_the_reference_decides_the_rung_itself():
    from edrgp_tpu_torch.config import BASE_JITTER_F32, BASE_JITTER_F64
    assert gp.JITTER0 == {torch.float32: BASE_JITTER_F32,
                          torch.float64: BASE_JITTER_F64}
    # A positive definite matrix factors at rung 0.  One with an eigenvalue
    # of −5e-5·(mean diagonal, 2) needs rung 3 in float32 (1e-4·2·2), and no
    # rung of float64's ladder reaches that far (its last adds 1e-5·2).
    rng = np.random.default_rng(3)
    Q = np.linalg.qr(rng.normal(size=(40, 40)))[0]
    eig = np.linspace(1.0, 3.0, 40)
    A = torch.as_tensor(Q @ np.diag(eig) @ Q.T)
    assert gp.first_rung(A, torch.float32) == 0
    eig[0] = -5e-5 * eig.mean()
    A = torch.as_tensor(Q @ np.diag(eig) @ Q.T)
    assert gp.first_rung(A, torch.float32) == 3
    assert gp.first_rung(A, torch.float64) is None
    assert gp.rungs_near(0) == [0, 1]
    assert gp.rungs_near(3) == [2, 3, 4]
    assert gp.rungs_near(6) == [5, 6]
    assert gp.rungs_near(None) == [1, 2, 3, 4, 5, 6]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 1.0 + 2.0 ** -11,
                      -3.0], dtype=torch.float32)
    r = gp.to_tf32(x)
    assert r.tolist() == [1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -10, -3.0]


def test_projector_gap():
    rng = np.random.default_rng(0)
    G = rng.normal(size=(50, 4)) * np.array([5.0, 3.0, 1.0, 0.01])
    _, _, Vh = np.linalg.svd(G, full_matrices=False)
    assert gp.projector_gap(G, None, Vh[:3], 2) == pytest.approx(0, abs=1e-12)
    assert gp.projector_gap(G, None, Vh[2:], 2) == pytest.approx(
        np.sqrt(2) / 2)

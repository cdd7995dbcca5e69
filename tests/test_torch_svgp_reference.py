"""The port's SVGP step against the benchmark's plain float64 reference of
Hensman et al. 2013 (``gpbench/reference/svgp.py``, loaded by file path),
and the step's counters and profiler labels.

At N = 2,048, M = 32, B = 256, Q = 8 on the CPU in float64, from random
parameters and a random q(u): the minibatch ELBO, the gradient of −ELBO in
every raw parameter, one natural-gradient update, the predictive mean and
variance, and dμ/dx* by kernel G's plain version and by the generic
autograd path of ``grad_rows``.
"""

import importlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from edrgp_tpu_torch.data import MMapDataset, write_dataset
from edrgp_tpu_torch.models import svgp as svgp_model
from edrgp_tpu_torch.models.svgp import SVGPModel
from edrgp_tpu_torch.ops import exact, linalg, svgp
from edrgp_tpu_torch.ops.kernels import RBF

REFERENCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "gpbench", "reference")
N, M, B, Q = 2048, 32, 256, 8


def _reference():
    """(svgp, gp) of the benchmark's reference package, by file path."""
    name = "gpbench_reference"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REFERENCE, "__init__.py"),
            submodule_search_locations=[REFERENCE])
        package = importlib.util.module_from_spec(spec)
        sys.modules[name] = package
        spec.loader.exec_module(package)
    return (importlib.import_module(name + ".svgp"),
            importlib.import_module(name + ".gp"))


def _data(n, rng):
    """BASELINE config 5's recipe: X on [−3, 3]^Q, f = sin x₀·cos x₁ +
    0.5·tanh x₂, noise 0.1."""
    X = rng.uniform(-3, 3, size=(n, Q))
    f = np.sin(X[:, 0]) * np.cos(X[:, 1]) + 0.5 * np.tanh(X[:, 2])
    return X, f + 0.1 * rng.normal(size=n), f


@pytest.fixture(scope="module", params=[0, 1, 2])
def case(request):
    """A model at random parameters and a random q(u), a batch and test
    rows, with the same point as the reference's tensors."""
    seed = request.param
    rng = np.random.default_rng(100 + seed)
    X, y, _ = _data(N, rng)
    model = SVGPModel(X, y, RBF(Q, ARD=True), num_inducing=M, seed=seed,
                      device="cpu")
    torch.manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.3 * torch.randn(p.shape, dtype=p.dtype))
        W = torch.randn(M, M, dtype=torch.float64)
        model.qstate = svgp.SVGPState(
            theta1=torch.randn(M, dtype=torch.float64),
            theta2=-0.5 * (W @ W.T / M + 0.5 * torch.eye(M,
                                                          dtype=torch.float64)))
    idx = np.sort(rng.choice(N, B, replace=False))
    ref, gp = _reference()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    Xs = rng.uniform(-3, 3, size=(300, Q))
    return dict(model=model, Xb=model._X[idx], yb=model._y[idx], ref=ref,
                gp=gp, params=params, Xs=Xs,
                theta=tuple(t.clone() for t in model.qstate))


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_elbo_and_its_gradient(case):
    model, ref = case["model"], case["ref"]
    model.zero_grad()
    m, S = svgp.q_from_natural(model.qstate)
    value = svgp.svgp_elbo(model, m, S, case["Xb"], case["yb"], N)
    (-value).backward()
    p = {n: t.clone().requires_grad_(True)
         for n, t in case["params"].items()}
    want = ref.elbo(p, *case["theta"], case["Xb"], case["yb"], N)
    (-want).backward()
    assert float(value.detach()) == pytest.approx(float(want.detach()),
                                                rel=1e-9, abs=1e-7)
    got = _grads(model)
    assert set(got) == set(p) == {"raw_noise", "Z", "kernel.variance",
                                  "kernel.lengthscale"}
    for name in p:
        np.testing.assert_allclose(got[name].numpy(), p[name].grad.numpy(),
                                   rtol=1e-7, atol=1e-8 * N)


def test_natural_gradient_update(case):
    model, ref = case["model"], case["ref"]
    rho = 0.37
    got = svgp.natural_gradient_update(model, svgp.SVGPState(*case["theta"]),
                                       case["Xb"], case["yb"], N, rho)
    want = ref.natural_step(case["params"], *case["theta"], case["Xb"],
                            case["yb"], N, rho)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-9 * scale)


def test_predictive_mean_and_variance(case):
    model, ref = case["model"], case["ref"]
    mean, var = model.predict(case["Xs"])
    mu, v = ref.predict(case["params"], *case["theta"],
                        torch.as_tensor(case["Xs"]))
    norm = model.normalizer
    np.testing.assert_allclose(mean[:, 0], mu.numpy() * norm.std + norm.mean,
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(var[:, 0], v.numpy() * norm.std ** 2,
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("path", ["kernel", "generic"])
def test_mean_gradient(case, path, monkeypatch):
    model, ref, gp = case["model"], case["ref"], case["gp"]
    if path == "generic":
        monkeypatch.setattr(exact, "_fused", lambda kernel, X: False)
    got = model.predictive_gradients(case["Xs"])[0][:, :, 0]
    Xs = torch.as_tensor(case["Xs"])
    beta = ref.beta(case["params"], *case["theta"])
    want, terms = gp.mean_grad(Xs, case["params"]["Z"], beta,
                               case["params"], terms=True)
    std = model.normalizer.std
    gap = np.abs(got - want.numpy() * std)
    assert (gap <= 1e-9 * terms.numpy() * std).all(), gap.max()


def test_stream_counts_steps_factors_and_labels(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    X, y, _ = _data(4096, rng)
    path = str(tmp_path / "stream.edrg")
    write_dataset(path, X, y)
    ds = MMapDataset(path)
    calls = {"cholesky_ex": 0, "cholesky": 0}

    def counted(name):
        orig = getattr(torch.linalg, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return orig(*args, **kwargs)

        return call

    try:
        model = SVGPModel.from_dataset(ds, RBF(Q, ARD=True), num_inducing=16,
                                       subsample=512, device="cpu")
        for name in calls:
            monkeypatch.setattr(torch.linalg, name, counted(name))
        steps, factors = (dict(svgp_model.STEPS), dict(linalg.FACTORS))
        model.optimize_stream(ds.batches(64, seed=3), n_total=ds.n_rows,
                              steps=32, lr=5e-3, scan_chunk=16)
        assert svgp_model.STEPS["taken"] - steps["taken"] == 32
        ladder = linalg.FACTORS["ladder"] - factors["ladder"]
        graph = linalg.FACTORS["graph"] - factors["graph"]
        # four ladders a step (q(u), Kuu in the ELBO, S in the KL, Kuu in
        # the natural gradient) and Kuu's factor again on the graph
        assert ladder == calls["cholesky_ex"] >= 4 * 32
        assert graph == calls["cholesky"] == 32
        monkeypatch.undo()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            model.optimize_stream(ds.batches(64, seed=4), n_total=ds.n_rows,
                                  steps=2, lr=5e-3, scan_chunk=2)
        names = {e.name for e in prof.events()}
        assert {"svgp.step", "svgp.loader", "svgp.feed"} <= names
        assert np.isfinite(model._objective)
    finally:
        ds.close()

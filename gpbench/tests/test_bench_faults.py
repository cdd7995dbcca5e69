"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (set-up, the window, the comparison against the committed limits) at
a CPU size, with one fault planted in the program: an L-BFGS step that
returns its state unchanged, the objective over half the rows (twice
their sum, the mean over the rest), the gradients of a fit altered where
the regressor produces them, and a jitter on every factor that the
reference's own factor does not need.  The same run without a fault is
correct.  (One card, so no exchange between chips can be left out.)
"""

import numpy as np
import pytest
import torch

from harness.cell import run_cell

from small import small


def _run(workload, seconds=3.0):
    m, cell, config = small(workload)
    return run_cell(m, cell, 20261018, seconds, False, device="cpu",
                    config=config, limits=m.limits(cell))


def _unchanged_step(opt, closure):
    with torch.enable_grad():
        return closure()


_unchanged_step.hooked = True


def _wrong_jitter(A, jitter0=None):
    """The ladder's factor, climbed from its fourth rung (1e-3 of the mean
    diagonal) where the ladder starts with no jitter at all."""
    A = A.detach()
    mean_diag = max(float(A.diagonal().mean()), 1.0)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    for rung in range(4, 8):
        jitter = 1e-6 * 10.0 ** (rung - 1) * mean_diag
        L, info = torch.linalg.cholesky_ex(A + jitter * eye)
        if int(info) == 0:
            return jitter, L
    return None, torch.full_like(A, float("nan"))


def _plant(monkeypatch, fault):
    import edrgp_tpu_torch.ops.exact as exact
    import edrgp_tpu_torch.ops.linalg as linalg
    from edrgp_tpu_torch.models.base import _BaseGP
    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.LBFGS, "step", _unchanged_step)
    elif fault == "half_batch":
        orig = exact.nlml

        def half(gp, X, y):
            h = X.shape[0] // 2
            return 2.0 * orig(gp, X[:h], y[:h])

        monkeypatch.setattr(exact, "nlml", half)
    elif fault == "wrong_jitter":
        monkeypatch.setattr(linalg, "jitter_ladder", _wrong_jitter)
    elif fault == "answer_altered":
        orig = _BaseGP.predict_gradient

        def altered(self, X):
            G = np.array(orig(self, X))
            G[0] += np.abs(G).max()
            return G

        monkeypatch.setattr(_BaseGP, "predict_gradient", altered)


@pytest.mark.parametrize("workload", ["exact_edr"])
def test_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and "grad" in out["checks"]


@pytest.mark.parametrize("workload,fault", [
    ("exact_edr", "state_unchanged"),
    ("exact_edr", "half_batch"),
    ("exact_edr", "answer_altered"),
    ("exact_edr", "wrong_jitter"),
])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    _plant(monkeypatch, fault)
    out = _run(workload)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1

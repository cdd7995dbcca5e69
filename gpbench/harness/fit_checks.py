"""The comparison that decides ``correct`` in a window of GP fits.

Once the window has closed, the plain float64 reference of the model the
configuration fits (``reference/<config["reference"]>.py``) recomputes,
from the generated data and the parameters the window recorded, what the
program answered:

- ``grad``: at a sample, drawn from the seed, of the iterates the L-BFGS
  steps started from, the objective's gradient in every optimised
  parameter, as a gap per training row: max |Δgradient| / N.  (The
  value's gap, |Δvalue| / N, is read beside it as ``value`` and not
  compared: at N = 8,192 the float32 NLML lies 15–70 nats off float64's,
  by the conditioning of Ky, and TF32's lies barely further.)
- ``start_value``: at a sample of the iterates each restart started from
  (the model's initial parameters and the restarts' perturbations of
  them, where Ky is well conditioned), the objective's value, as a gap
  per training row;
- ``mean``: for each fit that ended in the window, its posterior weights
  (the exact GP's α) judged by the posterior mean they give at the
  training rows, k(X, C)·w: max |Δ| over the reference's largest.  The
  weights themselves are as ill-determined as Ky is ill-conditioned:
  float32's α lies 0.1–0.2 of its largest entry off float64's, as TF32's
  does.
- ``dmu``: the gradients of the posterior mean the fit returned at the
  training rows, against the reference's from the same weights, each
  entry's gap over the magnitude of the sums it is made of
  (``reference.gp.mean_grad``: they cancel by orders of magnitude);
- ``span``: how far the projector the EDR took from those gradients misses
  the leading directions of the reference's gradients from the
  reference's weights (``reference.gp.projector_gap``);
- ``stationary``: the norm of the gradient the program returned at the
  fit's result over its norm where the restart that found the result
  started (a fit that never moves reads 1).

A float32 factor that fails takes a jitter from the ladder.  The reference
decides the rung itself: it factors its own Ky, rounded to the program's
precision, up the ladder (``reference.gp.first_rung``), and compares the
program at that rung or at one next to it (``gp.rungs_near``), the one
nearer the program's answer; rounding decides a factor at the edge either
way.  A program that takes a jitter the reference's factor does not need
is judged against the reference's rung, and fails.

The control puts the reference itself, in float32 with TF32 matmuls, in
the program's place (``source="control"``); on the card the TF32 switch is
on for its own computations only.
"""

from __future__ import annotations

import contextlib
import importlib
import math

import numpy as np
import torch

from reference import gp

from .data import generator

_HUGE = 1e29     # the program's guard replaces a non-finite value by 1e30


@contextlib.contextmanager
def _tf32(on: bool):
    """The card's TF32 matmuls on for the block (the control), off after."""
    if not on:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


class _Judge:
    def __init__(self, problems, config, device):
        self.problems = problems
        self.device = torch.device(device)
        self.model = importlib.import_module(
            "reference." + config["reference"])

    def low(self):
        """The control's precision for the block."""
        return _tf32(self.device.type == "cuda")

    def inputs(self, fit, prec=gp.FLOAT64):
        X, y = self.problems[fit.problem][:2]
        Xk, yk, std = gp.fit_inputs(X, y, fit.components)
        return (torch.as_tensor(Xk, dtype=prec.dtype, device=self.device),
                torch.as_tensor(yk, dtype=prec.dtype, device=self.device),
                std)

    def jitters(self, raw, X):
        """{rung: jitter} the reference allows a fit at parameters ``raw``
        in the precision the program recorded them in."""
        dtype = torch.float64 if all(
            np.asarray(v).dtype == np.float64 for v in raw.values()) \
            else torch.float32
        rung = gp.first_rung(self.model.factored(raw, X), dtype)
        md = self.model.mean_diag(raw)
        return {r: gp.rung_jitter(r, md, dtype) for r in gp.rungs_near(rung)}

    def value_grad(self, raw, X, y, jitter=0.0, prec=gp.FLOAT64,
                   climb=False):
        p = gp.as_params(raw, prec, self.device, grad=True)
        with torch.enable_grad():
            v, _ = self.model.objective(p, X, y, jitter, prec, climb)
            v.backward()
        return float(v.detach()), {k: t.grad.double().cpu().numpy()
                                   for k, t in p.items()}

    @torch.no_grad()
    def value(self, raw, X, y, jitter):
        p = gp.as_params(raw, gp.FLOAT64, self.device)
        try:
            return float(self.model.objective(p, X, y, jitter)[0])
        except torch.linalg.LinAlgError:
            return math.nan

    def weights(self, raw, X, y, jitter=0.0, prec=gp.FLOAT64, climb=False):
        """The posterior weights (float64 numpy), None where the factor
        fails."""
        p = gp.as_params(raw, prec, self.device)
        try:
            w = self.model.coef(p, X, y, jitter, prec, climb)
        except torch.linalg.LinAlgError:
            return None
        return w.double().cpu().numpy()

    def mean(self, raw, X, w):
        """The posterior mean at the rows X from the weights w (float64)."""
        p = gp.as_params(raw, gp.FLOAT64, self.device)
        w = torch.as_tensor(np.asarray(w), dtype=torch.float64,
                            device=self.device)
        return gp.mean(X, self.model.centres(p, X), w, p).cpu().numpy()

    def mean_grad(self, raw, X, w, std, prec=gp.FLOAT64):
        """(∂μ/∂x at the rows X, the row sums of the terms' magnitudes)."""
        p = gp.as_params(raw, prec, self.device)
        w = torch.as_tensor(np.asarray(w), dtype=prec.dtype,
                            device=self.device)
        G, T = gp.mean_grad(X, self.model.centres(p, X), w, p, prec,
                            terms=True)
        return ((G * std).double().cpu().numpy(),
                (T * std).double().cpu().numpy())


def _closest(values: dict, target) -> object:
    """The key of ``values`` whose value lies nearest ``target``."""
    return min(values, key=lambda k: abs(values[k] - target)
               if math.isfinite(values[k]) else math.inf)


def _max_gap(a: dict, b: dict) -> float:
    return max(float(np.max(np.abs(np.asarray(a[k], np.float64) - b[k])))
               for k in b)


def _norm(g: dict) -> float:
    return math.sqrt(sum(float(np.sum(np.square(v))) for v in g.values()))


def _restart_ends(fit):
    """(first iterate, gradients at the result) of the restart whose best
    point the fit kept: its result is one of the points it evaluated."""
    end = fit.end["params"]
    for restart, params, grads in fit.evaluated:
        if all(np.array_equal(params[k], v) for k, v in end.items()):
            return fit.starts.get(restart), grads
    return None, None


def judge(probe, problems, config, traffic, seed, device,
          source="program") -> dict:
    """{number: reading} of one window (see the module's docstring)."""
    control = source == "control"
    J = _Judge(problems, config, device)
    low = gp.TF32
    n = config["n_rows"]
    readings = {}

    def program_value(fit, raw):
        """The value the control gives in the program's place."""
        Xl, yl, _ = J.inputs(fit, low)
        with J.low():
            return J.value_grad(raw, Xl, yl, prec=low, climb=True)

    iterates = [it for it in probe.iterates if it["value"] < _HUGE]
    k = min(int(traffic["check"]["iterates"]), len(iterates))
    picks = sorted(generator(seed, 2).choice(len(iterates), size=k,
                                             replace=False))
    vgaps, ggaps = [], []
    for i in picks:
        it = iterates[i]
        fit = probe.fits[it["fit"]]
        X, y, _ = J.inputs(fit)
        v_p, g_p = (program_value(fit, it["params"]) if control
                    else (it["value"], it["grads"]))
        jitters = J.jitters(it["params"], X)
        values = {r: J.value(it["params"], X, y, j)
                  for r, j in jitters.items()}
        v_r, g_r = J.value_grad(it["params"], X, y,
                                jitters[_closest(values, v_p)])
        vgaps.append(abs(v_p - v_r) / n)
        ggaps.append(_max_gap(g_p, g_r) / n)
    if picks:
        readings["value"] = max(vgaps)
        readings["grad"] = max(ggaps)

    starts = [(fit, it) for fit in probe.fits for it in fit.starts.values()
              if it["value"] < _HUGE]
    k = min(int(traffic["check"]["starts"]), len(starts))
    sgaps = []
    for i in sorted(generator(seed, 4).choice(len(starts), size=k,
                                              replace=False)):
        fit, it = starts[i]
        X, y, _ = J.inputs(fit)
        v_p = (program_value(fit, it["params"])[0] if control
               else it["value"])
        values = {r: J.value(it["params"], X, y, j)
                  for r, j in J.jitters(it["params"], X).items()}
        sgaps.append(abs(v_p - values[_closest(values, v_p)]) / n)
    if sgaps:
        readings["start_value"] = max(sgaps)

    ended = [f for f in probe.fits if f.end is not None]
    ended = ended[:int(traffic["check"]["fits"])]
    mean, dmu, span, stationary = [], [], [], []
    for fit in ended:
        X, y, std = J.inputs(fit)
        raw = fit.end["params"]
        if control:
            Xl, yl, _ = J.inputs(fit, low)
            with J.low():
                w_p = J.weights(raw, Xl, yl, prec=low, climb=True)
                G_p = J.mean_grad(raw, Xl, w_p, std, low)[0]
        else:
            w_p, G_p = fit.end["weights"].astype(np.float64), fit.end["G"]
        ws = {r: J.weights(raw, X, y, j)
              for r, j in J.jitters(raw, X).items()}
        mu_p = J.mean(raw, X, w_p)
        gaps = {r: math.inf if w is None else
                float(np.max(np.abs(mu_p - J.mean(raw, X, w))))
                for r, w in ws.items()}
        r = min(gaps, key=gaps.get)
        w_r = ws[r]
        mean.append(gaps[r] / float(np.max(np.abs(J.mean(raw, X, w_r)))))
        G_w, T_w = J.mean_grad(raw, X, w_p, std)
        dmu.append(float(np.max(np.abs(G_p - G_w) / np.maximum(T_w, 1e-300))))
        nxt = (probe.fits[fit.index + 1]
               if fit.index + 1 < len(probe.fits) else None)
        if nxt is not None and nxt.problem == fit.problem:
            G_r = J.mean_grad(raw, X, w_r, std)[0]
            keep = nxt.components.shape[0]
            if control:
                _, _, Vh = np.linalg.svd(G_p, full_matrices=False)
                new = Vh[:keep] if fit.components is None \
                    else Vh[:keep] @ fit.components
            else:
                new = nxt.components
            span.append(gp.projector_gap(G_r, fit.components, new,
                                         int(config["n_components"])))
        start, end = (None, None) if control else _restart_ends(fit)
        if start is not None:
            stationary.append(_norm(end) / max(_norm(start["grads"]), 1e-300))
    for name, vals in (("mean", mean), ("dmu", dmu), ("span", span),
                       ("stationary", stationary)):
        if vals:
            readings[name] = max(vals)
    return readings

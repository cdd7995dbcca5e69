"""The comparison that decides ``correct`` in a window of a streamed SVGP
fit.

Once the window has closed, the plain float64 reference of the model
(``reference/<config["reference"]>.py``) recomputes, from what the window
recorded, what the program answered:

- ``elbo``: at each recorded step, the minibatch ELBO at the step's
  parameters, q(u) and batch, as a gap per training row: |ΔELBO| / N;
- ``grad``: there, the gradient of −ELBO in every raw parameter (kernel,
  noise, Z): max |Δgradient| / N, as the exact cell scales its ``grad``;
- ``adam``: there, each parameter's change in the step against the
  reference's Adam step (its own gradient, the configuration's lr and
  Adam's β₁, β₂, ε, from the optimizer's moments before the step), as
  ‖Δp − Δp_ref‖ / ‖Δp_ref‖ of the worst parameter: a step not taken, or a
  parameter the optimizer leaves out, reads 1.  Where two recorded steps
  follow one another, the second's parameters and moments must be the
  first's after it, over the same ‖Δp_ref‖ (the larger of the two);
- ``natgrad``: θ₁ and θ₂ after the step against the reference's
  natural-gradient update of the step's θ on the same batch at the
  parameters after the Adam step, each over its largest entry (the larger
  of the two); where two recorded steps follow one another, the second's
  θ must be the first's after it;
- ``mean``: the predictive mean (kernel K) at the held rows from the fit's
  final state, over the reference's largest (on the model's normalized
  scale);
- ``dmu``: dμ/dx* (kernel G) there, each entry's gap over the magnitude
  of the sums it is made of (``reference.gp.mean_grad``'s terms: they
  cancel by orders of magnitude);
- ``rmse``: the predictive mean against the noise-free target at the held
  rows.

A float32 factor of Kuu that fails takes a jitter from the program's
ladder.  The reference decides the rung itself from its own Kuu rounded
to the program's precision (``reference.gp.first_rung``) and compares the
program at that rung or one next to it, the one nearer the program's
answer.

The control puts the reference itself, in float32 with TF32 matmuls, in
the program's place (``source="control"``).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from reference import gp

from .fit_checks import _closest, _tf32


def _dtype(raw: dict) -> torch.dtype:
    return (torch.float64 if all(np.asarray(v).dtype == np.float64
                                 for v in raw.values()) else torch.float32)


class _Judge:
    def __init__(self, config, device):
        self.device = torch.device(device)
        self.ref = importlib.import_module("reference." + config["reference"])
        self.n = float(config["n_rows"])
        self.lr = float(config["lr"])
        self.adam_hyper = config["adam"]

    def low(self):
        """The control's precision for the block."""
        return _tf32(self.device.type == "cuda")

    def t(self, value, prec=gp.FLOAT64):
        return torch.as_tensor(np.asarray(value), dtype=prec.dtype,
                               device=self.device)

    def params(self, raw, prec=gp.FLOAT64, grad=False):
        return gp.as_params(raw, prec, self.device, grad)

    def theta(self, theta, prec=gp.FLOAT64):
        return tuple(self.t(v, prec) for v in theta)

    def jitters(self, raw) -> dict:
        """{rung: jitter} the reference allows a Kuu at parameters ``raw``
        in the precision the program recorded them in."""
        dtype = _dtype(raw)
        rung = gp.first_rung(self.ref.kuu(self.params(raw)), dtype)
        md = self.ref.mean_diag(raw)
        return {r: gp.rung_jitter(r, md, dtype) for r in gp.rungs_near(rung)}

    def elbo_grad(self, r, jitter=0.0, prec=gp.FLOAT64, climb=False):
        """(ELBO, {name: ∂(−ELBO)}) at a record's step inputs."""
        p = self.params(r["params"], prec, grad=True)
        with torch.enable_grad():
            value = self.ref.elbo(p, *self.theta(r["theta"], prec),
                                  self.t(r["X"], prec), self.t(r["y"], prec),
                                  r["n_total"], jitter, prec, climb)
            (-value).backward()
        return float(value.detach()), {k: v.grad.double().cpu().numpy()
                                       for k, v in p.items()}

    @torch.no_grad()
    def elbo(self, r, jitter):
        try:
            return float(self.ref.elbo(self.params(r["params"]),
                                       *self.theta(r["theta"]),
                                       self.t(r["X"]), self.t(r["y"]),
                                       r["n_total"], jitter))
        except torch.linalg.LinAlgError:
            return float("nan")

    def adam(self, r, grads, prec=gp.FLOAT64) -> dict:
        """{name: Δp} of the reference's Adam step from the record's
        moments before it, on the gradients ``grads`` (float64 numpy)."""
        a = self.adam_hyper
        moments = {}
        for name, g in grads.items():
            before = r["moments"][name]
            if before is None:
                zero = np.zeros_like(np.asarray(g, np.float64))
                before = (zero, zero, 0)
            moments[name] = (self.t(before[0], prec), self.t(before[1], prec),
                             int(round(float(np.asarray(before[2])))))
        out = self.ref.adam_step(
            {k: self.t(g, prec) for k, g in grads.items()}, moments,
            self.lr, a["betas"], a["eps"])
        return {k: v[0].double().cpu().numpy() for k, v in out.items()}

    def natural(self, r, jitter=0.0, prec=gp.FLOAT64, climb=False):
        """(θ₁, θ₂) of the reference's step from the record's θ at the
        parameters after its Adam step (float64 numpy)."""
        out = self.ref.natural_step(
            self.params(r["params_after"], prec), *self.theta(r["theta"], prec),
            self.t(r["X"], prec), self.t(r["y"], prec), r["n_total"],
            r["rho"], jitter, prec, climb)
        return tuple(v.double().cpu().numpy() for v in out)

    def predict_mean(self, fin, X, jitter=0.0, prec=gp.FLOAT64, climb=False):
        """μ at the rows X on the normalized scale (float64 numpy)."""
        mu, _ = self.ref.predict(self.params(fin["params"], prec),
                                 *self.theta(fin["theta"], prec), X, jitter,
                                 prec, climb, likelihood=False)
        return mu.double().cpu().numpy()

    def mean_grad(self, fin, X, jitter=0.0, prec=gp.FLOAT64, climb=False):
        """(dμ/dx at the rows X, the row sums of the terms' magnitudes) on
        the normalized scale, from the reference's own β."""
        p = self.params(fin["params"], prec)
        beta = self.ref.beta(p, *self.theta(fin["theta"], prec), jitter,
                             prec, climb)
        G, T = gp.mean_grad(X, p["Z"], beta, p, prec, terms=True)
        return G.double().cpu().numpy(), T.double().cpu().numpy()


def _norm(x) -> float:
    return float(np.linalg.norm(np.asarray(x, np.float64)))


def _update_gap(got: dict, want: dict) -> float:
    """The worst parameter's ‖got − want‖ / ‖want‖."""
    return max(_norm(np.asarray(got[k], np.float64) - want[k])
               / max(_norm(want[k]), 1e-300) for k in want)


def _chain_gap(r, nxt, want: dict) -> float:
    """How far the next recorded step's parameters and moments lie from
    those ``r`` left, over the worst ‖Δp_ref‖ (0 when they are the same)."""
    scale = max(max(_norm(v) for v in want.values()), 1e-300)
    gaps = [_norm(np.asarray(r["params_after"][k], np.float64)
                  - np.asarray(nxt["params"][k], np.float64))
            for k in want]
    for k in want:
        a, b = r["moments_after"][k], nxt["moments"][k]
        if (a is None) != (b is None):
            return float("inf")
        if a is not None:
            gaps += [_norm(np.asarray(x, np.float64) - np.asarray(y, np.float64))
                     for x, y in zip(a, b)]
    return max(gaps) / scale


def _theta_gap(got, want) -> float:
    return max(float(np.max(np.abs(np.asarray(g, np.float64) - w)))
               / max(float(np.max(np.abs(w))), 1e-300)
               for g, w in zip(got, want))


def judge(mix, source: str = "program") -> dict:
    """{number: reading} of one window (see the module's docstring)."""
    control = source == "control"
    J = _Judge(mix.config, mix.device)
    low = gp.TF32
    readings = {}
    elbo, grad, adam, natgrad = [], [], [], []
    records = mix.records
    for i, r in enumerate(records):
        nxt = (records[i + 1] if i + 1 < len(records)
               and records[i + 1]["step"] == r["step"] + 1 else None)
        if control:
            with J.low():
                v_p, g_p = J.elbo_grad(r, prec=low, climb=True)
        else:
            v_p, g_p = float(r["elbo"]), r["grads"]
        jitters = J.jitters(r["params"])
        values = {k: J.elbo(r, j) for k, j in jitters.items()}
        v_r, g_r = J.elbo_grad(r, jitters[_closest(values, v_p)])
        elbo.append(abs(v_p - v_r) / J.n)
        grad.append(max(float(np.max(np.abs(np.asarray(g_p[k], np.float64)
                                            - g_r[k]))) for k in g_r) / J.n)
        d_r = J.adam(r, g_r)
        if control:
            with J.low():
                d_p = J.adam(r, g_p, prec=low)
        else:
            d_p = {k: np.asarray(r["params_after"][k], np.float64)
                   - np.asarray(r["params"][k], np.float64) for k in d_r}
        gap = _update_gap(d_p, d_r)
        if nxt is not None:
            gap = max(gap, _chain_gap(r, nxt, d_r))
        adam.append(gap)
        if control:
            with J.low():
                th_p = J.natural(r, prec=low, climb=True)
        else:
            th_p = r["theta_after"]
        gaps = [_theta_gap(th_p, J.natural(r, j))
                for j in J.jitters(r["params_after"]).values()]
        gap = min(gaps)
        if nxt is not None:
            gap = max(gap, _theta_gap(nxt["theta"], [
                np.asarray(v, np.float64) for v in r["theta_after"]]))
        natgrad.append(gap)
    for name, vals in (("elbo", elbo), ("grad", grad), ("adam", adam),
                       ("natgrad", natgrad)):
        if vals:
            readings[name] = max(vals)

    fin = mix.final
    if fin is None:
        return readings
    X = J.t(mix.X_held)
    if control:
        with J.low():
            Xl = J.t(mix.X_held, low)
            mu_p = J.predict_mean(fin, Xl, prec=low, climb=True)
            G_p = J.mean_grad(fin, Xl, prec=low, climb=True)[0]
        mean_p = mu_p * fin["y_std"] + fin["y_mean"]
    else:
        mean_p = fin["mean"]
        mu_p = (mean_p - fin["y_mean"]) / fin["y_std"]
        G_p = fin["dmu"] / fin["y_std"]
    jitters = J.jitters(fin["params"])
    mus = {k: J.predict_mean(fin, X, j) for k, j in jitters.items()}
    k = min(mus, key=lambda k: float(np.max(np.abs(mu_p - mus[k]))))
    readings["mean"] = (float(np.max(np.abs(mu_p - mus[k])))
                        / max(float(np.max(np.abs(mus[k]))), 1e-300))
    G_r, T_r = J.mean_grad(fin, X, jitters[k])
    readings["dmu"] = float(np.max(np.abs(G_p - G_r)
                                   / np.maximum(T_r, 1e-300)))
    readings["rmse"] = J.ref.rmse(mean_p, mix.f_held)
    return readings

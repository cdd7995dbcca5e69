"""What the benchmark observes of a fit while its window is open.

:class:`Probe` wraps, for the length of a window, three calls of the system
under test, and restores them after:

- ``torch.optim.LBFGS.step``, the ML-II outer loop of
  ``edrgp_tpu_torch/inference/lbfgs.py``: it counts the iterations,
  counts the closure's calls (those that evaluate the objective apart from
  those answered from ``_guarded_closure``'s one-entry cache), records the
  iterate each step starts from with the value and gradient the program
  returned there, and ends the window at the first iteration boundary past
  its deadline by raising :class:`WindowClosed` through the fit;
- the configuration's objective (``ops.exact.nlml``), only to count its
  calls, and ``torch.linalg.cholesky_ex``, to count the factorizations
  the objective's evaluations make (the jitter ladder tries one a rung);
- the regressor's ``predict_gradient``, which the EDR calls once a fit has
  ended: it records the fit's final parameters, its posterior weights and
  the gradients it returned.

Each evaluation's parameters and the gradient the program returned there
are kept on the device (copies, queued without a wait) and brought to the
host once the window has closed (:meth:`Probe.to_host`): a fit's result
is the best point its restarts evaluated, which need not be one their
steps started from.

Nothing here changes what the program computes.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function


class WindowClosed(Exception):
    """The window's time is up (raised at an L-BFGS iteration boundary)."""


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _params_and_grads(model):
    """([(name, parameter)], [(name, its gradient, zeros where None)])."""
    named = list(model.named_parameters())
    return named, [(n, torch.zeros_like(p) if p.grad is None else p.grad)
                   for n, p in named]


@dataclass
class Fit:
    """One GP fit of an EDR: the problem, the projector it runs under
    (None: the first fit, on all columns) and what it left."""

    index: int
    problem: int
    q: int
    components: np.ndarray | None
    model: object = field(repr=False)
    restarts: int = 0
    evals: int = 0
    iterations: int = 0
    starts: dict = field(default_factory=dict)   # restart: first iterate
    evaluated: list = field(default_factory=list, repr=False)
    end: dict | None = None        # final parameters, weights, gradients
    optimizers: list = field(default_factory=list, repr=False)


class Probe:
    """Counters and records of one window (see the module's docstring)."""

    def __init__(self, config: dict):
        self.config = config
        self.spans = False             # profiler labels on the window's calls
        self.deadline: float | None = None
        self.iterations = 0
        self.evals = 0
        self.cached = 0
        self.factors = 0       # Cholesky factorizations inside evaluations
        self.fits: list[Fit] = []
        self.iterates: list[dict] = []     # one per iteration: its start
        self.marks: list[tuple[int, int]] = []   # (time_ns, q) at fit starts
        self.edr = None
        self.problem = -1
        self._objective_calls = 0
        self._in_eval = False
        self._by_model: dict[int, Fit] = {}

    # ------------------------------------------------------------ context
    def begin_problem(self, edr, index: int) -> None:
        self.edr, self.problem = edr, index

    def _current_fit(self) -> Fit:
        model = self.edr.estimator_.estimator_
        fit = self._by_model.get(id(model))
        if fit is None or fit.model is not model:
            comps = self.edr.components_
            q = (self.config["n_features"] if comps is None
                 else int(np.asarray(comps).shape[0]))
            fit = Fit(index=len(self.fits), problem=self.problem, q=q,
                      components=None if comps is None
                      else np.array(comps, dtype=np.float64), model=model)
            self.fits.append(fit)
            self._by_model[id(model)] = fit
            self.marks.append((time.time_ns(), q))
        return fit

    def _span(self, name: str):
        return record_function(name) if self.spans else contextlib.nullcontext()

    def _record(self, fit: Fit, value) -> dict:
        model = fit.model
        rec = {"fit": fit.index, "restart": fit.restarts,
               "value": float(value),
               "params": {n: _host(p) for n, p in model.named_parameters()},
               "grads": {n: (np.zeros(tuple(p.shape), np.float32)
                             if p.grad is None else _host(p.grad))
                         for n, p in model.named_parameters()}}
        fit.starts.setdefault(fit.restarts, rec)
        return rec

    # ------------------------------------------------------------ wrappers
    def _step(self, orig):
        probe = self

        def step(opt, closure):
            fit = probe._current_fit()
            # one optimizer a restart; held, so that no later one reuses its id
            if not any(o is opt for o in fit.optimizers):
                fit.optimizers.append(opt)
                fit.restarts += 1
            first = True

            def counted():
                nonlocal first
                before = probe._objective_calls
                probe._in_eval = True
                try:
                    with probe._span("gpbench.evaluation"):
                        out = closure()
                finally:
                    probe._in_eval = False
                if probe._objective_calls > before:
                    probe.evals += 1
                    fit.evals += 1
                    fit.evaluated.append((fit.restarts, *(
                        {n: t.detach().clone() for n, t in pairs}
                        for pairs in _params_and_grads(fit.model))))
                else:
                    probe.cached += 1
                if first:
                    first = False
                    probe.iterates.append(probe._record(fit, out))
                return out

            with probe._span("gpbench.iteration"):
                out = orig(opt, counted)
            probe.iterations += 1
            fit.iterations += 1
            if (probe.deadline is not None
                    and time.perf_counter() >= probe.deadline):
                raise WindowClosed
            return out

        step.hooked = True      # Optimizer.__init__ must not wrap it again
        return step

    def _objective(self, orig):
        probe = self

        def objective(*args, **kwargs):
            probe._objective_calls += 1
            return orig(*args, **kwargs)

        return objective

    def _factor(self, orig):
        probe = self

        def cholesky_ex(*args, **kwargs):
            if probe._in_eval:
                probe.factors += 1
            return orig(*args, **kwargs)

        return cholesky_ex

    def _predict_gradient(self, orig):
        probe = self

        def predict_gradient(reg, X):
            with probe._span("gpbench.gradients"):
                G = orig(reg, X)
            model = reg.estimator_
            fit = probe._by_model.get(id(model))
            if fit is not None and fit.model is model:
                weights = model._gradient_basis()[2]
                fit.end = {"params": {n: _host(p) for n, p in
                                      model.named_parameters()},
                           "weights": _host(weights),
                           "G": np.array(G, dtype=np.float64)}
            return G

        return predict_gradient

    def to_host(self) -> None:
        """Each fit's evaluations, brought to the host: (restart, params,
        grads) as numpy."""
        for fit in self.fits:
            fit.evaluated = [(r, {n: _host(t) for n, t in params.items()},
                              {n: _host(t) for n, t in grads.items()})
                             for r, params, grads in fit.evaluated]

    @contextlib.contextmanager
    def installed(self, regressor_cls):
        """The wrappers in place for the block; the originals after it."""
        module_name, attr = self.config["objective"].rsplit(".", 1)
        module = importlib.import_module(module_name)
        lbfgs = torch.optim.LBFGS
        saved = [(lbfgs, "step", lbfgs.__dict__["step"]),
                 (module, attr, getattr(module, attr)),
                 (regressor_cls, "predict_gradient",
                  regressor_cls.__dict__.get("predict_gradient")),
                 (torch.linalg, "cholesky_ex", torch.linalg.cholesky_ex)]
        lbfgs.step = self._step(lbfgs.__dict__["step"])
        setattr(module, attr, self._objective(getattr(module, attr)))
        regressor_cls.predict_gradient = self._predict_gradient(
            regressor_cls.predict_gradient)
        torch.linalg.cholesky_ex = self._factor(torch.linalg.cholesky_ex)
        try:
            yield self
        finally:
            for owner, name, value in saved:
                if value is None:
                    delattr(owner, name)
                else:
                    setattr(owner, name, value)

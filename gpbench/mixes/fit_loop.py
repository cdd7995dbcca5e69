"""The generator of fit traffic (``"generator": "fit_loop"`` in a traffic
file): a closed loop with one caller that runs
``EffectiveDimensionalityReduction.fit`` back to back, each fit on the
next problem of a pool, with the regressor of the configuration and the
options of the traffic file.

Every seed fits the same pool of problems, drawn from the traffic's own
pool seed, in another order drawn from the run's seed, and round the pool
again once it is done: the same work, in another order.  A problem's fit
is a fixed function of its data (the restarts' perturbations come from a
fixed seed), while any change of its rounding, even a permutation of its
rows, moves the float32 optimizer's path and with it the number of
evaluations and of jitter-ladder factorizations; a seed that drew new
data or a new row order would change the work, not only its order
(PERF.md §2).

Set-up: the pool's problems, the card, the kernels' library (built at
the first launch into the checkout's ``build/``) and one short fit on a
problem of the same shapes, which runs every shape, kernel and host path
the window runs (each of the EDR's fits, at each width, with restarts).
The window: fits back to back until the first L-BFGS iteration boundary
past ``seconds``.
"""

from __future__ import annotations

import time

from harness import fit_checks
from harness.data import edr_problem, generator
from harness.probe import Probe, WindowClosed

#: Stream ids of the generators: the pool's problems (from the traffic's
#: pool seed) and the run's order of them (from the run's seed).
WARMUP, PROBLEMS, ORDER = 0, 1, 3


class Mix:
    """One run's traffic: ``setup``, the ``window``, its end-to-end values,
    and the comparison of what it computed (``judge``), as the harness
    (``harness/cell.py``) asks of every generator."""

    #: Numbers without which a window compared nothing that matters.
    required = ("grad",)

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.problems: dict = {}        # by EDR fit of the run
        self._pool: dict = {}           # by problem of the pool
        self.probe = Probe(config)

    def _draw(self, stream: int, *index: int):
        c, p = self.config, self.traffic["problem"]
        return edr_problem(generator(int(p["pool_seed"]), stream, *index),
                           c["n_rows"], c["n_features"], c["effective_dim"],
                           p["noise_sigma"], p["tau"])

    def problem(self, index: int):
        """(X, y, B) of the index-th EDR fit of the run: the pool's
        problems in the seed's order, round and round."""
        size = int(self.traffic["problem"]["pool_size"])
        k = int(generator(self.seed, ORDER).permutation(size)[index % size])
        if k not in self._pool:
            self._pool[k] = self._draw(PROBLEMS, k)
        self.problems[index] = self._pool[k]
        return self.problems[index]

    def regressor_cls(self):
        from edrgp_tpu_torch import models
        return getattr(models, self.config["regressor"])

    def make_edr(self):
        import edrgp_tpu_torch as program
        reg = self.regressor_cls()(**self.config["regressor_options"],
                                   device=self.device)
        dr = getattr(program, self.traffic["dr_transformer"])()
        return program.EffectiveDimensionalityReduction(
            reg, dr, n_components=self.config["n_components"])

    def setup(self) -> None:
        for i in range(int(self.traffic["problem"]["pool_size"])):
            self.problem(i)
        X, y, _ = self._draw(WARMUP)
        self.make_edr().fit(X, y, **self.traffic["warmup_fit_options"])
        self._sync()

    def _sync(self):
        import torch
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float, spans: bool = False, on_start=None):
        """Run fits until the first iteration boundary past ``seconds``;
        returns (t0, t1) on ``time.perf_counter``.  ``on_start`` is called
        just before the clock starts; with ``spans`` the probe marks
        iterations, evaluations and gradients for the profiler."""
        fit_options = self.traffic["fit_options"]
        probe = self.probe
        probe.spans = spans
        with probe.installed(self.regressor_cls()):
            if on_start is not None:
                on_start()
            t0 = time.perf_counter()
            probe.deadline = t0 + seconds
            index = 0
            try:
                while True:
                    X, y, _ = self.problem(index)
                    edr = self.make_edr()
                    probe.begin_problem(edr, index)
                    edr.fit(X, y, **fit_options)
                    index += 1
            except WindowClosed:
                pass
            self._sync()
            t1 = time.perf_counter()
        return t0, t1

    @property
    def attempted(self) -> int:
        return self.probe.iterations

    def end_to_end(self, window_s: float) -> dict:
        """The window's end-to-end values by metric name."""
        p = self.probe
        return {"fit_ms_per_iter": (1e3 * window_s / p.iterations
                                    if p.iterations else None)}

    def summary(self) -> dict:
        p = self.probe
        return {"iterations": p.iterations, "evaluations": p.evals,
                "cached": p.cached, "factorizations": p.factors,
                "fits_started": len(p.fits),
                "fits_ended": sum(f.end is not None for f in p.fits)}

    def release(self) -> None:
        """Drop the program's state (models, optimizers), keeping what the
        comparison reads."""
        self.probe.to_host()
        for fit in self.probe.fits:
            fit.model, fit.optimizers = None, []
        self.probe.edr = None

    def judge(self, source: str = "program") -> dict:
        return fit_checks.judge(self.probe, self.problems, self.config,
                                self.traffic, self.seed, self.device, source)

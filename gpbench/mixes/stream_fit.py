"""The generator of streamed SVGP fit traffic (``"generator": "stream_fit"``
in a traffic file): one caller, closed loop, one fit a window through the
entry points a user of the large-N path calls:
``SVGPModel.from_dataset(MMapDataset(path), RBF(Q, ARD=True), ...)``, then
``optimize_stream(ds.batches(B, seed=<stream seed>), n_total=N, ...)``,
then ``predict`` and ``predictive_gradients`` at held rows.

The data is fixed by the configuration (its recipe and data seed): the
file is written once into the checkout's ``build/gpbench/data/``, keyed by
a hash of what defines it, and reused while its header and size match.
The run's seed draws the loader's stream seed, so every seed fits the same
data through another stream of minibatches.  The native loader must serve
the stream: a NumPy stream fails the run.

Set-up: the data file, the held rows, and a fit of ``warmup_steps`` steps
(two chunks) on another stream, with ``predict`` and
``predictive_gradients``, which runs every shape and path of the window.
The window: a fresh model, one fit that runs until the first chunk
boundary past ``seconds`` (the batch iterator raises :class:`WindowClosed`
when asked for the first batch of a chunk after the deadline), however
many steps that holds: on one H100 more than the source's 3,000.  At the
traffic's fixed step indices the mix records, as device copies queued
without a wait, the step's inputs (parameters, θ₁, θ₂, batch, ρ, Adam's
moments), the ELBO it returned, each parameter's gradient, and the
parameters, θ and moments after it, by wrapping ``SVGPModel._step`` for
the window.  ``attempted`` is the steps the program's own counter
(``models.svgp.STEPS``) counted in the window.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import time

import numpy as np
import torch

from harness import stream_checks
from harness.data import generator
from harness.probe import WindowClosed

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA_DIR = os.path.join(ROOT, "build", "gpbench", "data")

#: Stream ids: the warm-up's and the window's stream seeds (of the run's
#: seed), the held rows (of the data seed).
WARMUP, STREAM, HELD = 0, 1, 2

#: The window's fit asks for more steps than any window holds: the
#: deadline ends it.
UNTIL_DEADLINE = 1 << 62

def target(X: np.ndarray) -> np.ndarray:
    """f = sin x₀·cos x₁ + 0.5·tanh x₂ (BASELINE config 5's recipe)."""
    return np.sin(X[:, 0]) * np.cos(X[:, 1]) + 0.5 * np.tanh(X[:, 2])


def draw(config: dict):
    """(X, y) of the configuration, float32, drawn as the source draws
    them: X uniform on [−3, 3]^Q, then the noise of y."""
    d = config["data"]
    rng = np.random.default_rng(int(d["seed"]))
    n, q = int(config["n_rows"]), int(config["n_features"])
    X = rng.uniform(-3, 3, size=(n, q)).astype(np.float32)
    y = (target(X) + d["noise_sigma"] * rng.normal(size=n)).astype(np.float32)
    return X, y


def data_path(config: dict) -> str:
    """The file of the configuration's data, named by a hash of what
    defines it."""
    key = json.dumps({k: config[k] for k in ("n_rows", "n_features", "data")},
                     sort_keys=True)
    digest = hashlib.sha1(key.encode()).hexdigest()[:12]
    return os.path.join(DATA_DIR, f"{config['name']}-{digest}.edrg")


def _file_matches(path: str, n: int, row_floats: int) -> bool:
    """Whether ``path`` holds a whole dataset of ``n`` rows of
    ``row_floats`` floats: the program's reader checks the header and maps
    every row it declares (a short file fails the mapping)."""
    from edrgp_tpu_torch.data import MMapDataset
    if not os.path.exists(path):
        return False
    try:
        ds = MMapDataset(path, force_numpy=True)
    except (OSError, ValueError):
        return False
    ds.close()
    return (ds.n_rows, ds.row_floats) == (n, row_floats)


def ensure_data(config: dict) -> tuple[str, float]:
    """(path, seconds spent writing it: 0 where the file was there)."""
    from edrgp_tpu_torch.data import write_dataset
    path = data_path(config)
    n, q = int(config["n_rows"]), int(config["n_features"])
    if _file_matches(path, n, q + 1):
        return path, 0.0
    t = time.perf_counter()
    os.makedirs(DATA_DIR, exist_ok=True)
    X, y = draw(config)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write_dataset(tmp, X, y)
        # on the disk before the window, so no write-back runs inside it
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, path)        # a reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, time.perf_counter() - t


class Counts:
    """What the window's readers read: the program's counters' deltas."""

    def __init__(self, steps: int = 0, factors: int = 0):
        self.steps, self.factors = steps, factors


class Recorder:
    """Device copies of what chosen steps took and gave (no waits).  A step
    the program takes again (a chunk retaken after a failed factor) is
    known by its ρ, which falls with every step of a fit: its records, and
    those after it, are taken anew."""

    def __init__(self, at):
        self.at = set(int(i) for i in at)
        self.index = 0
        self.seen: dict = {}
        self.records: list[dict] = []

    def _wrap(self, orig):
        rec = self

        def step(model, opt, Xb, yb, n_total, rho):
            i = rec.seen.setdefault(float(rho), rec.index)
            if i < rec.index:
                rec.records = [r for r in rec.records if r["step"] < i]
            rec.index = i + 1
            if i not in rec.at:
                return orig(model, opt, Xb, yb, n_total, rho)
            r = {"step": i, "rho": float(rho), "n_total": int(n_total),
                 "X": Xb.detach().clone(), "y": yb.detach().clone(),
                 "params": _params(model),
                 "theta": tuple(t.clone() for t in model.qstate),
                 "moments": _moments(model, opt)}
            elbo = orig(model, opt, Xb, yb, n_total, rho)
            r.update(elbo=elbo.detach().clone(),
                     grads={n: (torch.zeros_like(p) if p.grad is None
                                else p.grad.detach().clone())
                            for n, p in model.named_parameters()},
                     params_after=_params(model),
                     theta_after=tuple(t.clone() for t in model.qstate),
                     moments_after=_moments(model, opt))
            rec.records.append(r)
            return elbo

        return step

    @contextlib.contextmanager
    def installed(self, model_cls):
        orig = model_cls.__dict__["_step"]
        model_cls._step = self._wrap(orig)
        try:
            yield self
        finally:
            model_cls._step = orig


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _moments(model, opt) -> dict:
    """{name: (exp_avg, exp_avg_sq, step)} of the optimizer's state of each
    parameter; None where it holds none (before its first step, or a
    parameter it does not update)."""
    out = {}
    for n, p in model.named_parameters():
        st = opt.state.get(p)
        out[n] = (None if not st else
                  tuple(torch.as_tensor(st[k]).detach().clone()
                        for k in ("exp_avg", "exp_avg_sq", "step")))
    return out


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy().copy()
    if isinstance(value, dict):
        return {k: _host(v) for k, v in value.items()}
    if isinstance(value, tuple):
        return tuple(_host(v) for v in value)
    return value


class Mix:
    """One run's traffic: ``setup``, the ``window``, its end-to-end values,
    and the comparison of what it computed (``judge``), as the harness
    (``harness/cell.py``) asks of every generator."""

    #: Numbers without which a window compared nothing that matters.
    required = ("elbo", "grad")

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        # the program's step and factorization counters, which the window
        # reads: a program without them cannot run the cell, and fails here
        from edrgp_tpu_torch.models.svgp import STEPS  # noqa: F401
        from edrgp_tpu_torch.ops.linalg import FACTORS  # noqa: F401
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.probe = Counts()
        self.records: list[dict] = []
        self.final: dict | None = None
        self.ds = self.model = None
        self.stream_seed = int(generator(seed, STREAM).integers(1 << 63))
        self.data_write_s = None

    # ------------------------------------------------------------ the fit
    def _open(self):
        from edrgp_tpu_torch.data import MMapDataset
        ds = MMapDataset(self.path)
        if ds._handle is None:
            ds.close()
            raise RuntimeError("the native loader does not serve the stream")
        return ds

    def _model(self, ds):
        from edrgp_tpu_torch.models.svgp import SVGPModel
        from edrgp_tpu_torch.ops.kernels import RBF
        c = self.config
        return SVGPModel.from_dataset(
            ds, RBF(int(c["n_features"]), ARD=True),
            num_inducing=int(c["num_inducing"]), seed=0, device=self.device)

    def _batches(self, ds, seed: int):
        s = self.traffic["stream"]
        return ds.batches(int(self.config["batch_size"]), seed=seed,
                          with_replacement=bool(s["with_replacement"]),
                          n_buffers=int(s["n_buffers"]))

    def _fit(self, model, batches, steps: int):
        model.optimize_stream(batches, n_total=int(self.config["n_rows"]),
                              steps=steps, lr=float(self.config["lr"]),
                              scan_chunk=int(self.traffic["stream"]
                                             ["scan_chunk"]))

    def _until(self, batches, deadline: float):
        """The batches, ended by :class:`WindowClosed` at the first chunk
        boundary past ``deadline``."""
        chunk = int(self.traffic["stream"]["scan_chunk"])
        for i, batch in enumerate(batches):
            if i % chunk == 0 and time.perf_counter() >= deadline:
                raise WindowClosed
            yield batch

    def _sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------ the run
    def setup(self) -> None:
        self.path, self.data_write_s = ensure_data(self.config)
        self.ds = self._open()
        n = int(self.config["n_rows"])
        held = np.sort(generator(int(self.config["data"]["seed"]), HELD)
                       .choice(n, int(self.config["held_rows"]),
                               replace=False))
        self.X_held = self.ds.read_rows(held)[0]
        self.f_held = target(self.X_held.astype(np.float64))
        warm = self._open()
        try:
            model = self._model(warm)
            batches = self._batches(
                warm, int(generator(self.seed, WARMUP).integers(1 << 63)))
            self._fit(model, batches, int(self.traffic["warmup_steps"]))
            model.predict(self.X_held)
            model.predictive_gradients(self.X_held)
            self._sync()
        finally:
            warm.close()

    def window(self, seconds: float, spans: bool = False, on_start=None):
        """One fit from a fresh model until the first chunk boundary past
        ``seconds``; returns (t0, t1) on ``time.perf_counter``.  The
        program labels its spans itself (``svgp.step``, ``svgp.loader``,
        ``svgp.feed``, ``svgp.capture``), so ``spans`` adds nothing."""
        from edrgp_tpu_torch.models import svgp as program
        from edrgp_tpu_torch.ops import linalg
        self.model = self._model(self.ds)
        recorder = Recorder(self.traffic["check"]["steps"])
        batches = self._batches(self.ds, self.stream_seed)
        with recorder.installed(program.SVGPModel):
            steps0 = program.STEPS["taken"]
            factors0 = sum(linalg.FACTORS.values())
            if on_start is not None:
                on_start()
            t0 = time.perf_counter()
            try:
                self._fit(self.model, self._until(batches, t0 + seconds),
                          UNTIL_DEADLINE)
            except WindowClosed:
                pass
            self._sync()
            t1 = time.perf_counter()
        batches.close()
        self.probe = Counts(steps=program.STEPS["taken"] - steps0,
                            factors=sum(linalg.FACTORS.values()) - factors0)
        self.records = recorder.records
        return t0, t1

    @property
    def attempted(self) -> int:
        return self.probe.steps

    def end_to_end(self, window_s: float) -> dict:
        """The window's end-to-end values by metric name."""
        steps = self.probe.steps
        return {"fit_ms_per_iter": 1e3 * window_s / steps if steps else None}

    def summary(self) -> dict:
        return {"steps": self.probe.steps,
                "factorizations": self.probe.factors,
                "recorded_steps": [r["step"] for r in self.records],
                "stream_seed": self.stream_seed,
                "data_write_s": self.data_write_s}

    def release(self) -> None:
        """The fitted model's answers at the held rows (``predict``: kernel
        K; ``predictive_gradients``: kernel G), then the program's state
        goes, keeping what the comparison reads."""
        model = self.model
        mean, var = model.predict(self.X_held)
        dmu = model.predictive_gradients(self.X_held)[0][:, :, 0]
        self.final = {"params": _host(_params(model)),
                      "theta": _host(tuple(model.qstate)),
                      "mean": np.asarray(mean[:, 0], np.float64),
                      "var": np.asarray(var[:, 0], np.float64),
                      "dmu": np.asarray(dmu, np.float64),
                      "y_mean": float(model.normalizer.mean),
                      "y_std": float(model.normalizer.std)}
        self.records = [_host(r) for r in self.records]
        self.model = None
        self.ds.close()
        self.ds = None

    def judge(self, source: str = "program") -> dict:
        return stream_checks.judge(self, source)

"""The ``svgp_stream`` cell at a CPU cut (N = 20,000, M = 32, B = 256; the
program then runs in float64, its CPU type): a run of ``run_cell`` is
correct, planted faults fail their numbers, the control fails, and the
cell's files are found by name.

``rmse`` is left out of the verdict at the cut: its limit is set from the
full-size fit's readings (M = 512 over thousands of steps of 8,192 rows);
a 2 s CPU window at M = 32 runs a few hundred steps and reads 0.1–0.5.
"""

import importlib
import os
import time

import numpy as np
import pytest
import torch

from harness import checks
from harness.cell import run_cell
from harness.manifest import Manifest
from harness.probe import WindowClosed

from small import ROOT

CUT = {"n_rows": 20000, "num_inducing": 32, "batch_size": 256}
REQUIRED = ("elbo", "grad")


def _cut():
    m = Manifest(ROOT)
    cell = m.cell("svgp_stream")
    limits = {k: v for k, v in m.limits(cell).items() if k != "rmse"}
    return m, cell, dict(m.config(cell), **CUT), limits


def _run(seconds=2.0, sources=("program",)):
    m, cell, config, limits = _cut()
    out = run_cell(m, cell, 20261019, seconds, False, device="cpu",
                   config=config, sources=sources)
    return out, limits


def _plant(monkeypatch, fault):
    from edrgp_tpu_torch.models.svgp import SVGPModel
    from edrgp_tpu_torch.ops import svgp
    if fault == "wrong_scale":
        orig = svgp.svgp_elbo

        def half(gp, m, S, Xb, yb, n_total):
            return orig(gp, m, S, Xb, yb, n_total // 2)

        monkeypatch.setattr(svgp, "svgp_elbo", half)
    elif fault == "natgrad_skipped":
        monkeypatch.setattr(svgp, "natural_gradient_update",
                            lambda gp, state, *args: state)
    elif fault == "adam_skipped":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif fault == "z_left_out":
        def parameters(self, recurse=True):
            return (p for n, p in self.named_parameters() if n != "Z")

        monkeypatch.setattr(SVGPModel, "parameters", parameters)
    elif fault == "frozen_z":
        orig = SVGPModel.optimize_stream

        def frozen(self, *args, **kwargs):
            self.Z.requires_grad_(False)
            return orig(self, *args, **kwargs)

        monkeypatch.setattr(SVGPModel, "optimize_stream", frozen)


def test_sound_run_is_correct():
    out, limits = _run()
    correct, failed, compared = checks.verdict(out["readings"]["program"],
                                               limits, REQUIRED)
    assert correct and failed == 0, compared
    assert set(compared) == set(limits)
    assert out["attempted"] > 16 and out["metrics"]["fit_ms_per_iter"]
    assert out["window"]["recorded_steps"][:5] == [0, 1, 15, 16, 17]
    assert np.isfinite(out["readings"]["program"]["rmse"])


@pytest.mark.parametrize("fault,number", [
    ("wrong_scale", "elbo"),
    ("natgrad_skipped", "natgrad"),
    ("frozen_z", "grad"),
    ("adam_skipped", "adam"),
    ("z_left_out", "adam"),
])
def test_fault_fails_its_number(monkeypatch, fault, number):
    _plant(monkeypatch, fault)
    out, limits = _run()
    correct, failed, compared = checks.verdict(out["readings"]["program"],
                                               limits, REQUIRED)
    assert not correct and failed >= 1
    assert compared[number]["reading"] > compared[number]["limit"], compared


def test_control_fails_at_a_cpu_size():
    """The reference in float32 with TF32 matmuls (emulated by rounding
    each product's operands) in the program's place."""
    out, limits = _run(sources=("program", "control"))
    control_ok, failed, compared = checks.verdict(
        out["readings"]["control"], limits, REQUIRED)
    assert not control_ok and failed >= 2, compared


def test_cell_files_found_by_name():
    m = Manifest(ROOT)
    cell = m.cell("svgp_stream")
    assert cell["chips"] == 1
    config = m.config(cell)
    assert config["name"] == cell["config"] == "svgp_rbfard_n10m_m512_q8"
    assert (config["n_rows"], config["n_features"], config["num_inducing"],
            config["batch_size"], config["steps"]) == (10_000_000, 8, 512,
                                                       8192, 3000)
    traffic = m.traffic(cell)
    assert traffic["name"] == cell["traffic"] == "stream_fit"
    assert len(traffic["check"]["steps"]) == 12
    mix = m.mix(traffic)
    assert all(callable(getattr(mix, f)) for f in (
        "setup", "window", "end_to_end", "summary", "release", "judge"))
    assert set(mix.required) == set(REQUIRED)
    reference = importlib.import_module("reference." + config["reference"])
    assert all(callable(getattr(reference, f)) for f in (
        "elbo", "natural_step", "adam_step", "predict", "beta", "kuu",
        "mean_diag"))
    limits = m.limits(cell)
    assert set(limits) == {"elbo", "grad", "adam", "natgrad", "mean", "dmu",
                           "rmse"}
    assert all(v > 0 for v in limits.values())
    assert config["adam"] == {"betas": [0.9, 0.999], "eps": 1e-8}
    assert m.flops(config)(config) == pytest.approx(3.0088e10, rel=1e-4)
    per_layer = {p["name"] for p in m.per_layer(cell)}
    assert per_layer == {
        "stream_mfu_pct", "launches_per_step.stream",
        "host_syncs_per_step.stream", "factors_per_step.stream",
        "feed_ms_per_step.stream", "idle_pct.stream", "linalg_pct.stream"}
    for p in m.per_layer(cell):
        assert p["workloads"] == ["svgp_stream"]
        assert p["moves"] == "fit_ms_per_iter"
        assert callable(m.reader(p))
    assert {e["name"] for e in m.end_to_end(cell)} == {"fit_ms_per_iter",
                                                       "setup_s"}


def test_traced_run_reads_the_programs_counters_and_spans():
    m, cell, config, _ = _cut()
    out = run_cell(m, cell, 5, 1.0, True, device="cpu", config=config)
    metrics = out["metrics"]
    steps = out["attempted"]
    assert metrics["factors_per_step.stream"]["value"] >= 5.0
    assert out["window"]["factorizations"] == round(
        metrics["factors_per_step.stream"]["value"] * steps)
    assert metrics["feed_ms_per_step.stream"]["value"] > 0
    assert metrics["stream_mfu_pct"]["value"] > 0
    # no device on the CPU: no launches, host reads, idle or library share
    assert not {"launches_per_step.stream", "host_syncs_per_step.stream",
                "idle_pct.stream", "linalg_pct.stream"} & set(metrics)


def test_data_file_is_written_once_and_checked():
    m, cell, config, _ = _cut()
    mix_module = importlib.import_module("harness.manifest").load_module(
        "mixes", "stream_fit.py")
    config = dict(config, n_rows=1000)
    path = mix_module.data_path(config)
    if os.path.exists(path):
        os.unlink(path)
    assert mix_module.ensure_data(config)[1] > 0
    assert mix_module.ensure_data(config) == (path, 0.0)
    from edrgp_tpu_torch.data import MMapDataset
    ds = MMapDataset(path)
    X, y = ds.read_rows(np.arange(1000))
    ds.close()
    X0, y0 = mix_module.draw(config)
    assert np.array_equal(X, X0) and np.array_equal(y, y0)
    with open(path, "r+b") as f:         # a short file is written again
        f.truncate(os.path.getsize(path) - 4)
    assert mix_module.ensure_data(config)[1] > 0
    os.unlink(path)


def test_batches_end_at_a_chunk_boundary_past_the_deadline():
    m, cell, config, _ = _cut()
    mix = m.mix(m.traffic(cell))(config, m.traffic(cell), 1, "cpu")
    taken = []
    batches = mix._until(iter(range(100)), time.perf_counter() + 0.05)
    with pytest.raises(WindowClosed):
        for b in batches:
            taken.append(b)
            if b == 20:
                time.sleep(0.1)
    assert len(taken) == 32           # the rest of the chunk, not one more


def _record(step, params, moments, theta):
    return {"step": step, "params": params, "moments": moments,
            "theta": theta}


def test_chain_of_recorded_steps_is_checked():
    """A recorded step that follows another must start from the parameters,
    Adam moments and θ the other left: 0 where they are the same, and a
    gap where the state was put back in between."""
    from harness import stream_checks
    p0, p1 = {"Z": np.zeros(3)}, {"Z": np.full(3, 0.01)}
    mom = {"Z": (np.ones(3), np.ones(3), np.array(1.0))}
    want = {"Z": np.full(3, 0.01)}
    r = dict(_record(0, p0, None, None), params_after=p1, moments_after=mom)
    assert stream_checks._chain_gap(r, _record(1, p1, mom, None), want) == 0
    assert stream_checks._chain_gap(
        r, _record(1, p0, mom, None), want) == pytest.approx(1.0)
    reset = {"Z": (np.zeros(3), np.zeros(3), np.array(0.0))}
    assert stream_checks._chain_gap(r, _record(1, p1, reset, None),
                                    want) > 1.0
    assert stream_checks._chain_gap(r, _record(1, p1, {"Z": None}, None),
                                    want) == float("inf")


def test_recorder_takes_a_retaken_step_anew():
    """A chunk the program takes again (same ρ as before) replaces the
    records of its steps and of those after them."""
    m, cell, config, _ = _cut()
    mix_module = importlib.import_module("harness.manifest").load_module(
        "mixes", "stream_fit.py")
    rec = mix_module.Recorder([1, 3])

    class Model:
        qstate = (torch.zeros(1),)

        def named_parameters(self):
            return iter(())

    calls = []
    step = rec._wrap(lambda model, opt, Xb, yb, n, rho: (
        calls.append(rho), torch.tensor(float(len(calls))))[1])
    rhos = [1.0, 0.9, 0.8, 0.7, 0.8, 0.7, 0.6]      # the last chunk twice
    for rho in rhos:
        step(Model(), type("Opt", (), {"state": {}})(), torch.zeros(1),
             torch.zeros(1), 1, rho)
    assert [(r["step"], r["rho"]) for r in rec.records] == [(1, 0.9),
                                                            (3, 0.7)]
    assert float(rec.records[-1]["elbo"]) == 6.0
    assert rec.index == 5 and calls == rhos

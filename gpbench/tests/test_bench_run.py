"""The entry's contract that a CPU machine can check: no card, no run; the
result line's keys; no JAX in the harness's process, none of the program
in the reference's."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from harness.cell import run_cell

from small import ROOT, small

GPBENCH = os.path.join(ROOT, "gpbench")


def _entry(args, cwd):
    return subprocess.run([sys.executable, "gpbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=""))


ARGS = ["--workload", "exact_edr", "--seed", "3", "--seconds", "1",
        "--trace", "0"]


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _entry(ARGS, ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(GPBENCH, tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _entry(ARGS, tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    sys.path.insert(0, GPBENCH)
    import run
    m, cell, config = small("exact_edr")
    out = run_cell(m, cell, 11, 1.5, trace, device="cpu", config=config,
                   limits=m.limits(cell))
    line = json.loads(json.dumps(run.result_line(out)))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert isinstance(line["correct"], bool) and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"fit_ms_per_iter"}
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"}
    for check in line["checks"].values():
        assert set(check) == {"reading", "limit"}


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, GPBENCH)
    import run
    assert "edrgp_tpu" not in run.forbidden_modules()
    sys.modules["jax.fake_for_test"] = sys.modules["json"]
    try:
        assert "jax" in run.forbidden_modules()
    finally:
        del sys.modules["jax.fake_for_test"]


_HARNESS = r"""
import json, sys
sys.path[:0] = [{root!r}, {gpbench!r}, {tests!r}]
import torch
torch.set_num_threads(1)
from harness.cell import run_cell
from small import small
import run
m, cell, config = small("exact_edr")
run_cell(m, cell, 5, 1.0, True, device="cpu", config=config,
         limits=m.limits(cell))
print(json.dumps(sorted({{n.split(".", 1)[0] for n in sys.modules}})))
"""

_REFERENCE = r"""
import json, sys
sys.path[:0] = [{gpbench!r}]
import numpy as np, torch
from reference import exact_gp, gp
from harness.data import edr_problem, generator
X, y, _ = edr_problem(generator(1, 1, 0), 60, 3, 3, 0.1)
Xk, yk, std = gp.fit_inputs(X, y, None)
raw = {{"kernel.variance": np.array(0.5), "kernel.lengthscale": np.ones(3),
        "raw_noise": np.array(-1.0)}}
p = gp.as_params(raw, gp.FLOAT64, "cpu")
X_t, y_t = torch.as_tensor(Xk), torch.as_tensor(yk)
exact_gp.objective(p, X_t, y_t)
gp.first_rung(exact_gp.factored(raw, X_t), torch.float32)
gp.mean_grad(X_t, X_t, exact_gp.coef(p, X_t, y_t), p)
print(json.dumps(sorted({{n.split(".", 1)[0] for n in sys.modules}})))
"""


def _modules(code):
    out = subprocess.run(
        [sys.executable, "-c", code.format(
            root=ROOT, gpbench=GPBENCH,
            tests=os.path.join(GPBENCH, "tests"))],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    tops = _modules(_HARNESS)
    assert "edrgp_tpu_torch" in tops        # the system under test
    assert not tops & {"jax", "jaxlib", "flax", "edrgp_tpu"}


def test_reference_loads_neither_jax_nor_the_program():
    tops = _modules(_REFERENCE)
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "edrgp_tpu",
                       "edrgp_tpu_torch"}
